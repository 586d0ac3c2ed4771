"""The port's geometry tuner (``utils/tune.py``) and its ``tune`` command:
candidates equal to the JAX package's list without Mosaic's alignment
rule (``require_aligned=False``; K1 takes any capacity), ranked timings at
the JAX test's shape on the CPU, and a failing candidate that raises
instead of being skipped."""

import json

import pytest

import jax
import torch

from particle3d_tpu import SimConfig as JaxConfig
from particle3d_tpu import init_scene as jax_init
from particle3d_tpu import reference_config as jax_reference
from particle3d_tpu.utils.tune import candidate_geometries as jax_candidates

import particle3d_tpu_torch as P
from particle3d_tpu_torch import __main__ as cli
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.utils.tune import (candidate_geometries,
                                             effective_cutoff, tune)

_LJ = dict(force_law="lennard_jones", lj_epsilon=0.2, lj_sigma=0.15,
           particle_effect_radius=0.5, world_size=32.0)

# (JAX config, N, max_candidates): particle life at 262k (world 40) and at
# the test shapes, a radius below the 1.0 cap, lj_gas's 0.5 cutoff, gravity
CASES = {
    "particle_life_262k": (dict(world_size=40.0), 262144, 8),
    "particle_life_4k": (dict(world_size=16.0), 4096, 8),
    "particle_life_262k_24": (dict(world_size=40.0), 262144, 24),
    "radius_0.8": (dict(world_size=20.0, particle_effect_radius=0.8), 50000, 8),
    "lj_gas": (_LJ, 262144, 8),
    "gravity": (dict(force_law="gravity", world_size=30.0,
                     particle_effect_radius=3.0), 65536, 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_equal_jax_unaligned(case):
    kw, n, mx = CASES[case]
    jcfg = JaxConfig(**kw).validate()
    cfg = from_jax_config(jcfg)
    want = jax_candidates(jcfg, n, max_candidates=mx, require_aligned=False)
    got = candidate_geometries(cfg, n, max_candidates=mx)
    assert got == want and got
    assert effective_cutoff(cfg) == pytest.approx(
        min(kw.get("particle_effect_radius", 2.0), 1.0)
        if cfg.force_law == "particle_life"
        else kw["particle_effect_radius"])


def test_tune_runs_and_ranks():
    jcfg = jax_reference(world_size=16.0)
    st = P.from_jax_state(jax_init(jax.random.PRNGKey(0), 1024, jcfg),
                          device="cpu")
    cfg = from_jax_config(jcfg)
    cands = candidate_geometries(cfg, 1024)[:2]
    results = tune(st, cfg, 1 / 60, steps=2, candidates=cands, verbose=None)
    assert len(results) == 2
    key = [(r.capacity_masked > 0, r.ms_per_step) for r in results]
    assert key == sorted(key)
    assert {(r.nsc, r.cap) for r in results} == set(cands)
    for r in results:
        assert r.steps_per_s > 0 and r.capacity_masked == 0


def test_failing_candidate_raises():
    """nsc = 2 has no column sweep (K1 needs nsc >= 3): the JAX tuner
    prints and skips a candidate that fails, the port raises."""
    cfg = P.reference_config(world_size=16.0)
    st = P.init_scene(torch.Generator().manual_seed(0), 256, cfg, "cpu")
    with pytest.raises(ValueError, match="nsc >= 3"):
        tune(st, cfg, 1 / 60, steps=1, candidates=[(4, 16), (2, 64)],
             verbose=None)


def test_tune_command_prints_jax_keys(capsys):
    rec = cli.main(["tune", "--preset", "reference", "--n", "512",
                    "--steps", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"preset", "n", "best", "results"} == set(rec)
    assert line["n"] == 512 and line["best"] == line["results"][0]
    assert set(line["best"]) == {"nsc", "cap", "ms_per_step", "steps_per_s",
                                 "max_movers", "capacity_masked"}
