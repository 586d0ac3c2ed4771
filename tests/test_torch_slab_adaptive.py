"""The port's adaptive slab driver (``sharded_dense_adaptive``) and its
in-place recap (``recap_sharded_dense``) on 2 and 4 gloo ranks (one spawn
a mesh size runs every case), against the JAX package's driver on a 2- and
4-device CPU mesh (``tests/conftest.py`` provides 8), on the same numpy
inputs.

The three scenarios are JAX's own (``tests/test_domain_sharded.py``): the
ladder escalating from cap 4, the exact terminal rung on a blob denser
than every capacity (JAX runs it at 8 devices; here at 2 and 4), and the
rung re-entering the slab path once the blob disperses. Both ladders
double from cap 4 to 8, so the histories must be equal; positions agree to
1e-5 absolute. The replicated rung runs the culled sweep in the port and
all-pairs in JAX: there positions are held to JAX's own test tolerance
(rtol 1e-4, atol 1e-5). ``"warn"`` and ``"raise"`` and the recap alone
are checked on the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d_tpu import init_scene as jax_init_scene
from particle3d_tpu import reference_config
from particle3d_tpu.parallel import domain_sharded as JDS
from particle3d_tpu.parallel import make_mesh as jax_make_mesh
from particle3d_tpu.state import from_numpy as jax_from_numpy

from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.ops.celllist_sweep import bin_sid

import torch

from _torch_ranks import run_ranks
from _torch_scaleout_cases import DT, adaptive_main


def _scene(n, seed, **repl):
    """JAX's ``_scene``: a uniform scene of JAX's ``init_scene``."""
    kw = dict(neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    kw.update(repl)
    cfg = reference_config(world_size=16.0).replace(**kw)
    st = jax_init_scene(jax.random.PRNGKey(seed), n, cfg)
    return (np.asarray(st.positions), np.asarray(st.velocities),
            np.asarray(st.species)), cfg


def _blob_scene(n=768, crowd=60, seed=11, speed=0.0, **repl):
    """JAX's ``_blob_scene``: ``crowd`` particles packed into one cell,
    optionally flying apart at ``speed``."""
    (pos, vel, sp), cfg = _scene(n, seed, **repl)
    rng = np.random.default_rng(123)
    pos, vel = pos.copy(), vel.copy()
    dirs = rng.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    if speed:
        vel[:crowd] = dirs * speed
    return (pos, vel, sp), cfg


def _reentry():
    scene, cfg = _blob_scene(n=288, crowd=24, cell_capacity=8, speed=8.0)
    return scene, cfg.replace(attraction_matrix=np.zeros((5, 5), np.float32))


# name: (scene and config, steps, driver keywords)
CASES = {
    "escalate": (_scene(1200, 5, cell_capacity=4), 10,
                 dict(window=5, ocap=0)),
    "terminal": (_blob_scene(cell_capacity=4), 12,
                 dict(window=4, max_cap=8, ocap=0)),
    "reentry": (_reentry(), 24, dict(window=4, max_cap=8, ocap=0)),
}
# port-only cases and the replicated rung, on 2 ranks
EXTRA = {
    "replicated": (CASES["terminal"][0], 12,
                   dict(window=4, max_cap=8, ocap=0,
                        on_ladder_end="exact_replicated")),
    "warn": (CASES["terminal"][0], 8,
             dict(window=4, max_cap=8, ocap=0, on_ladder_end="warn")),
    "raise": (CASES["terminal"][0], 8,
              dict(window=4, max_cap=8, ocap=0, on_ladder_end="raise")),
}


def _rank_cases(cases):
    return {name: (*scene, from_jax_config(cfg), steps,
                   dict(kw, with_state=True))
            for name, ((scene, cfg), steps, kw) in cases.items()}


@pytest.fixture(scope="module")
def ranks():
    (pos, _, sp), cfg = CASES["escalate"][0]
    recap = (pos, sp, from_jax_config(cfg))
    return {2: run_ranks(adaptive_main, 2, _rank_cases({**CASES, **EXTRA}),
                         recap),
            4: run_ranks(adaptive_main, 4, _rank_cases(CASES))}


def _jax_adaptive(name, d):
    ((pos, vel, sp), cfg), steps, kw = {**CASES, **EXTRA}[name]
    st = jax_from_numpy(pos, vel, sp)
    mesh = jax_make_mesh(d)
    carry = JDS.build_sharded_dense(st, cfg, mesh)
    carry, cap, hist = JDS.sharded_dense_adaptive(
        carry, cfg, jnp.float32(DT), steps, mesh, n=st.n, state=st, **kw)
    out = JDS.gather_sharded_dense(carry, st, mesh)
    return np.asarray(out.positions), cap, hist


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name", ["escalate", "terminal", "reentry"])
def test_adaptive_matches_jax(ranks, name, d):
    want, jcap, jhist = _jax_adaptive(name, d)
    steps = CASES[name][1]
    for r in range(d):
        pos, cap, hist, live, lost, _ = ranks[d][r][name]
        assert hist == jhist and cap == jcap
        assert all(t == 0 for _, _, t in hist)  # every window committed exact
        assert sum(k for k, _, _ in hist) == steps
        assert live == 1200 if name == "escalate" else live > 0
        assert lost == 0
        np.testing.assert_allclose(pos, want, rtol=0, atol=1e-5)
    hist = ranks[d][0][name][2]
    if name == "escalate":
        assert ranks[d][0][name][1] > 4  # the ladder climbed
    if name == "terminal":
        assert any(c == "exact" for _, c, _ in hist)
    if name == "reentry":
        assert hist[0][1] == "exact"  # started on the rung
        assert any(c != "exact" for _, c, _ in hist)  # and came back


def test_replicated_rung_matches_jax(ranks):
    want, jcap, jhist = _jax_adaptive("replicated", 2)
    for r in range(2):
        pos, cap, hist, live, lost, _ = ranks[2][r]["replicated"]
        assert hist == jhist and cap == jcap
        assert any(c == "exact" for _, c, _ in hist)
        assert all(t == 0 for _, _, t in hist) and lost == 0
        np.testing.assert_allclose(pos, want, rtol=1e-4, atol=1e-5)


def test_warn_commits_and_raise_raises(ranks):
    for r in range(2):
        pos, cap, hist, live, lost, caught = ranks[2][r]["warn"]
        assert cap == 8 and all(c != "exact" for _, c, _ in hist)
        assert any(t > 0 for _, _, t in hist)  # committed with unserved rows
        assert sum(k for k, _, _ in hist) == 8
        assert lost == 0 and live == 768
        assert any("committing the window" in w for w in caught)
        assert np.isfinite(pos).all()
        kind, msg = ranks[2][r]["raise"]
        assert kind == "raised" and "ladder ended at cap=8" in msg


def test_recap_keeps_occupants_and_drains_limbo(ranks):
    """cap 4 -> 8 with the limbo grown to 1024 rows: every occupant keeps its
    slot (cell c's slot s moves from c*4+s to c*8+s), the in-slab limbo
    rows move into their cells, no row is lost, and shrinking raises."""
    cfg = from_jax_config(CASES["escalate"][0][1])
    drained = 0
    for r in range(2):
        ((data0, pid0, ld0, lp0), (data1, pid1, ld1, lp1)), shrink = \
            ranks[2][r]["recap"]
        assert "recap only grows" in shrink
        k_loc = pid0.shape[0] // 4
        assert pid1.shape[0] == 8 * k_loc and lp1.shape[0] == 1024
        old = pid1.reshape(k_loc, 8)[:, :4]
        np.testing.assert_array_equal(old, pid0.reshape(k_loc, 4))
        np.testing.assert_array_equal(
            data1.reshape(k_loc, 8, -1)[:, :4], data0.reshape(k_loc, 4, -1))
        before = set(pid0[pid0 >= 0]) | set(lp0[lp0 >= 0])
        after = set(pid1[pid1 >= 0]) | set(lp1[lp1 >= 0])
        assert before == after
        # limbo rows of this slab now sit in a slot of their own cell; a
        # row stays in limbo only when its cell is full at cap 8
        cell = bin_sid(torch.tensor(data1[:, :3]), cfg, 8).numpy()
        live = pid1 >= 0
        assert (cell[live] == r * k_loc + np.arange(pid1.size)[live] // 8).all()
        tgt = bin_sid(torch.tensor(ld1[:, :3]), cfg, 8).numpy() - r * k_loc
        left = (lp1 >= 0) & (tgt >= 0) & (tgt < k_loc)
        full = live.reshape(k_loc, 8).all(1)
        assert full[tgt[left]].all()
        drained += int((lp0 >= 0).sum() - (lp1 >= 0).sum())
    assert drained > 0
