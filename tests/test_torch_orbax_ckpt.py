"""The port's step-indexed checkpointer (``utils/orbax_ckpt.py``): round
trip, resume, async saves, latest of each kind, refusals, ``meta.json``
against the JAX package's ``OrbaxCheckpointer`` on the same state and
config, and a stay-sharded slab carry saved and restored rank by rank on
1 and 2 gloo ranks. Every comparison is exact (bit-identical tensors,
equal JSON)."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

pytest.importorskip("orbax.checkpoint")

from particle3d_tpu import reference_config as jax_reference
from particle3d_tpu import init_scene as jax_init
from particle3d_tpu.utils.orbax_ckpt import OrbaxCheckpointer as JaxCkpt

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.parallel import make_mesh
from particle3d_tpu_torch.parallel.dryrun import carry_resume
from particle3d_tpu_torch.utils.orbax_ckpt import OrbaxCheckpointer

from _torch_ranks import run_ranks

DT = 1.0 / 60.0
# tests/test_orbax_ckpt.py's slab carry: N=512, world 16, grid 8, cap 32
SLAB_N = 512
SLAB_KW = dict(nsc=8, cap=32, mcap=256, migcap=256, ocap=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The slab and ring steps here are long chains of small ops: one
    intra-op thread runs them faster than several and leaves the cores to
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _scene(n=128):
    jcfg = jax_reference()
    jst = jax_init(jax.random.PRNGKey(0), n, jcfg)
    return P.from_jax_state(jst, device="cpu"), from_jax_config(jcfg), jst, jcfg


def _equal_states(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("positions", "velocities", "species", "masses",
                         "accel"))


def _fake_carry(fill=0.0):
    return (torch.full((8, 4), fill), torch.full((8,), -1, dtype=torch.int32),
            torch.zeros((2, 4)), torch.full((2,), -1, dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32))


class _StandInMesh:
    """Rank ``rank`` of a mesh of ``size`` ranks, all in this process: every
    stand-in rank saves the same rows, so a sum over the mesh is ``size``
    times this rank's share."""

    device = torch.device("cpu")

    def __init__(self, size, rank):
        self.size, self.rank = size, rank

    def psum(self, x):
        return x * self.size


def _rank_files(ck_dir, step):
    return sorted(os.listdir(os.path.join(ck_dir, f"{step:010d}", "state")))


def test_round_trip(tmp_path):
    st, cfg, _, _ = _scene()
    st = st.replace(velocities=torch.randn(st.n, 3,
                                           generator=torch.Generator().manual_seed(1)))
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(30, st, cfg, extra={"note": "x"})
    out, cfg2, step = ck.restore(device="cpu")
    assert step == 30 and _equal_states(out, st)
    np.testing.assert_array_equal(np.asarray(cfg2.attraction_matrix),
                                  np.asarray(cfg.attraction_matrix))
    assert float(cfg2.world_size) == float(cfg.world_size)
    ck.close()


def test_resume_continues_trajectory(tmp_path):
    st, cfg, _, _ = _scene()
    mid = P.simulate(st, cfg, DT, 5)
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(5, mid, cfg)
    got, cfg2, _ = ck.restore(5, device="cpu")
    assert _equal_states(P.simulate(mid, cfg, DT, 5),
                         P.simulate(got, cfg2, DT, 5))
    ck.close()


def test_async_save_copies_before_returning(tmp_path):
    st, cfg, _, _ = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"), async_save=True)
    pos = st.positions.clone()
    ck.save(10, st.replace(positions=pos), cfg)
    pos.add_(1.0)  # a write after save returns must not reach the file
    ck.save(20, st, cfg)
    ck.wait()
    assert ck.steps() == [10, 20]
    got10, _, _ = ck.restore(10, device="cpu")
    assert torch.equal(got10.positions, st.positions)
    _, _, step = ck.restore(device="cpu")
    assert step == 20
    ck.close()


def test_latest_of_each_kind(tmp_path):
    st, cfg, _, _ = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    one = make_mesh(1, device="cpu")
    ck.save(10, st, cfg)
    ck.save_carry(20, _fake_carry(), cfg, nsc=4, cap=2, n=8)
    assert ck.restore(device="cpu")[2] == 10  # newest overall is the carry
    assert ck.restore_carry(one)[3] == 20
    ck.save(30, st, cfg)  # now the newest overall is a snapshot
    assert ck.restore_carry(one)[3] == 20
    ck.close()
    ck2 = OrbaxCheckpointer(str(tmp_path / "only_state"))
    ck2.save(1, st, cfg)
    with pytest.raises(FileNotFoundError, match="slab carr"):
        ck2.restore_carry(one)
    ck2.close()


def test_refuses_wrong_kind_and_version(tmp_path):
    st, cfg, _, _ = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    one = make_mesh(1, device="cpu")
    ck.save(1, st, cfg)
    ck.save_carry(2, _fake_carry(), cfg, nsc=4, cap=2, n=8)
    with pytest.raises(ValueError, match="slab carry"):
        ck.restore(2, device="cpu")
    with pytest.raises(ValueError, match="state snapshot"):
        ck.restore_carry(one, 1)
    meta = tmp_path / "ck" / f"{1:010d}" / "meta.json"
    d = json.loads(meta.read_text())
    d["format_version"] = 99
    meta.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="version"):
        ck.restore(1, device="cpu")
    meta = tmp_path / "ck" / f"{2:010d}" / "meta.json"
    d = json.loads(meta.read_text())
    del d["ranks"]
    meta.write_text(json.dumps(d))
    with pytest.raises(ValueError, match="no rank count"):
        ck.restore_carry(one, 2)
    ck.close()


def test_meta_matches_jax_checkpointer(tmp_path):
    """Same keys, config, slab geometry and shapes as the JAX module's
    meta.json for the same state, config and (fake) carry. The config is
    built by each package's reference_config (from_jax_config would round
    the numeric fields to float32, which JSON then writes differently)."""
    st, _, jst, jcfg = _scene()
    cfg = P.reference_config()
    jck = JaxCkpt(str(tmp_path / "jax"))
    jck.save(7, jst, jcfg, extra={"a": 1})
    jck.save_carry(9, (jnp.zeros((8, 4)), jnp.full((8,), -1, jnp.int32),
                       jnp.zeros((2, 4)), jnp.full((2,), -1, jnp.int32),
                       jnp.int32(0)), jcfg, nsc=4, cap=2, n=8)
    jck.close()
    ck = OrbaxCheckpointer(str(tmp_path / "torch"))
    ck.save(7, st, cfg, extra={"a": 1})
    ck.save_carry(9, _fake_carry(), cfg, nsc=4, cap=2, n=8)
    ck.close()
    for step in (7, 9):
        name = os.path.join(f"{step:010d}", "meta.json")
        want = json.loads((tmp_path / "jax" / name).read_text())
        got = json.loads((tmp_path / "torch" / name).read_text())
        assert got.pop("ranks") == 1  # the port's one key more
        assert got == want


def test_fewer_ranks_resave_a_step(tmp_path):
    """A step saved by 2 ranks, then saved again by 1: the second save
    leaves only its own file and restores on 1 rank."""
    cfg = P.reference_config()
    d = str(tmp_path / "ck")
    ck = OrbaxCheckpointer(d)
    for rank in (0, 1):
        ck.save_carry(4, _fake_carry(), cfg, nsc=4, cap=2, n=16,
                      mesh=_StandInMesh(2, rank))
    assert _rank_files(d, 4) == ["rank_00000.pt", "rank_00001.pt"]
    with pytest.raises(ValueError, match="written by 2 rank"):
        ck.restore_carry(make_mesh(1, device="cpu"))
    again = _fake_carry(fill=1.0)
    ck.save_carry(4, again, cfg, nsc=4, cap=2, n=8)
    assert _rank_files(d, 4) == ["rank_00000.pt"]
    carry, _, slab, step = ck.restore_carry(make_mesh(1, device="cpu"))
    assert step == 4 and slab == {"nsc": 4, "cap": 2, "n": 8}
    assert all(torch.equal(a, b) for a, b in zip(carry, again))
    ck.close()


def test_snapshot_over_a_carry_step(tmp_path):
    """A state snapshot saved over a step that 2 ranks saved as a carry
    leaves only rank 0's file, and restores."""
    st, cfg, _, _ = _scene()
    d = str(tmp_path / "ck")
    ck = OrbaxCheckpointer(d)
    for rank in (0, 1):
        ck.save_carry(5, _fake_carry(), cfg, nsc=4, cap=2, n=16,
                      mesh=_StandInMesh(2, rank))
    ck.save(5, st, cfg)
    assert _rank_files(d, 5) == ["rank_00000.pt"]
    out, _, step = ck.restore(device="cpu")
    assert step == 5 and _equal_states(out, st)
    with pytest.raises(ValueError, match="state snapshot"):
        ck.restore_carry(make_mesh(1, device="cpu"), 5)
    ck.close()


def test_slab_carry_one_rank(tmp_path):
    cfg = P.reference_config(world_size=16.0)
    rec = carry_resume(make_mesh(1, device="cpu"), SLAB_N, cfg, 1.0 / 30.0,
                       SLAB_KW, 4, str(tmp_path / "ck"), seed=3)
    assert rec["identical_to_continuation"]
    assert rec["identical_to_uninterrupted"]


def test_slab_carry_two_ranks(tmp_path):
    """Saved on 2 gloo ranks, each writing its own rows; restored rank by
    rank, continued bit-identically; a 1-rank restore of it raises."""
    cfg = P.reference_config(world_size=16.0)
    d = str(tmp_path / "ck")
    recs = run_ranks(carry_resume, 2, SLAB_N, cfg, 1.0 / 30.0, SLAB_KW, 4, d,
                     3, True)
    assert [r["rank"] for r in recs] == [0, 1]
    assert all(r["identical_to_continuation"] for r in recs)
    assert all(r["identical_to_uninterrupted"] for r in recs)
    assert sorted(os.listdir(os.path.join(d, f"{4:010d}", "state"))) == [
        "rank_00000.pt", "rank_00001.pt"]
    with pytest.raises(ValueError, match="written by 2 rank"):
        OrbaxCheckpointer(d).restore_carry(make_mesh(1, device="cpu"))
