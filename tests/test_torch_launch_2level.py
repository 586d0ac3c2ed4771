"""The port's 2-level (hosts x devices) mesh and ring (``launch``,
``ring.ring_forces_2level``, ``mesh.make_mesh_2d``) on 4 gloo ranks (one
spawn runs every case) against the JAX package's ``sharded_simulate_2level``
on the same mesh shape of the 8-device CPU mesh, on the same numpy inputs
(positions to 1e-5 absolute); the exact rung's masked ring block; and the
multi-rank checks of ``parallel.dryrun``: ``dryrun_multichip`` on 2 and 4
CPU ranks, and ``slab_parity`` (the slab path on 4 ranks against one) on a
small slab configuration.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from particle3d_tpu import reference_config
from particle3d_tpu.parallel import launch as JL
from particle3d_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from particle3d_tpu.state import from_numpy as jax_from_numpy

import torch

from particle3d_tpu_torch.config import SimConfig
from particle3d_tpu_torch.config import reference_config as torch_reference
from particle3d_tpu_torch.ops import forces as F
from particle3d_tpu_torch.ops.allpairs import allpairs_forces
from particle3d_tpu_torch.parallel import launch as TL
from particle3d_tpu_torch.parallel import ring as TR
from particle3d_tpu_torch.parallel.dryrun import dryrun_multichip
from particle3d_tpu_torch.state import from_numpy

from _torch_ranks import run_ranks
from _torch_scaleout_cases import DT, two_level_main

N, STEPS = 320, 3
SHAPES = [(2, 2), (4, 1), (1, 4)]
# a SLAB_RUNS-style configuration at 2,000 particles (grid 8 over 4 ranks)
SLAB = (2000, SimConfig(world_size=16.0, neighbor="celllist_pallas",
                        cell_grid=8, cell_capacity=32).validate(), 1 / 60,
        dict(nsc=8, cap=32, mcap=512, migcap=256, ocap=0), 6)


def _scene(n=N, seed=12):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, sp


@pytest.fixture(scope="module")
def ranks4():
    return run_ranks(two_level_main, 4, *_scene(), STEPS, SHAPES, SLAB)


def test_mesh_shape_2level():
    assert TL.mesh_shape_2level(8, 2) == JL.mesh_shape_2level(8, 2) == (2, 4)
    assert TL.mesh_shape_2level(4, 4) == (4, 1)
    assert TL.mesh_shape_2level(4, 1) == (1, 4)
    for bad in ((6, 4), (4, 0), (0, 1)):
        with pytest.raises(ValueError):
            TL.mesh_shape_2level(*bad)


def test_auto_mesh_2d_from_environment(ranks4):
    """One process: WORLD_SIZE 1 gives the 1 x 1 mesh with no group; a
    host count that does not divide raises. Four ranks: one row a host."""
    one = TL.auto_mesh_2d(device="cpu", environ={})
    assert one.shape == (1, 1) and one.rank == 0 and one.ici.group is None
    with pytest.raises(ValueError, match="whole number of hosts"):
        TL.auto_mesh_2d(device="cpu", environ={"WORLD_SIZE": "6",
                                               "LOCAL_WORLD_SIZE": "4"})
    for r in range(4):
        assert ranks4[r]["auto"] == [(2, 2), (1, 4), (4, 1)]
        assert ranks4[r]["auto_ici"] == (2, 2)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_simulate_2level_matches_jax(ranks4, shape):
    pos, vel, sp = _scene()
    mesh = jax_make_mesh_2d(*shape)
    cfg = reference_config(world_size=16.0)
    st = JL.shard_state_2level(jax_from_numpy(pos, vel, sp), mesh)
    want = np.asarray(JL.sharded_simulate_2level(st, cfg, jnp.float32(DT),
                                                 STEPS, mesh).positions)
    # global rank r holds block r, dcn-major
    assert sorted(ranks4[r][shape][0] for r in range(4)) == [0, 1, 2, 3]
    for r in range(4):
        np.testing.assert_allclose(ranks4[r][shape][1], want, rtol=0,
                                   atol=1e-5)


def test_indivisible_n_raises(ranks4):
    for r in range(4):
        assert "divide" in ranks4[r]["indivisible"]


def test_subgroup_ring_uses_global_peers(ranks4):
    """A 2-member ring on the subgroups {0, 2} and {1, 3}: each member's
    peer both ways is the other member's global rank."""
    for r in range(4):
        other = (r + 2) % 4
        assert ranks4[r]["subgroup"] == (10.0 * other, 100.0 * other,
                                         [r % 2, r % 2 + 2])


@pytest.mark.parametrize("law", ["particle_life", "lennard_jones"])
def test_masked_ring_block_matches_plain_all_pairs(law):
    """The exact rung's ring block on the card is K3 with the masked
    sources gated off (r2 = -1); its plain version on CPU tensors equals
    the plain all-pairs sweep with ``src_valid``."""
    pos, vel, sp = _scene(600, 3)
    cfg = torch_reference(world_size=16.0)
    if law == "lennard_jones":
        cfg = cfg.replace(force_law="lennard_jones", particle_effect_radius=1.5,
                          lj_sigma=0.3, lj_epsilon=0.5)
    st = from_numpy(pos, vel, sp, device="cpu")
    u, v = F.pair_features(st, cfg)
    ok = torch.tensor(np.random.default_rng(4).random(600) < 0.7)
    src = st.positions.flip(0)  # another block than the receivers
    got = TR._rect_forces(st.positions, u, src, v, ok, cfg)
    want = allpairs_forces(st.positions, u, None, cfg, src_positions=src,
                           src_v=v, src_valid=ok)
    scale = want.abs().max()
    assert torch.linalg.vector_norm(got - want) \
        <= 1e-5 * torch.linalg.vector_norm(want)
    assert (got - want).abs().max() <= 1e-4 * scale
    # on CPU tensors the rung itself takes the plain all-pairs sweep
    one = TR.ring_forces_masked(st.positions, u, v, ok, cfg,
                                TR.Mesh(1, 0, torch.device("cpu")))
    assert torch.equal(one, allpairs_forces(
        st.positions, u, None, cfg, src_positions=st.positions, src_v=v,
        src_valid=ok))


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(n_ranks):
    log = dryrun_multichip(n_ranks, device="cpu")
    assert len(log) == 8 and all(": ok" in line for line in log)
    assert log[0].startswith(f"[dryrun] ring path, {n_ranks} ranks")
    assert log[1].startswith(f"[dryrun] 2-level ring, 2 x {n_ranks // 2} mesh")


def test_slab_parity_four_ranks_against_one(ranks4):
    rec = ranks4[0]["slab_parity"]
    assert all(ranks4[r]["slab_parity"] is None for r in (1, 2, 3))
    assert rec["ranks"] == 4 and rec["n"] == 2000
    assert rec["diag"][1:4] == rec["diag_one_rank"][1:4] == [0, 0, 0]
    assert rec["diag"][4] > 0  # rows crossed slabs
    assert rec["max_dpos_over_world"] <= 1e-5
