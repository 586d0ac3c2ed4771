"""The port's slab decomposition and ring on 2 and 4 gloo ranks, one
spawned process each, against the JAX package on a 2- and 4-device CPU
mesh (``tests/conftest.py`` provides 8), on the same numpy inputs.

Every spawn runs under ``_torch_ranks.run_ranks``: a finite
``init_process_group`` timeout and a deadline after which live ranks are
killed and the test fails, so a fault never hangs the suite. All scenarios
of one mesh size run in one spawn (a module fixture); the tests compare
its results. The scenes and each rank's program are in
``_torch_slab_cases.py``, which imports no JAX. Tolerances as in ``test_torch_slab.py``: positions 1e-5
absolute, velocities 2e-5, integer diagnostics exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from particle3d_tpu import reference_config
from particle3d_tpu import simulate as jax_simulate
from particle3d_tpu.state import from_numpy as jax_from_numpy
from particle3d_tpu.parallel import make_mesh as jax_make_mesh
from particle3d_tpu.parallel import domain_sharded as JDS
from particle3d_tpu.parallel.ring import shard_state as jax_shard_state
from particle3d_tpu.parallel.ring import sharded_simulate as jax_ring_simulate

from _torch_ranks import run_ranks
from _torch_slab_cases import (DT, EXACT_CASE, RING_CASE, SLAB_CASES, W,
                               cfg_kw, rank_main, scene)


@pytest.fixture(scope="module")
def ranks2():
    return run_ranks(rank_main, 2, 2)


@pytest.fixture(scope="module")
def ranks4():
    return run_ranks(rank_main, 4, 4)


def _ranks(request, d):
    return request.getfixturevalue(f"ranks{d}")


def _jax_slab(d, case):
    name, (pos, vel, sp), kw, steps, extra = case
    cfg = reference_config(world_size=W).replace(**kw)
    return JDS.sharded_dense_simulate(jax_from_numpy(pos, vel, sp), cfg,
                                      jnp.float32(DT), steps,
                                      jax_make_mesh(d), **extra)


@pytest.mark.parametrize("d,name", [(2, "overflow"), (2, "leapfrog"),
                                    (4, "overflow"), (4, "walled"),
                                    (4, "multihop")])
def test_slab_ranks_match_jax_mesh(request, d, name):
    res = _ranks(request, d)
    case = next(c for c in SLAB_CASES[d] if c[0] == name)
    jout, jdiag = _jax_slab(d, case)
    for r in range(d):  # every rank gathers the same full state
        pos, vel, diag = res[r][name]
        assert diag == [int(x) for x in jdiag]
        np.testing.assert_allclose(pos, np.asarray(jout.positions), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(vel, np.asarray(jout.velocities), rtol=0,
                                   atol=2e-5)
    mov, mask, limbo, lost, shipped = res[0][name][2]
    assert lost == 0 and shipped > 0
    if name == "multihop":
        assert shipped >= 2
    if name != "multihop":
        assert mask == 0 and limbo == 0


def test_ring_two_ranks_matches_jax(ranks2):
    (pos, vel, sp), steps = RING_CASE
    jmesh = jax_make_mesh(2)
    cfg = reference_config(world_size=W)
    want = jax_ring_simulate(jax_shard_state(jax_from_numpy(pos, vel, sp), jmesh),
                             cfg, jnp.float32(DT), steps, jmesh)
    for r in range(2):
        np.testing.assert_allclose(ranks2[r]["ring"], np.asarray(want.positions),
                                   rtol=0, atol=1e-5)


def test_ring_ragged_split_matches_one_device(ranks2):
    """N = 301 over 2 ranks (151 + 150): no N % D restriction."""
    pos, vel, sp = scene(301, 10)
    want = jax_simulate(jax_from_numpy(pos, vel, sp),
                        reference_config(world_size=W), jnp.float32(DT), 2)
    got = np.concatenate([p for _, p in sorted(r["ring_ragged"]
                                               for r in ranks2)])
    assert [r["ring_ragged"][1].shape[0] for r in ranks2] == [151, 150]
    np.testing.assert_allclose(got, np.asarray(want.positions), rtol=0,
                               atol=1e-5)


def test_exact_rung_and_relayout_two_ranks_match_jax(ranks2):
    (pos, vel, sp), cap = EXACT_CASE
    cfg = reference_config(world_size=W).replace(**cfg_kw(cell_capacity=cap))
    jmesh = jax_make_mesh(2)
    jst = jax_from_numpy(pos, 6.0 * vel, sp)
    carry = JDS.build_sharded_dense(jst, cfg, jmesh)
    carry, jovf = JDS.sharded_exact_steps(carry, cfg, jnp.float32(DT), 4, jmesh,
                                          rcap=600)
    jexact = JDS.gather_sharded_dense(carry, jst, jmesh)
    carry, jrdiag = JDS.sharded_relayout(carry, cfg, jmesh, passes=2, n=600)
    _, jsdiag = JDS.sharded_dense_steps(carry, cfg, jnp.float32(DT), 2, jmesh,
                                        n=600)
    for r in range(2):
        ovf, exact, rdiag, after, sdiag = ranks2[r]["exact"]
        assert ovf == int(jovf) == 0
        np.testing.assert_allclose(exact, np.asarray(jexact.positions), rtol=0,
                                   atol=1e-5)
        assert rdiag == [int(x) for x in jrdiag]
        assert rdiag[1] == 0 and rdiag[2] == 0  # every row home, none lost
        np.testing.assert_array_equal(after, exact)  # transport only
        assert sdiag[1:4] == [int(x) for x in jsdiag][1:4] == [0, 0, 0]


def test_init_sharded_dense_four_ranks_ragged(ranks4):
    """1001 rows over 4 ranks, no replicated stage: every row in a cell of
    its own rank's slab, ids 0..1000 once each, nothing lost."""
    ids = np.concatenate([r["init"][3] for r in ranks4])
    assert all(r["init"][0] for r in ranks4)
    assert all(r["init"][1] == 0 for r in ranks4)
    assert sorted(ids.tolist()) == list(range(1001))
    assert ranks4[0]["init"][2] == [251, 250, 250, 250] == [
        r["init"][3].size for r in ranks4]


def test_relayout_guard_never_loses_rows(ranks4):
    """300 rows drifted into one cell of rank 0's slab: the unguarded
    relayout drops rows past limbocap 64, the guarded one grows limbo,
    retries, and delivers every row."""
    lost_raw, lost, unserv, before, after = ranks4[0]["guard"]
    assert lost_raw > 0
    assert lost == 0 and unserv == 0 and after == before
