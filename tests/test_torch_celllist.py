"""Parity of the port's column layout, K1 plain version, rebind and overflow
sidecar with the JAX package, on the same numpy inputs.

JAX runs on the CPU; its K1 (``pallas_celllist._call``) runs in Pallas
interpret mode with exact sqrt and divide, the same arithmetic as the
port's plain version, so forces differ only by summation order (rtol 1e-5
plus an absolute floor of 1e-6 of the largest force, for components that
cancel). Integer layouts (slot tables, particle ids, gates, worklists) must
be exactly equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu.state import from_numpy as jax_from_numpy
from particle3d_tpu.ops import celllist_dense as JD
from particle3d_tpu.ops import overflow as JO
from particle3d_tpu.ops import pallas_celllist as JPC
from particle3d_tpu.ops.forces import pair_features as jax_pair_features
from particle3d_tpu.ops.pallas_allpairs import PAIR_P, pack_params as jax_pack

from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.state import from_numpy
from particle3d_tpu_torch.ops import celllist_dense as TD
from particle3d_tpu_torch.ops import celllist_sweep as TS
from particle3d_tpu_torch.ops import overflow as TO
from particle3d_tpu_torch.ops.forces import pad_features, pair_features
from particle3d_tpu_torch.ops.params import pack_params

NSC, W = 8, 16.0


def _cfg(law="particle_life", walled=False, **kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": NSC,
          "cell_capacity": 32, **kw}
    cfg = reference_config(world_size=W).replace(**kw)
    if law == "lennard_jones":
        cfg = cfg.replace(force_law="lennard_jones", particle_effect_radius=0.5,
                          lj_sigma=0.08, lj_epsilon=0.5)
    if walled:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    return cfg


def _scene(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, species


def _both_states(n, seed):
    pos, vel, sp = _scene(n, seed)
    return jax_from_numpy(pos, vel, sp), from_numpy(pos, vel, sp, device="cpu")


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_forces_close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("walled", [False, True])
def test_prepare_columns_layout_matches_jax(walled):
    cfg = _cfg(walled=walled)
    jst, tst = _both_states(600, 0)
    ju, jv = jax_pair_features(jst, cfg, pad_p=PAIR_P)
    tu, tv = pad_features(*pair_features(tst, from_jax_config(cfg)))
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    want = JPC.prepare_columns(jst.positions, ju, jv, cfg, NSC, 32)
    got = TS.prepare_columns(tst.positions, tu, tv, from_jax_config(cfg), NSC, 32)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w_))


def test_fold_to_cells_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.5 * W / 2, 1.5 * W / 2, (NSC * NSC, NSC * 4, 3))
    pos = pos.astype(np.float32)
    want = JPC.fold_to_cells(jnp.asarray(pos), jnp.float32(W), NSC, 4)
    got = TS.fold_to_cells(torch.from_numpy(pos), W, NSC, 4)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("law,walled", [
    ("particle_life", False), ("particle_life", True),
    ("lennard_jones", False), ("lennard_jones", True)])
def test_column_sweep_ref_matches_jax_call(law, walled):
    cfg = _cfg(law, walled)
    jst, _ = _both_states(600, 2)
    ju, jv = jax_pair_features(jst, cfg, pad_p=PAIR_P)
    ops = JPC.prepare_columns(jst.positions, ju, jv, cfg, NSC, 32)
    want = JPC._call(*ops[:5], jax_pack(cfg), cfg.force_law,
                     bool(cfg.wrap_forces), NSC, 32, True)
    t_ops = [torch.tensor(np.asarray(a)) for a in ops[:5]]
    got = TS.column_sweep_forces_ref(*t_ops, pack_params(from_jax_config(cfg)),
                                     cfg.force_law, bool(cfg.wrap_forces), NSC, 32)
    # the JAX kernel leaves garbage on empty slots; the port returns 0 there
    occ = np.asarray(ops[5]) >= 0
    g = _np(got).transpose(0, 2, 1)[occ]
    w_ = np.asarray(want).transpose(0, 2, 1)[occ]
    assert np.abs(w_).max() > 0
    _assert_forces_close(g, w_)
    dead = _np(got).transpose(0, 2, 1)[~occ]
    assert dead.size and (dead == 0.0).all()


@pytest.mark.parametrize("cap", [32, 2])
def test_build_dense_matches_jax(cap):
    cfg = _cfg()
    jst, tst = _both_states(1500 if cap == 2 else 500, 3)
    want = JD.build_dense(jst, cfg, NSC, cap)
    got = TD.build_dense(tst, from_jax_config(cfg), NSC, cap)
    for name in ("pid", "r2", "data", "feat"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_array_equal(_np(TD.sidecar_indices(got)),
                                  np.asarray(JD.sidecar_indices(want)))


def _kicked(ds_np_data, pid, seed, amp):
    rng = np.random.default_rng(seed)
    data = ds_np_data.copy()
    kick = rng.uniform(-amp, amp, data[:, 0:3].shape).astype(np.float32)
    pos = data[:, 0:3] + kick * (pid >= 0)[:, None]
    data[:, 0:3] = pos - np.float32(W) * np.floor(pos / np.float32(W) + 0.5)
    return data


@pytest.mark.parametrize("cap,n,mcap", [(32, 400, 1024), (2, 1500, 1024),
                                        (8, 3000, 1024)])
def test_rebind_matches_jax(cap, n, mcap):
    cfg = _cfg()
    tcfg = from_jax_config(cfg)
    jst, tst = _both_states(n, 4)
    jds = JD.build_dense(jst, cfg, NSC, cap)
    tds = TD.build_dense(tst, tcfg, NSC, cap)
    for k in range(3):
        data = _kicked(np.asarray(jds.data), np.asarray(jds.pid), 10 + k, 1.2)
        jds = jds.replace(data=jnp.asarray(data))
        tds = tds.replace(data=torch.from_numpy(data))
        jds, jmov, jmis, jidx = JD.rebind(jds, cfg, NSC, cap, mcap)
        tds, tmov, tmis, tidx = TD.rebind(tds, tcfg, NSC, cap, mcap)
        assert int(tmov) == int(jmov) and int(tmis) == int(jmis)
        np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
        for name in ("pid", "r2", "data", "feat"):
            np.testing.assert_array_equal(_np(getattr(tds, name)),
                                          np.asarray(getattr(jds, name)),
                                          err_msg=name)
    assert int(jmov) > 0


@pytest.mark.parametrize("cap,walled", [(2, False), (4, True)])
def test_neighborhood_apply_matches_jax(cap, walled):
    cfg = _cfg(walled=walled)
    jst, tst = _both_states(1500, 5)
    jds = JD.build_dense(jst, cfg, NSC, cap)
    mis = JD.sidecar_indices(jds)
    assert int((np.asarray(mis) < jds.pid.shape[0]).sum()) > 0  # overflowing
    rng = np.random.default_rng(6)
    f = rng.normal(size=(jds.pid.shape[0], 3)).astype(np.float32)
    want = JO.neighborhood_apply(jnp.asarray(f), jds.pos, jds.u, jds.v,
                                 jds.r2 > 0.0, mis, cfg, NSC, cap)
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    got = TO.neighborhood_apply(t(f), t(jds.pos), t(jds.u), t(jds.v),
                                t(jds.r2 > 0.0), t(mis), from_jax_config(cfg),
                                NSC, cap)
    _assert_forces_close(got, want)


def test_dense_forces_fresh_matches_jax():
    cfg = _cfg(cell_capacity=4)
    jst, tst = _both_states(1500, 7)
    jds = JD.build_dense(jst, cfg, NSC, 4)
    tds = TD.build_dense(tst, from_jax_config(cfg), NSC, 4)
    want = JD.dense_forces_fresh(jds.pos, jds, cfg, NSC, 4)
    got = TD.dense_forces_fresh(tds.pos, tds, from_jax_config(cfg), NSC, 4)
    live = np.asarray(jds.r2) > 0
    _assert_forces_close(_np(got)[live], np.asarray(want)[live])


def test_stale_receiver_row_is_zero_under_lennard_jones():
    """An empty slot keeping a stale copy of a live particle 1e-6 from it:
    as a receiver its Lennard-Jones sum would be infinite. K1's own gate
    (-1 there) makes that row exactly 0, and every live row keeps its
    value."""
    from particle3d_tpu_torch.config import SimConfig

    cfg = SimConfig(force_law="lennard_jones", lj_epsilon=0.2, lj_sigma=0.15,
                    particle_effect_radius=0.5, world_size=8.0,
                    neighbor="celllist_pallas", cell_grid=8,
                    cell_capacity=16).validate()
    rng = np.random.default_rng(4)
    lin = (np.arange(8) - 3.5) * 0.45
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    pos = (g + rng.normal(0, 0.02, g.shape)).astype(np.float32)
    n = pos.shape[0]
    st = from_numpy(pos, np.zeros((n, 3), np.float32), np.zeros(n, np.int32),
                    device="cpu")
    ds = TD.build_dense(st, cfg, 8, 16)
    before = TD.dense_forces_fresh(ds.pos, ds, cfg, 8, 16)
    live = int(torch.nonzero(ds.pid >= 0)[0, 0])
    cell = live // 16
    empty = int(torch.nonzero(ds.pid[cell * 16:(cell + 1) * 16] < 0)[0, 0]
                + cell * 16)
    data = ds.data.clone()
    data[empty] = data[live]
    data[empty, :3] += 1e-6
    ds = ds.replace(data=data)
    f = TD.dense_forces_fresh(ds.pos, ds, cfg, 8, 16)
    assert bool(torch.isfinite(f).all())
    assert (f[ds.r2 <= 0.0] == 0.0).all() and (f[empty] == 0.0).all()
    assert torch.equal(f[ds.r2 > 0.0], before[ds.r2 > 0.0])
