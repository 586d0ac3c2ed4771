"""The port's culled all-pairs backends (K2 with its tile mask, K4 over a
worklist; plain versions on the CPU), the Morton sort and worklists around
them, the culled rung ``simulate_culled`` and the adaptive driver, against
the JAX package on the same numpy inputs.

Integer results (Morton keys, tile bounds, survival masks, worklists)
decide which tile pairs run and must be exactly equal. Culled forces are
held to the triangular sweep as the JAX tests hold theirs: max error <=
1e-5 * max|F| (culling drops only pairs that contribute exactly zero; the
sums are reordered). Trajectories use the JAX tests' tolerances:
atol 5e-5 (scaled) for ``simulate_culled``, rtol 1e-3 / atol 1e-4 for the
adaptive driver.

The adaptive driver's reference replays its committed windows through the
JAX package: cell-path windows as all-pairs (as the JAX tests do), culled
windows through JAX's ``simulate_culled``. On the CPU the JAX driver runs
its culled windows as plain all-pairs instead, and on these clustering
scenes the culled rung's box-unit arithmetic and all-pairs' world-unit
arithmetic part by ~1e-2 within 60 steps in the JAX package itself (two
particles in a close encounter); the port's culled rung tracks JAX's to
~2e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from particle3d_tpu import init_scene as jax_init_scene
from particle3d_tpu import reference_config, simulate as jax_simulate
from particle3d_tpu.engine.step import simulate_culled as jax_simulate_culled
from particle3d_tpu.ops import forces as JF
from particle3d_tpu.ops import pallas_allpairs as JA
from particle3d_tpu.state import from_numpy as jax_from_numpy

import particle3d_tpu_torch as P
from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.engine import step as engine
from particle3d_tpu_torch.ops import allpairs_sweep as A
from particle3d_tpu_torch.ops import forces as TF

W = 16.0


def _cfg(**kw):
    return reference_config(world_size=W).replace(**kw)


def _positions(kind, n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    if kind == "clustered":  # dense blob + diffuse rest
        pos[: n // 2] = pos[: n // 2] * 0.05 + 3.0
    elif kind == "seam":  # half the particles hug the +x/y/z corner
        pos[: n // 2] = pos[: n // 2] * 0.05 + 7.95
        pos[pos > W / 2] -= W
    return pos


def _both(kind, n, seed, cfg):
    pos = _positions(kind, n, seed)
    sp = np.random.default_rng(seed + 1).integers(0, 5, n).astype(np.int32)
    z = np.zeros_like(pos)
    jst = jax_from_numpy(pos, z, sp)
    tst = P.from_numpy(pos, z, sp, device="cpu")
    ju, jv = JF.pair_features(jst, cfg)
    tu, tv = TF.pair_features(tst, from_jax_config(cfg))
    return jst, ju, jv, tst, tu, tv


def _sorted(jst, tst, cfg):
    jorder = jnp.argsort(JA.morton_keys(jst.positions, cfg.world_size))
    torder = torch.argsort(A.morton_keys(tst.positions, float(W)), stable=True)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    return jorder, torder


def _assert_exactish(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(got - want).max()) / scale < 1e-5


KINDS = [("uniform", {}), ("clustered", {}),
         ("walled", {"wrap_forces": False, "boundary": "clamp"}),
         ("seam", {})]


def test_morton_keys_equal_jax():
    rng = np.random.default_rng(0)
    pos = rng.uniform(-0.6 * W, 0.6 * W, (5000, 3)).astype(np.float32)
    want = np.asarray(JA.morton_keys(jnp.asarray(pos), W))
    got = A.morton_keys(torch.from_numpy(pos), W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_bounds_min_image_seam():
    """A tile straddling the seam folds back to a tight sphere; a tile
    genuinely spread past w/2 is uncullable. Equal to JAX bit for bit."""
    cfg = _cfg()
    t = 8
    jit = 0.1 * np.random.default_rng(60).normal(size=(t, 3))
    pos0 = np.float32([7.9, 0.0, 0.0]) + jit
    pos0[:, 0] = np.where(pos0[:, 0] > 8.0, pos0[:, 0] - W, pos0[:, 0])
    pos1 = np.zeros((t, 3))
    pos1[1, 0], pos1[2, 0] = 7.0, -7.0
    pos = np.concatenate([pos0, pos1]).astype(np.float32)
    jc, jr = JA.tile_bounds(jnp.asarray(pos), 2 * t, t, cfg)
    tc, tr = A.tile_bounds(torch.from_numpy(pos), 2 * t, t,
                           from_jax_config(cfg))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(tr[0]) < 1.0 and float(tr[1]) > 1e29


@pytest.mark.parametrize("kind,kw", KINDS)
def test_masks_and_worklists_equal_jax(kind, kw):
    cfg = _cfg(**kw)
    tcfg = from_jax_config(cfg)
    n, t = 1500, 64
    jst, _, _, tst, _, _ = _both(kind, n, 3, cfg)
    jorder, torder = _sorted(jst, tst, cfg)
    np_ = A._round_to(n, t)
    nt = np_ // t
    jp = JA._pad_rows(jst.positions[jorder], np_)
    tp = A._pad_rows(tst.positions[torder], np_)
    for got, want in zip(A.tile_bounds(tp, n, t, tcfg),
                         JA.tile_bounds(jp, n, t, cfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jmask, _ = JA.culled_tile_mask(jp, n, t, cfg)
    tmask, frac = A.culled_tile_mask(tp, n, t, tcfg)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for skin in (0.0, 2.0):
        want = np.asarray(JA.pair_survival_mask(jp, n, t, nt, cfg,
                                                jnp.float32(skin)))
        got = A.pair_survival_mask(tp, n, t, nt, tcfg, skin)
        np.testing.assert_array_equal(got.numpy(), want)
        chunks, count = JA.build_pair_worklist(want, nt, quantum=64)
        wp, cnt = A.build_pair_worklist(got, nt)
        assert cnt == count
        np.testing.assert_array_equal(
            wp.numpy(), np.concatenate([c[0] for c in chunks])[:count])


def test_worklist_runs_and_k4_shares():
    """K4's run starts are each receiver tile's first entry (empty runs
    included), and its shares follow the mean run: about 4 entries a block,
    1 to 16 shares."""
    wi = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32)
    assert A.worklist_row_start(wi, 5).tolist() == [0, 3, 3, 5, 6, 6]
    assert A.pairlist_splits(2048, 2048) == 1
    assert A.pairlist_splits(15309, 256) == 15      # the 32k scene's mean 60
    assert A.pairlist_splits(142203, 2048) == 16    # 262k: mean 69, capped


@pytest.mark.parametrize("kind,kw", KINDS)
def test_culled_and_pairlist_forces_match_tri(kind, kw):
    cfg = _cfg(**kw)
    tcfg = from_jax_config(cfg)
    n, t = 1024, 64
    jst, ju, jv, tst, tu, tv = _both(kind, n, 5, cfg)
    want = JA.pallas_allpairs_forces_tri(jst.positions, ju, jv, cfg, t=t)
    culled, frac = A.pallas_allpairs_forces_culled(tst.positions, tu, tv, tcfg,
                                                   t=t, with_stats=True)
    if kind in ("clustered", "walled"):
        assert float(frac) < 1.0  # culling really fired
    _assert_exactish(culled.numpy(), want)
    _, torder = _sorted(jst, tst, cfg)
    np_ = A._round_to(n, t)
    ps = tst.positions[torder]
    mask = A.pair_survival_mask(A._pad_rows(ps, np_), n, t, np_ // t, tcfg)
    wp, count = A.build_pair_worklist(mask, np_ // t)
    f = A.pallas_allpairs_forces_pairlist(ps, tu[torder], tv[torder], tcfg,
                                          wp, t=t)
    got = torch.empty_like(f)
    got[torder] = f
    _assert_exactish(got.numpy(), want)


def test_simulate_culled_matches_jax_allpairs():
    cfg = _cfg()
    jst = jax_init_scene(jax.random.PRNGKey(55), 512, cfg)
    dt = jnp.float32(1 / 60)
    ref = jax_simulate(jst, cfg.replace(neighbor="allpairs"), dt, 12)
    out, stats = P.simulate_culled(P.from_jax_state(jst, device="cpu"),
                                   from_jax_config(cfg), 1 / 60, 12,
                                   window=5, t=64)
    assert stats["windows"] == 3  # 5 + 5 + 2 (remainder window)
    assert stats["retries"] == 0 and 0 < stats["max_pair_frac"] <= 1
    np.testing.assert_array_equal(out.species.numpy(), np.asarray(jst.species))
    scale = max(1.0, float(np.abs(np.asarray(ref.positions)).max()))
    np.testing.assert_allclose(out.positions.numpy() / scale,
                               np.asarray(ref.positions) / scale, atol=5e-5)


class _FakeClock:
    """Each call advances by the next scripted delta (seconds)."""

    def __init__(self, deltas):
        self.deltas = list(deltas)
        self.t = 0.0

    def __call__(self):
        self.t += self.deltas.pop(0) if self.deltas else 1.0
        return self.t


def _ladder_cfg(**kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": 8, "cell_capacity": 2,
          "interaction_force": 4.0,
          "attraction_matrix": np.ones((5, 5), np.float32) * 0.9, **kw}
    return _cfg(**kw)


def _dispersing_blob():
    """Zero forces and a crammed blob flying apart: the scene clusters past
    max_cap, then disperses ballistically (test_celllist_dense.py)."""
    cfg = _ladder_cfg(interaction_force=1.0,
                      attraction_matrix=np.zeros((5, 5), np.float32))
    rng = np.random.default_rng(7)
    st = jax_init_scene(jax.random.PRNGKey(34), 240, cfg)
    pos = np.asarray(st.positions).copy()
    vel = np.asarray(st.velocities).copy()
    dirs = rng.normal(size=(12, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[:12] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    vel[:12] = dirs * 8.0
    return cfg, st.replace(positions=jnp.asarray(pos),
                           velocities=jnp.asarray(vel))


@pytest.mark.parametrize("case", ["switches", "stays", "falls_back",
                                  "reprobes"])
def test_adaptive_driver_matches_jax(case):
    """The JAX driver's four cases with the same fake clocks: the cost
    probe switches to the culled rung (decreasing clock) or stays on the
    cell path (increasing clock); masking at max_cap falls back to the
    culled rung; a dispersed scene re-enters the cell path."""
    steps, kw = 60, {"chunk": 10}
    if case == "reprobes":
        cfg, jst = _dispersing_blob()
        steps, kw = 48, {"chunk": 2, "max_cap": 4,
                         "_timer": _FakeClock([100.0 / (i + 1)
                                               for i in range(400)])}
    else:
        cfg = _ladder_cfg()
        jst = jax_init_scene(jax.random.PRNGKey(33 if case == "falls_back"
                                                else 31), 600, cfg)
        if case == "falls_back":
            steps, kw["max_cap"] = 40, 3
        else:
            deltas = ([100.0 / (i + 1) for i in range(200)]
                      if case == "switches" else
                      [float(i + 1) for i in range(200)])
            kw.update(probe_factor=0.0, _timer=_FakeClock(deltas))
    msgs = []
    out, cap, hist = P.simulate_dense_adaptive(
        P.from_jax_state(jst, device="cpu"), from_jax_config(cfg), 1 / 30,
        steps, ocap=0, verbose=msgs.append, **kw)
    backends = [c for _, c, _ in hist]
    assert all(masked == 0 for _, _, masked in hist)
    assert sum(k for k, _, _ in hist) == steps
    if case == "switches":
        assert any("probing the culled backend" in m for m in msgs)
        assert any("switching to the culled" in m for m in msgs)
        i = backends.index("allpairs")
        assert all(b == "allpairs" for b in backends[i:])
    elif case == "stays":
        assert any("probing the culled backend" in m for m in msgs)
        assert not any("switching to the culled" in m for m in msgs)
        assert backends[-1] != "allpairs"
    elif case == "falls_back":
        assert "allpairs" in backends
    else:
        i = backends.index("allpairs")
        assert any(b != "allpairs" for b in backends[i:]), (hist, msgs)
        assert any("back on the cell path" in m for m in msgs)
    ref = jst
    for k, backend, _ in hist:
        if backend == "allpairs":
            ref, _ = jax_simulate_culled(ref, cfg, jnp.float32(1 / 30), k,
                                         window=min(k, 16), t=A.KERNEL_TILE)
        else:
            ref = jax_simulate(ref, cfg.replace(neighbor="allpairs"),
                               jnp.float32(1 / 30), k)
    np.testing.assert_allclose(out.positions.numpy(),
                               np.asarray(ref.positions), rtol=1e-3, atol=1e-4)


def test_simulate_culled_launches_nothing_on_the_cpu():
    tst = P.make_scene("reference", seed=2, n=300, device="cpu")[0]
    before = dict(A.KERNEL_LAUNCHES)
    engine.simulate_culled(tst, from_jax_config(_cfg()), 1 / 60, 2)
    assert A.KERNEL_LAUNCHES == before
