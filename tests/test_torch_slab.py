"""Parity of the port's slab decomposition on one rank with the JAX
package, on the same numpy inputs: K1's halo mode (plain version), the
slab sidecar sweeps, the 1-rank slab trajectory with each integrator, the
wrap-seam straddler, the exact rung with relayout, and K1 at feature
width 16.

JAX runs on the CPU; its K1 runs in Pallas interpret mode with exact sqrt
and divide, the arithmetic of the port's plain version, so single force
evaluations differ only by summation order (rtol 1e-5 plus an absolute
floor of 1e-6 of the largest force, for components that cancel).
Trajectories compound that rounding over their steps: positions agree to
1e-5 absolute (world 16, a few steps), velocities to 2e-5, and the integer
diagnostics exactly. Each JAX reference is computed once.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from particle3d_tpu import reference_config
from particle3d_tpu import simulate as jax_simulate
from particle3d_tpu.state import from_numpy as jax_from_numpy
from particle3d_tpu.ops import overflow as JO
from particle3d_tpu.ops import pallas_celllist as JPC
from particle3d_tpu.ops.pallas_allpairs import pack_params as jax_pack
from particle3d_tpu.parallel import make_mesh as jax_make_mesh
from particle3d_tpu.parallel import domain_sharded as JDS
from particle3d_tpu.parallel.ring import sharded_simulate as jax_ring_simulate
from particle3d_tpu.parallel.ring import shard_state as jax_shard_state

from particle3d_tpu_torch.config import from_jax_config
from particle3d_tpu_torch.state import from_numpy
from particle3d_tpu_torch.ops import celllist_sweep as TS
from particle3d_tpu_torch.ops import overflow as TO
from particle3d_tpu_torch.ops.params import pack_params
from particle3d_tpu_torch.parallel import domain_sharded as TDS
from particle3d_tpu_torch.parallel import launch, mesh as tmesh
from particle3d_tpu_torch.parallel import ring as TR

W = 16.0
DT = np.float32(1 / 30)


def _cfg(nsc=6, cap=8, walled=False, **kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": nsc, "cell_capacity": cap,
          **kw}
    cfg = reference_config(world_size=W).replace(**kw)
    if walled:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    return cfg


def _wide(cfg, species=12, seed=0):
    """12 species: the port pads the features to 16 columns."""
    m = np.random.default_rng(seed).uniform(-1, 1, (species, species))
    return cfg.replace(id_count=species, attraction_matrix=m.astype(np.float32),
                       colors=None)


def _scene(n, seed, species=5):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    sp = rng.integers(0, species, n).astype(np.int32)
    return pos, vel, sp


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * np.abs(want).max())


def _mesh1():
    return tmesh.make_mesh(1, device="cpu")


def _slab_layout(cfg, n=1500, seed=0, species=5):
    """The port's 1-rank carry of a numpy scene, its r2 gate and the
    halo-mode pieces: (g, pos_d, u_d, pack, r2)."""
    pos, vel, sp = _scene(n, seed, species)
    tcfg = from_jax_config(cfg)
    st = from_numpy(pos, vel, sp, device="cpu")
    mesh = _mesh1()
    g = TDS._geometry(tcfg, mesh, n, None, None, None, None, None)
    data, pid, _, _, _ = TDS._local_build(st, tcfg, g, 0)
    cell_of = torch.arange(g.s_loc) // g.cap
    aligned = (pid >= 0) & (TS.bin_sid(data[:, :3], tcfg, g.nsc) == cell_of)
    r2 = torch.where(aligned, 1.0, -1.0)
    pos_d, u_d, pack = TDS.slab_pack(data[:, :3], data, r2, tcfg, g, 0)
    return tcfg, g, pos_d, u_d, pack, r2


# -- K1 halo mode -------------------------------------------------------------

@pytest.mark.parametrize("walled,shape,wide", [
    (False, "single", False), (False, "split", False),
    (True, "single", False), (True, "split", False),
    (False, "single", True), (True, "split", True)])
def test_halo_ref_matches_jax_call(walled, shape, wide):
    cfg = _cfg(walled=walled)
    if wide:
        cfg = _wide(cfg)
    tcfg, g, pos_d, u_d, pack, r2 = _slab_layout(
        cfg, species=12 if wide else 5)
    nsc, cap = g.nsc, g.cap
    r2c = r2.reshape(g.cols_local, g.cs)
    if shape == "split":
        ops = TDS.halo_call_operands(pos_d[nsc:-nsc], u_d[nsc:-nsc], pack,
                                     tcfg, cap)
        r2c = r2c[nsc:-nsc]
    else:
        fl, fr = TDS.fix_halos(pack[-nsc:], pack[:nsc], tcfg, g.d, 0)
        ops = TDS.halo_call_operands(pos_d, u_d, torch.cat([fl, pack, fr]),
                                     tcfg, cap)
    assert ops[1].shape[1] == (16 if wide else 8)
    got = TS.column_sweep_forces(*ops, pack_params(tcfg), cfg.force_law,
                                 not walled, nsc, cap, halo=True)
    want = JPC._call(*(jnp.asarray(_np(a)) for a in ops), jax_pack(cfg),
                     cfg.force_law, not walled, nsc, cap, True, halo=True)
    live = _np(r2c) > 0
    w_ = np.asarray(want).transpose(0, 2, 1)[live]
    assert np.abs(w_).max() > 0
    _close(_np(got).transpose(0, 2, 1)[live], w_)
    # the JAX kernel leaves garbage on dead slots; the port returns 0 there
    dead = _np(got).transpose(0, 2, 1)[~live]
    assert dead.size and (dead == 0.0).all()


@pytest.mark.parametrize("walled", [False, True])
def test_halo_mode_equals_full_grid_sweep_on_one_rank(walled):
    """On one rank the halo planes are the grid's own edge planes, shifted
    by the box (or killed when walled): halo K1 must reproduce non-halo
    K1 on the same layout to the bit."""
    cfg = _cfg(walled=walled)
    tcfg, g, pos_d, u_d, pack, r2 = _slab_layout(cfg, seed=3)
    nsc, cap = g.nsc, g.cap
    fl, fr = TDS.fix_halos(pack[-nsc:], pack[:nsc], tcfg, g.d, 0)
    ops = TDS.halo_call_operands(pos_d, u_d, torch.cat([fl, pack, fr]), tcfg,
                                 cap)
    args = (pack_params(tcfg), cfg.force_law, not walled, nsc, cap)
    halo = TS.column_sweep_forces(*ops, *args, halo=True)
    src = TS.ghost_columns(pos_d, pack[..., 3:11], pack[..., 11], tcfg, cap)
    full = TS.column_sweep_forces(ops[0], ops[1], *src, *args)
    live = _np(r2.reshape(g.cols_local, g.cs)) > 0
    np.testing.assert_array_equal(_np(halo).transpose(0, 2, 1)[live],
                                  _np(full).transpose(0, 2, 1)[live])


def test_halo_operand_checks():
    cfg = _cfg()
    tcfg, g, pos_d, u_d, pack, _ = _slab_layout(cfg, n=300)
    nsc, cap = g.nsc, g.cap
    ops = TDS.halo_call_operands(pos_d[nsc:-nsc], u_d[nsc:-nsc], pack, tcfg,
                                 cap)
    args = (pack_params(tcfg), cfg.force_law, True, nsc, cap)
    with pytest.raises(ValueError, match="post_g"):  # sources one plane short
        TS.column_sweep_forces(ops[0], ops[1], ops[2][nsc:].contiguous(),
                               ops[3][nsc:].contiguous(),
                               ops[4][nsc:].contiguous(), *args, halo=True)
    with pytest.raises(ValueError, match="whole number of planes"):
        TS.column_sweep_forces(ops[0][1:].contiguous(), ops[1][1:].contiguous(),
                               *ops[2:], *args, halo=True)
    with pytest.raises(ValueError, match="feature width"):
        TS.column_sweep_forces(ops[0], ops[1][:, :4].contiguous(), *ops[2:],
                               *args, halo=True)


def test_fresh_celllist_forces_at_width_16_matches_jax():
    """K1 takes 16 feature columns: 12 species through the fresh layout
    against the JAX package's ``pallas_celllist_forces`` in interpret
    mode."""
    from particle3d_tpu.ops.forces import pair_features as jax_pair_features
    from particle3d_tpu_torch.ops.forces import pair_features

    cfg = _wide(_cfg(nsc=3, cap=12), seed=1)
    pos, vel, sp = _scene(200, 4, species=12)
    jst = jax_from_numpy(pos, vel, sp)
    tst = from_numpy(pos, vel, sp, device="cpu")
    ju, jv = jax_pair_features(jst, cfg)
    # one jit of the whole function compiles far faster than its eager ops
    want = jax.jit(lambda p, u, v: JPC.pallas_celllist_forces(
        p, u, v, cfg, interpret=True))(jst.positions, ju, jv)
    tu, tv = pair_features(tst, from_jax_config(cfg))
    assert tu.shape[1] == 12
    got = TS.fresh_celllist_forces(tst.positions, tu, tv, from_jax_config(cfg))
    assert np.abs(np.asarray(want)).max() > 0
    _close(got, want)


def test_fold_to_cells_slab_offset_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.5 * W / 2, 1.5 * W / 2, (2 * 6, 6 * 4, 3))
    pos = pos.astype(np.float32)
    want = JPC.fold_to_cells(jnp.asarray(pos), jnp.float32(W), 6, 4, col0_x=3)
    got = TS.fold_to_cells(torch.from_numpy(pos), W, 6, 4, col0_x=3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


# -- the slab sidecar -----------------------------------------------------------

@pytest.mark.parametrize("walled,self_ring", [(False, True), (False, False),
                                              (True, False)])
def test_slab_neighborhood_sweeps_matches_jax(walled, self_ring):
    cfg = _cfg(cap=4, walled=walled)
    tcfg, g, pos_d, u_d, pack, r2 = _slab_layout(cfg, n=1200, seed=5)
    nsc = g.nsc
    fl, fr = TDS.fix_halos(pack[-nsc:], pack[:nsc], tcfg, g.d, 0)
    ext = torch.cat([fl, pack, fr])
    rng = np.random.default_rng(6)
    m = 40
    # worklist rows near the wrap seam and inside the slab
    mpos = rng.uniform(-W / 2, W / 2, (m, 3)).astype(np.float32)
    mpos[:10, 0] = rng.uniform(-W / 2, -W / 2 + 1.0, 10)
    mpos[10:20, 0] = rng.uniform(W / 2 - 1.0, W / 2, 10)
    sp = rng.integers(0, 5, m)
    mu = np.zeros((m, 8), np.float32)
    mu[:, :5] = np.asarray(cfg.attraction_matrix)[sp]
    mv = np.zeros((m, 8), np.float32)
    mv[np.arange(m), sp] = 1.0
    mvalid = rng.uniform(size=m) < 0.8
    u_all = u_d.reshape(-1, 8)
    jargs = (jnp.asarray(_np(ext)), jnp.asarray(_np(u_all)), jnp.asarray(mpos),
             jnp.asarray(mu), jnp.asarray(mv), jnp.asarray(mvalid))
    jf_mis, jf_from = jax.jit(lambda *a: JO.slab_neighborhood_sweeps(
        *a, cfg, nsc, g.planes_local, g.cap, 0, self_ring=self_ring))(*jargs)
    tf_mis, tf_from = TO.slab_neighborhood_sweeps(
        ext, u_all, torch.from_numpy(mpos), torch.from_numpy(mu),
        torch.from_numpy(mv), torch.from_numpy(mvalid), tcfg, nsc,
        g.planes_local, g.cap, 0, self_ring=self_ring)
    assert np.abs(np.asarray(jf_from)).max() > 0
    _close(tf_mis, jf_mis)
    _close(tf_from, jf_from)


# -- the 1-rank slab trajectory -------------------------------------------------

_JAX_RUNS = {}


def _run_both(key, cfg, pos, vel, sp, steps, **kw):
    """(JAX, torch) results of sharded_dense_simulate on one rank; the JAX
    run is cached per key."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = JDS.sharded_dense_simulate(
            jax_from_numpy(pos, vel, sp), cfg, jnp.float32(DT), steps,
            jax_make_mesh(1), **kw)
    got = TDS.sharded_dense_simulate(from_numpy(pos, vel, sp, device="cpu"),
                                     from_jax_config(cfg), DT, steps,
                                     _mesh1(), **kw)
    return _JAX_RUNS[key], got


def _assert_runs_match(jax_run, torch_run):
    (jout, jd), (tout, td) = jax_run, torch_run
    assert [int(x) for x in td] == [int(x) for x in jd]
    np.testing.assert_allclose(_np(tout.positions), np.asarray(jout.positions),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tout.velocities),
                               np.asarray(jout.velocities), rtol=0, atol=2e-5)


@pytest.mark.parametrize("integrator", ["euler", "velocity_verlet",
                                        "leapfrog"])
def test_one_rank_slab_matches_jax(integrator):
    """An overflowing scene (cap 4 against ~2.3 per cell, a Poisson tail
    past 4): the initial build parks rows in limbo, the sidecar serves
    them, and non-Euler integrators must feed it mid-step positions."""
    cfg = _cfg(nsc=8, cap=4, integrator=integrator)
    pos, vel, sp = _scene(1200, 5)
    jr, tr = _run_both(("overflow", integrator), cfg, pos, vel, sp, 4)
    # all served, nothing lost, and the limbo path really ran
    assert [int(x) for x in jr[1][1:4]] == [0, 0, 0]
    assert int((TDS.build_sharded_dense(from_numpy(pos, vel, sp, device="cpu"),
                                        from_jax_config(cfg), _mesh1())[3]
                >= 0).sum()) > 0
    _assert_runs_match(jr, tr)


def test_one_rank_slab_matches_allpairs_ground_truth():
    cfg = _cfg(nsc=8, cap=4, integrator="leapfrog")
    pos, vel, sp = _scene(1200, 5)
    _, (tout, td) = _run_both(("overflow", "leapfrog"), cfg, pos, vel, sp, 4)
    ref = jax_simulate(jax_from_numpy(pos, vel, sp),
                       cfg.replace(neighbor="allpairs"), jnp.float32(DT), 4)
    assert [int(x) for x in td[1:4]] == [0, 0, 0]
    np.testing.assert_allclose(_np(tout.positions), np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("walled", [False, True])
def test_one_rank_wrap_seam_straddler_matches_jax(walled):
    """Overflow blobs on the wrap seam (x = -8) and on an interior plane:
    on one rank the sidecar's reverse forces across the seam come from the
    self-ring remap (the JAX case (True, 1) of the straddle test)."""
    cfg = _cfg(nsc=8, cap=4, walled=walled)
    # N and the step count of the overflow scene: the periodic case reuses
    # the JAX reference's compiled program
    pos, vel, sp = _scene(1200, 7)
    rng = np.random.default_rng(99)
    for i, centre in enumerate(([0.0, 1.0, 1.0], [-7.99, -1.0, 2.0])):
        dirs = rng.normal(size=(24, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pos[24 * i:24 * (i + 1)] = np.float32(centre) + dirs * 0.9
    pos = pos.clip(-7.999, 7.999)
    vel *= 0.2
    jr, tr = _run_both(("seam", walled), cfg, pos, vel, sp, 4)
    assert int(tr[1][1]) == 0 and int(tr[1][2]) == 0
    _assert_runs_match(jr, tr)


def test_exact_rung_then_relayout_matches_jax():
    """The exact rung (masked ring all-pairs on compacted rows) on one rank,
    then the transport-only relayout: same gathered state, same repair
    diagnostics, positions untouched by the relayout."""
    cfg = _cfg(cap=8)
    pos, vel, sp = _scene(700, 2)
    vel *= 6.0  # rows drift out of their cells during the exact window
    tcfg, mesh = from_jax_config(cfg), _mesh1()
    jmesh = jax_make_mesh(1)
    jst = jax_from_numpy(pos, vel, sp)
    tst = from_numpy(pos, vel, sp, device="cpu")
    jc, jovf = JDS.sharded_exact_steps(JDS.build_sharded_dense(jst, cfg, jmesh),
                                       cfg, jnp.float32(DT), 4, jmesh, rcap=700)
    tc, tovf = TDS.sharded_exact_steps(TDS.build_sharded_dense(tst, tcfg, mesh),
                                       tcfg, DT, 4, mesh, rcap=700)
    assert int(jovf) == int(tovf) == 0
    jout = JDS.gather_sharded_dense(jc, jst, jmesh)
    tout = TDS.gather_sharded_dense(tc, tst, mesh)
    np.testing.assert_allclose(_np(tout.positions), np.asarray(jout.positions),
                               rtol=0, atol=1e-5)
    jc2, jdiag = JDS.sharded_relayout(jc, cfg, jmesh, passes=1, n=700)
    tc2, tdiag = TDS.sharded_relayout(tc, tcfg, mesh, passes=1, n=700)
    assert [int(x) for x in tdiag] == [int(x) for x in jdiag]
    assert int(tdiag[0]) > 0 and int(tdiag[2]) == 0
    after = TDS.gather_sharded_dense(tc2, tst, mesh)
    np.testing.assert_array_equal(_np(after.positions), _np(tout.positions))
    np.testing.assert_array_equal(_np(tc2[1]), np.asarray(jc2[1]))
    # the repaired carry continues on the grid path, exactly
    tc3, d = TDS.sharded_dense_steps(tc2, tcfg, DT, 2, mesh, n=700)
    assert int(d[1]) == 0 and int(d[2]) == 0 and int(d[3]) == 0


def test_stay_sharded_windows_equal_one_call():
    cfg = _cfg(cap=8)
    tcfg, mesh = from_jax_config(cfg), _mesh1()
    pos, vel, sp = _scene(600, 8)
    st = from_numpy(pos, vel, sp, device="cpu")
    want, _ = TDS.sharded_dense_simulate(st, tcfg, DT, 6, mesh)
    carry = TDS.build_sharded_dense(st, tcfg, mesh)
    carry, _ = TDS.sharded_dense_steps(carry, tcfg, DT, 3, mesh, n=600)
    carry, d = TDS.sharded_dense_steps(carry, tcfg, DT, 3, mesh, n=600)
    out = TDS.gather_sharded_dense(carry, st, mesh)
    assert int(d[3]) == 0
    np.testing.assert_array_equal(_np(out.positions), _np(want.positions))


@pytest.mark.parametrize("n", [512, 1001])
def test_init_sharded_dense_one_rank(n):
    """No replicated stage: every row in its own cell's slot or in limbo,
    n rows in all, ids 0..n-1 once each."""
    cfg = from_jax_config(_cfg(nsc=8, cap=32))
    carry = TDS.init_sharded_dense(0, n, cfg, _mesh1())
    data, pid, ld, lp, lost = carry
    ids = np.concatenate([_np(pid)[_np(pid) >= 0], _np(lp)[_np(lp) >= 0]])
    assert int(lost) == 0 and sorted(ids.tolist()) == list(range(n))
    sid = _np(TS.bin_sid(data[:, :3], cfg, 8))
    occ = _np(pid) >= 0
    assert (sid[occ] == (np.arange(pid.shape[0]) // 32)[occ]).all()
    assert np.abs(_np(data[:, :3])[occ]).max() <= W / 2


def test_one_rank_ring_matches_jax():
    cfg = reference_config(world_size=W)
    pos, vel, sp = _scene(300, 9)
    jst = jax_from_numpy(pos, vel, sp)
    jmesh = jax_make_mesh(1)
    want = jax_ring_simulate(jax_shard_state(jst, jmesh), cfg, jnp.float32(DT),
                             3, jmesh)
    mesh = _mesh1()
    tst = TR.shard_state(from_numpy(pos, vel, sp, device="cpu"), mesh)
    got = TR.sharded_simulate(tst, from_jax_config(cfg), DT, 3, mesh)
    np.testing.assert_allclose(_np(got.positions), np.asarray(want.positions),
                               rtol=0, atol=1e-5)


# -- mesh and launch ------------------------------------------------------------

def test_make_mesh_needs_a_group_beyond_one_rank():
    m = tmesh.make_mesh(1, device="cpu")
    assert (m.size, m.rank) == (1, 0)
    x = torch.arange(6.0)
    assert m.ppermute([x], 1)[0] is not None
    assert torch.equal(m.ppermute([x], -1)[0], x)
    assert torch.equal(m.psum(x), x) and torch.equal(m.all_gather(x), x)
    with pytest.raises(ValueError, match="not initialised"):
        tmesh.make_mesh(2, device="cpu")


def test_launch_reads_torchrun_environment():
    env = {"RANK": "0", "WORLD_SIZE": "4", "MASTER_ADDR": "localhost"}
    assert launch.cluster_env_configured(env)
    assert not launch.cluster_env_configured({**env, "WORLD_SIZE": "1"})
    assert not launch.cluster_env_configured({"RANK": "0"})
    # a plain single-process run: no group, no-op
    assert launch.initialize_distributed(environ={}) is False
    with pytest.raises(ValueError, match="together"):
        launch.initialize_distributed(init_method="tcp://localhost:1")


def test_slab_command_runs_one_rank(monkeypatch, capsys):
    import json

    from particle3d_tpu_torch.__main__ import main
    from particle3d_tpu_torch.models import presets

    monkeypatch.setitem(presets.SLAB_RUNS, "tiny", dict(
        n=700, world_size=W, nsc=8, cap=16, mcap=512, migcap=256, ocap=64))
    rec = main(["slab", "--config", "tiny", "--steps", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["n"] == 700 and rec["ranks"] == 1
    assert rec["lost"] == 0 and rec["max_masked"] == 0
