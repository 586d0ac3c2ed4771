"""The scenes of the multi-rank slab tests and what each spawned rank runs
on them (``rank_main``). Torch, numpy and the port only: the ranks import
this module by name, and keeping JAX out of it keeps their start-up short.
``test_torch_slab_ranks.py`` holds the JAX references and the assertions.
"""

import numpy as np

W = 16.0
DT = np.float32(1 / 30)


def cfg_kw(walled=False, **kw):
    kw = {"neighbor": "celllist_pallas", "cell_grid": 8, "cell_capacity": 4,
          **kw}
    if walled:
        kw.update(boundary="clamp", wrap_forces=False)
    return kw


def scene(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-W / 2, W / 2, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    sp = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, sp


def _multihop_scene():
    """Ballistic particles (zero attraction, strong drag); one of them
    jumps +5 in x on the first step: across two slabs of width 4."""
    pos, vel, sp = scene(512, 31)
    vel[:] = 0.0
    vel[0, 0] = 900.0
    return pos, vel, sp


# (name, scene, config keywords, steps, extra sharded_dense_simulate kw)
SLAB_CASES = {
    2: [("overflow", scene(1200, 5), cfg_kw(), 4, {}),
        ("leapfrog", scene(1200, 5), cfg_kw(integrator="leapfrog"), 4, {})],
    4: [("overflow", scene(1200, 5), cfg_kw(), 4, {}),
        ("walled", scene(900, 21), cfg_kw(walled=True, cell_capacity=32), 6,
         {}),
        ("multihop", _multihop_scene(),
         cfg_kw(cell_capacity=32, coefficient=25.0,
                attraction_matrix=np.zeros((5, 5), np.float32)), 6, {})],
}
RING_CASE = (scene(300, 9), 3)
EXACT_CASE = (scene(600, 2), 8)


def rank_main(mesh, d):
    import torch

    from particle3d_tpu_torch.config import reference_config as tref
    from particle3d_tpu_torch.state import from_numpy
    from particle3d_tpu_torch.parallel import domain_sharded as TDS
    from particle3d_tpu_torch.parallel import ring as TR

    def cfg_of(kw):
        return tref(world_size=W).replace(**kw)

    out = {}
    for name, (pos, vel, sp), kw, steps, extra in SLAB_CASES[d]:
        st = from_numpy(pos, vel, sp, device="cpu")
        res, diag = TDS.sharded_dense_simulate(st, cfg_of(kw), DT, steps, mesh,
                                               **extra)
        out[name] = (res.positions.numpy(), res.velocities.numpy(),
                     [int(x) for x in diag])
    if d == 2:
        (pos, vel, sp), steps = RING_CASE
        st = TR.shard_state(from_numpy(pos, vel, sp, device="cpu"), mesh)
        res = TR.sharded_simulate(st, tref(world_size=W), DT, steps, mesh)
        out["ring"] = mesh.all_gather(res.positions).numpy()
        # a ragged split: 301 rows over 2 ranks
        pos2, vel2, sp2 = scene(301, 10)
        st = TR.shard_state(from_numpy(pos2, vel2, sp2, device="cpu"), mesh)
        res = TR.sharded_simulate(st, tref(world_size=W), DT, 2, mesh)
        out["ring_ragged"] = (mesh.rank, res.positions.numpy())

        (pos, vel, sp), cap = EXACT_CASE
        cfg = cfg_of(cfg_kw(cell_capacity=cap))
        st = from_numpy(pos, 6.0 * vel, sp, device="cpu")
        carry = TDS.build_sharded_dense(st, cfg, mesh)
        carry, ovf = TDS.sharded_exact_steps(carry, cfg, DT, 4, mesh, rcap=600)
        exact = TDS.gather_sharded_dense(carry, st, mesh)
        carry, rdiag = TDS.sharded_relayout(carry, cfg, mesh, passes=2, n=600)
        after = TDS.gather_sharded_dense(carry, st, mesh)
        carry, sdiag = TDS.sharded_dense_steps(carry, cfg, DT, 2, mesh, n=600)
        out["exact"] = (int(ovf), exact.positions.numpy(), [int(x) for x in rdiag],
                        after.positions.numpy(), [int(x) for x in sdiag])
    if d == 4:
        cfg = cfg_of(cfg_kw(cell_capacity=32))
        carry = TDS.init_sharded_dense(3, 1001, cfg, mesh)  # ragged: 251+250*3
        data, pid, ld, lp, lost = carry
        cell_lo = mesh.rank * pid.shape[0] // 32
        sid = TDS.bin_sid(data[:, :3], cfg, 8)
        occ = pid >= 0
        in_cell = bool((sid[occ] == cell_lo + torch.arange(pid.shape[0])[occ]
                        // 32).all())
        ids = torch.cat([pid[occ], lp[lp >= 0]])
        out["init"] = (in_cell, int(lost), mesh.all_gather(
            torch.tensor([ids.numel()])).tolist(), ids.numpy())

        # drift 100 rows of every other rank into one cell of rank 0's slab:
        # the relayout's limbo overflows at limbocap 64 unless guarded
        st = from_numpy(*scene(2048, 7), device="cpu")
        cfg = cfg_of(cfg_kw(cell_capacity=32))
        data, pid, ld, lp, lost = TDS.build_sharded_dense(st, cfg, mesh,
                                                          limbocap=64)
        if mesh.rank:
            live = torch.nonzero(pid >= 0).flatten()[:100]
            data = data.clone()
            data[live, :3] = torch.tensor([-7.0, 0.3, 0.3])
            data[live, 0] += torch.linspace(0, 0.5, live.numel())
        carry = (data, pid, ld, lp, lost)
        before = mesh.psum(torch.tensor([int((pid >= 0).sum())
                                         + int((lp >= 0).sum())]))
        _, (_, _, lost_raw) = TDS.sharded_relayout(carry, cfg, mesh, passes=3,
                                                   n=2048, ocap=128)
        fixed, _, unserv = TDS._relayout_guarded(carry, cfg, mesh, nsc=8,
                                                 cap=32, mcap=None, ocap=128,
                                                 n=2048)
        after = mesh.psum(torch.tensor([int((fixed[1] >= 0).sum())
                                        + int((fixed[3] >= 0).sum())]))
        out["guard"] = (int(lost_raw), int(fixed[4]), unserv, int(before),
                        int(after))
    return out
