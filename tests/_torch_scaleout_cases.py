"""What each spawned rank runs for the scale-out tests of
``test_torch_domain.py``, ``test_torch_slab_adaptive.py`` and
``test_torch_launch_2level.py``. Torch, numpy and the port only: the
scenes arrive as numpy arrays and the port's configs from the test files,
which hold the JAX references and the assertions.
"""

import warnings

import numpy as np
import torch

DT = np.float32(1 / 30)


def _state(pos, vel, sp, masses=None, accel=None):
    from particle3d_tpu_torch.state import from_numpy

    return from_numpy(pos, vel, sp, masses, accel, device="cpu")


def domain_forces(mesh, pos, sp, flat, cfg, nsc, cap):
    """``sharded_dense_forces`` on the layout of ``pos`` at the slot
    positions ``flat``."""
    from particle3d_tpu_torch.ops.celllist_sweep import build_layout
    from particle3d_tpu_torch.ops.forces import pair_features
    from particle3d_tpu_torch.parallel.domain import sharded_dense_forces

    st = _state(pos, np.zeros_like(pos), sp)
    u, v = pair_features(st, cfg)
    layout = build_layout(st.positions, u, v, cfg, nsc, cap)
    return sharded_dense_forces(layout, torch.tensor(flat), cfg, nsc, cap,
                                mesh).numpy()


def domain_main(mesh, cases):
    """Every domain case on this rank: ``("forces", pos, sp, flat, cfg,
    nsc, cap)`` or ``("simulate", arrays, cfg, dt, steps, rebuild_every)``
    with ``arrays`` = (pos, vel, species, masses, accel)."""
    from particle3d_tpu_torch.parallel.domain import sharded_cell_simulate

    out = {}
    for name, case in cases.items():
        if case[0] == "forces":
            out[name] = domain_forces(mesh, *case[1:])
        else:
            _, arrays, cfg, dt, steps, every = case
            st, drift = sharded_cell_simulate(_state(*arrays), cfg, dt, steps,
                                              mesh, rebuild_every=every)
            out[name] = (st.positions.numpy(), float(drift))
    return out


def adaptive_main(mesh, cases, recap=None):
    """Every adaptive case on this rank: ``(pos, vel, sp, cfg, steps,
    driver keywords)``. Returns the gathered positions, the capacity, the
    history, the live rows, the lost count and the warnings of each, or
    ``("raised", message)``; and ``recap_main``'s result on ``recap``."""
    from particle3d_tpu_torch.parallel import domain_sharded as TDS

    out = {} if recap is None else {"recap": recap_main(mesh, *recap)}
    for name, (pos, vel, sp, cfg, steps, extra) in cases.items():
        st = _state(pos, vel, sp)
        carry = TDS.build_sharded_dense(st, cfg, mesh)
        extra = dict(extra)
        if extra.pop("with_state", False):
            extra["state"] = st
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                carry, cap, hist = TDS.sharded_dense_adaptive(
                    carry, cfg, DT, steps, mesh, n=st.n, **extra)
            except RuntimeError as e:
                out[name] = ("raised", str(e))
                continue
        got = TDS.gather_sharded_dense(carry, st, mesh)
        live = int(mesh.psum(torch.tensor((carry[1] >= 0).sum()
                                          + (carry[3] >= 0).sum())))
        out[name] = (got.positions.numpy(), cap, hist, live, int(carry[4]),
                     [str(w.message) for w in caught])
    return out


def recap_main(mesh, pos, sp, cfg):
    """``recap_sharded_dense`` on a carry with limbo rows: the slots and
    limbo before and after cap 4 -> 8 (limbo grown to 1024), and the error
    of a shrinking recap."""
    from particle3d_tpu_torch.parallel import domain_sharded as TDS

    st = _state(pos, np.zeros_like(pos), sp)
    before = TDS.build_sharded_dense(st, cfg, mesh)
    after = TDS.recap_sharded_dense(before, cfg, mesh, 8, 4, 8,
                                    limbocap_new=1024)
    try:
        TDS.recap_sharded_dense(before, cfg, mesh, 8, 4, 2)
        shrink = None
    except ValueError as e:
        shrink = str(e)
    arrays = [t.numpy() for t in before[:4]], [t.numpy() for t in after[:4]]
    return arrays, shrink


def two_level_main(mesh, pos, vel, sp, steps, shapes, slab):
    """``sharded_simulate_2level`` on each (dcn, ici) shape of ``shapes``,
    the positions gathered in global block order; the shapes that
    ``auto_mesh_2d`` derives from launch environments; a shard of an
    indivisible N; the 1-D ring exchange on a subgroup with global peers;
    and ``dryrun.slab_parity`` on ``slab`` = (n, cfg, dt, kw, steps)."""
    import torch.distributed as dist

    from particle3d_tpu_torch.config import reference_config
    from particle3d_tpu_torch.parallel import launch as L
    from particle3d_tpu_torch.parallel.dryrun import slab_parity
    from particle3d_tpu_torch.parallel.mesh import Mesh

    out = {"slab_parity": slab_parity(mesh, *slab)}
    cfg = reference_config(world_size=16.0)
    st = _state(pos, vel, sp)
    for dcn, ici in shapes:
        m2 = L.make_mesh_2d(dcn, ici, device="cpu")
        res = L.sharded_simulate_2level(L.shard_state_2level(st, m2), cfg, DT,
                                        steps, m2)
        # global block order is dcn-major: gather along ici, then dcn
        out[(dcn, ici)] = (m2.rank, m2.dcn.all_gather(
            m2.ici.all_gather(res.positions)).numpy())
    envs = [{"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "2"},
            {"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "4"},
            {"WORLD_SIZE": "4", "LOCAL_WORLD_SIZE": "1"}]
    out["auto"] = [L.auto_mesh_2d(device="cpu", environ=e).shape for e in envs]
    out["auto_ici"] = L.auto_mesh_2d(ici=2, device="cpu", environ={}).shape
    try:
        L.shard_state_2level(_state(pos[:301], vel[:301], sp[:301]),
                             L.make_mesh_2d(2, 2, device="cpu"))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    # a ring on the subgroup {0, 2} / {1, 3}: ranks 2 and 3 are members 1
    rank = dist.get_rank()
    groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    ranks = (rank % 2, rank % 2 + 2)
    sub = Mesh(2, rank // 2, torch.device("cpu"), groups[rank % 2], ranks)
    (from_left,), (from_right,) = sub.exchange_start(
        to_right=[torch.tensor([10.0 * rank])],
        to_left=[torch.tensor([100.0 * rank])]).wait()
    out["subgroup"] = (float(from_left), float(from_right),
                       sub.all_gather(torch.tensor([rank])).tolist())
    return out
