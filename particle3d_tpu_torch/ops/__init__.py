"""Force operators of the port and the launch counts of their kernels
(the renderer's included)."""


def kernel_launches() -> dict[str, int]:
    """Launches of every hand-written kernel since the last reset."""
    from ..render import splat
    from . import allpairs_mxu_sweep, allpairs_sweep, celllist_sweep

    return {"celllist_sweep": celllist_sweep.KERNEL_LAUNCHES,
            "celllist_halo": celllist_sweep.HALO_LAUNCHES,
            **allpairs_sweep.KERNEL_LAUNCHES,
            **allpairs_mxu_sweep.KERNEL_LAUNCHES,
            **splat.KERNEL_LAUNCHES}


def reset_kernel_launches():
    from ..render import splat
    from . import allpairs_mxu_sweep, allpairs_sweep, celllist_sweep

    celllist_sweep.KERNEL_LAUNCHES = 0
    celllist_sweep.HALO_LAUNCHES = 0
    for counts in (allpairs_sweep.KERNEL_LAUNCHES,
                   allpairs_mxu_sweep.KERNEL_LAUNCHES, splat.KERNEL_LAUNCHES):
        for name in counts:
            counts[name] = 0
