"""Time two builds of the port's CUDA kernels on the same operands.

    python -m particle3d_tpu_torch.utils.kernel_ab --baseline DIR
        [--case NAME ...] [--reps N] [--sass KERNEL]

``DIR`` holds another version's ``csrc/`` (for example an earlier commit's
``particle3d_tpu_torch/csrc``, unpacked with ``git archive``) with the same
C entry points. Each library a case needs is built from ``DIR`` with the
port's nvcc flags into a temporary directory (registers and spills
printed), and the case's wrapper is called once with the current build and
once with the baseline's swapped in for its module's ``_library``: same
wrapper, same operands. Calls are timed with CUDA events in turns
(baseline, current, current, baseline). Outputs are compared bit for bit
by default (K1: its live rows; its current dead rows must be exactly 0);
a case whose builds differ in arithmetic (K2 and K5, redesigned on tensor
cores) compares the forces instead, at ``chip_smoke.py``'s gates. A case
that fails its comparison makes the run exit with 1. One JSON line per
case: ms of each build, the speed-up, the comparison and, where the case
has one, the bound (``utils/bounds.py``; also with every operation at the
FP32 rate, the count before the tensor-core redesign).

Cases (``CASES``): K1 at 262k (particle_life_large, grid 24, cap 32),
262k cap 64, 1M (grid 40) and 8M in halo mode (the slab_8m carry on one
rank, grid 68, cap 64); K2, K3 and K4 on N=32,768 scenes (particle life
periodic and walled, Lennard-Jones on a jittered lattice); K2 at 262k
(particle_life_large_allpairs); K4 on the culled rung's worklist at 262k
(Morton-sorted particle_life_large); K5 exact and fast on the 32k particle
life scene and at 262k with its ghosts.

``--sass KERNEL`` (repeatable) prints, for each build of each case's
library and each kernel whose mangled name contains ``KERNEL``, the
instruction classes of its innermost loops that hold a MUFU or an HMMA
(the pair loops), from ``cuobjdump -sass``. Runs on the card only.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .bounds import bound, ops_mxu, ops_one_sided, ops_two_sided

# chip_smoke.py's gates for builds whose arithmetic differs: (relative L2,
# max abs as a share of max|F|), None for no gate
K2_GATE = (1e-5, 1e-4)
K5_GATE = (3e-5, 1e-4)
K5_FAST_GATE = (1e-3, None)


@dataclass
class Case:
    """One wrapper call: ``run()`` returns its output (a tensor or a
    tuple); ``pick`` the tensors to compare; ``check`` extra facts about
    the current build's output; ``gate`` None for bit equality, else
    (relative L2, max abs share) for the picked forces."""
    run: Callable
    pick: Callable = lambda out: out if isinstance(out, tuple) else (out,)
    check: Callable = lambda out: {}
    info: dict = field(default_factory=dict)
    gate: tuple | None = None


def build(module, csrc: Path, workdir: Path) -> ctypes.CDLL:
    """nvcc the library of ``module`` (its ``_LIB``) from ``csrc``."""
    from .cuda_build import NVCC_FLAGS, _nvcc

    name, sources = module._LIB
    out = workdir / f"lib{name}.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                           str(csrc / sources[0])], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{csrc / sources[0]}: build failed:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"built {out.name} from {csrc}: {len(regs)} kernels, "
          f"{min(regs)}-{max(regs)} registers, spill stores up to "
          f"{max(spills, default=0)} B", flush=True)
    return ctypes.CDLL(str(out))


def twin(cur, base: ctypes.CDLL):
    """The baseline's counterpart of what a module's ``_library()``
    returns: one configured entry point, or a library whose configured
    entry points get the same signatures."""
    if isinstance(cur, ctypes.CDLL):
        for name, f in vars(cur).items():
            if isinstance(f, cur._FuncPtr):
                g = getattr(base, name)
                g.argtypes, g.restype = f.argtypes, f.restype
        return base
    g = getattr(base, cur.__name__)
    g.argtypes, g.restype = cur.argtypes, cur.restype
    return g


def run_with(module, lib, fn):
    """``fn()`` with ``module._library`` returning ``lib``."""
    load = module._library
    module._library = lambda: lib  # noqa: E731
    try:
        return fn()
    finally:
        module._library = load


# ---------------------------------------------------------------- K1 cases


def _k1_dense(preset, cap=None):
    from ..models import make_scene
    from ..ops.celllist_dense import build_dense, sweep_operands

    st, cfg, _ = make_scene(preset, seed=0, device="cuda")
    if cap is not None:
        cfg = cfg.replace(cell_capacity=cap)
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    ds = build_dense(st, cfg, nsc, cap)
    return _k1_case(sweep_operands(ds.pos, ds, cfg, nsc, cap), cfg, nsc, cap,
                    False)


def _k1_halo(name):
    """K1 halo operands of a SLAB_RUNS carry on one rank (periodic: the
    rank's two halo planes are its own edge planes, shifted by the box)."""
    from ..models.presets import slab_run
    from ..ops.celllist_sweep import bin_sid
    from ..ops.params import r2_gate
    from ..parallel import domain_sharded as DS
    from ..parallel import init_sharded_dense, make_mesh

    n, cfg, _, kw = slab_run(name)
    mesh = make_mesh(1, device="cuda")
    nsc, cap = kw["nsc"], kw["cap"]
    data, pid, *_ = init_sharded_dense(5, n, cfg, mesh, nsc=nsc, cap=cap,
                                       migcap=kw["migcap"])
    g = DS._geometry(cfg, mesh, n, nsc, cap, None, None, None)
    cell_of = torch.arange(g.s_loc, device="cuda") // cap
    aligned = (pid >= 0) & (bin_sid(data[:, :3], cfg, nsc) == cell_of)
    r2 = torch.where(aligned, float(r2_gate(cfg)), -1.0)
    pos_d, u_d, pack = DS.slab_pack(data[:, :3], data, r2, cfg, g, 0)
    fl, fr = DS.fix_halos(pack[-nsc:], pack[:nsc], cfg, g, 0)
    ops = DS.halo_call_operands(pos_d, u_d, torch.cat([fl, pack, fr]), cfg,
                                cap)
    return _k1_case(ops, cfg, nsc, cap, True)


def live_pairs(live, nsc, cap):
    """Ordered live pairs of a periodic grid: each live slot against the
    other live slots of its 27 neighbouring supercells."""
    occ = live.reshape(nsc, nsc, nsc, cap).sum(-1).to(torch.float64)
    nbr = sum(torch.roll(occ, (dx, dy, dz), (0, 1, 2))
              for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    return float((occ * nbr).sum() - occ.sum())


def _k1_case(ops, cfg, nsc, cap, halo):
    from ..ops import celllist_sweep as S
    from ..ops.params import pack_params

    ncol = ops[0].shape[0]
    own = (ops[4][nsc:nsc + ncol] if halo else ops[4][:ncol])[:, 0, cap:]
    live = own[:, :nsc * cap] > 0
    args = (pack_params(cfg), cfg.force_law, bool(cfg.wrap_forces), nsc, cap)
    p = int(cfg.id_count)  # particle life: one feature column per species
    b = bound(live_pairs(live, nsc, cap), ops_one_sided(p, False), 0)
    return Case(
        run=lambda: S.column_sweep_forces(*ops, *args, halo=halo),
        pick=lambda out: (out.permute(0, 2, 1)[live],),
        check=lambda out: {"dead_rows_zero": bool(
            (out.permute(0, 2, 1)[~live] == 0).all())},
        info={"nsc": nsc, "cap": cap, "halo": halo, "receiver_columns": ncol,
              "live_receivers": int(live.sum()), "bound_ms": b[0],
              "bound_ms_fp32_only": b[2]})


# ----------------------------------------------------------- K2-K4 cases


def _tile_scene(label):
    """A Morton-sorted scene: N=32,768 (particle life periodic or walled,
    or Lennard-Jones on a lattice) or ``262k``, particle_life_large (the
    culled rung's scene); its positions, U, V and config."""
    from ..config import reference_config
    from ..models import make_scene
    from ..ops import allpairs_sweep as A
    from ..ops import forces as F
    from ..state import init_scene

    n = 32768
    gen = torch.Generator().manual_seed(5)
    cfg = reference_config(world_size=16.0)
    if label == "262k":
        st, cfg, _ = make_scene("particle_life_large", seed=0, device="cuda")
    elif label == "walled":
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    if label == "lj":
        cfg = cfg.replace(force_law="lennard_jones", particle_effect_radius=0.5,
                          lj_sigma=0.1, lj_epsilon=0.5)
    if label != "262k":
        st = init_scene(gen, n, cfg, "cuda")
    if label == "lj":  # a jittered 32^3 lattice of spacing 0.5
        lin = (torch.arange(32) + 0.5) * 0.5 - 8.0
        lat = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
        lat = lat.reshape(-1, 3) + 0.05 * torch.randn(n, 3, generator=gen)
        st = st.replace(positions=lat.cuda())
    st = st.replace(positions=st.positions[torch.argsort(
        A.morton_keys(st.positions, cfg.world_size), stable=True)])
    u, v = F.pair_features(st, cfg)
    return st, u, v, cfg


def _k3(label):
    from ..ops import allpairs_sweep as A

    st, u, v, cfg = _tile_scene(label)
    ops = A.rect_operands(st.positions, u, st.positions, v, cfg)
    return Case(run=lambda: A.rect_sweep(*ops))


def _k2(label):
    """K2 on a 32k scene, or at 262k on particle_life_large_allpairs;
    its forces at K2's gate."""
    from ..models import make_scene
    from ..ops import allpairs_sweep as A
    from ..ops import forces as F

    if label == "262k":
        st, cfg, _ = make_scene("particle_life_large_allpairs", seed=0,
                                device="cuda")
        u, v = F.pair_features(st, cfg)
    else:
        st, u, v, cfg = _tile_scene(label)
    ops = A.tri_operands(st.positions, u, v, cfg, A.KERNEL_TILE)
    args = (cfg.force_law, bool(cfg.wrap_forces), A.KERNEL_TILE)
    n = st.n
    b = bound(n * (n - 1) / 2, ops_two_sided(u.shape[1], bool(cfg.wrap_forces)),
              0)
    return Case(run=lambda: A.tri_sweep(*ops, *args),
                pick=lambda out: (A.tri_forces(*out)[:n],), gate=K2_GATE,
                info={"n": n, "bound_ms": b[0], "bound_ms_fp32_only": b[2]})


def _k5(label, fast):
    """K5 on the 32k particle-life scene or at 262k
    (particle_life_large_allpairs) with their recommended ghost capacity;
    its forces at K5's gate. The bound counts the live rows' pairs."""
    from ..models import make_scene
    from ..ops import allpairs_mxu_sweep as M
    from ..ops import forces as F

    if label == "262k":
        st, cfg, _ = make_scene("particle_life_large_allpairs", seed=0,
                                device="cuda")
        u, v = F.pair_features(st, cfg)
    else:
        st, u, v, cfg = _tile_scene(label)
    n = st.n
    gcap = M.recommended_ghost_capacity(cfg, n)
    ops = M.mxu_operands(st.positions, u, v, cfg, gcap, M.KERNEL_TILE)
    m = n + int(M.ghost_count(st.positions, cfg))
    b = bound(m * (m - 1) / 2, ops_mxu(u.shape[1], fast), 0)
    return Case(run=lambda: M.mxu_sweep(*ops, cfg.force_law, fast,
                                        M.KERNEL_TILE),
                pick=lambda out: (M.tri_forces(*out)[:n],),
                gate=K5_FAST_GATE if fast else K5_GATE,
                info={"n": n, "rows": ops[0].shape[0], "live_rows": m,
                      "fast": fast, "bound_ms": b[0],
                      "bound_ms_fp32_only": b[2]})


def _k4(label):
    from ..ops import allpairs_sweep as A

    st, u, v, cfg = _tile_scene(label)
    t = A.KERNEL_TILE
    ops = A.tri_operands(st.positions, u, v, cfg, t)
    np_ = ops[0].shape[0]
    mask = A.pair_survival_mask(A._pad_rows(st.positions, np_), st.n, t,
                                np_ // t, cfg)
    wi, wj = A.unpack_worklist(A.build_pair_worklist(mask, np_ // t)[0])
    args = (cfg.force_law, bool(cfg.wrap_forces), t)
    return Case(run=lambda: A.pairlist_sweep(*ops[:5], wi, wj, ops[5], *args))


# name -> (module of the wrapper, the case's builder)
CASES = {
    "k1_262k": ("celllist_sweep", lambda: _k1_dense("particle_life_large")),
    "k1_262k_cap64": ("celllist_sweep",
                      lambda: _k1_dense("particle_life_large", cap=64)),
    "k1_1m": ("celllist_sweep", lambda: _k1_dense("particle_life_1m")),
    "k1_8m_halo": ("celllist_sweep", lambda: _k1_halo("slab_8m")),
    **{f"{k}_32k_{s}": ("allpairs_sweep", lambda b=b, s=s: b(s))
       for k, b in (("k2", _k2), ("k3", _k3), ("k4", _k4))
       for s in ("particle_life", "walled", "lj")},
    "k2_262k": ("allpairs_sweep", lambda: _k2("262k")),
    "k4_262k": ("allpairs_sweep", lambda: _k4("262k")),
    **{f"k5_{n}_{m}": ("allpairs_mxu_sweep",
                       lambda n=n, f=(m == "fast"): _k5(
                           "262k" if n == "262k" else "particle_life", f))
       for n in ("32k", "262k") for m in ("exact", "fast")},
}


# ------------------------------------------------------------------ runs


def sass_loops(lib: Path, kernel: str):
    """Instruction classes of each innermost loop (a backward branch whose
    span holds no other) that holds a MUFU or an HMMA, in each function of
    ``lib`` whose mangled name contains ``kernel``."""
    from .cuda_build import _nvcc

    dump = subprocess.run([str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for part in dump.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel not in name:
            continue
        ins = [(int(a, 16), t.strip()) for a, t in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", part)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        spans = []
        for i, (a, t) in enumerate(ins):
            m = re.search(r"BRA\s+(?:`\()?0x([0-9a-f]+)", t)
            tgt = int(m.group(1), 16) if m else None
            if tgt is not None and tgt < a and tgt in at:
                spans.append((at[tgt], i))
        loops = []
        for lo, hi in spans:
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2 in spans):
                continue
            ops = [x.split()[1 if x.startswith("@") else 0].split(".")[0]
                   for _, x in ins[lo:hi + 1]]
            if "MUFU" in ops or "HMMA" in ops:
                loops.append({"instructions": len(ops), "HMMA": ops.count("HMMA"),
                              **{k: ops.count(k) for k in sorted(set(ops))}})
        found[name] = loops
    return found


def _ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def within(got, want, gate) -> dict:
    """``got`` against ``want`` at a (relative L2, max abs share) gate."""
    rel_l2, max_abs = gate
    g, w = got.double(), want.double()
    scale = float(w.abs().max())
    err = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    share = float((g - w).abs().max()) / max(scale, 1e-30)
    ok = (bool(torch.isfinite(g).all()) and 0 < scale <= 1e6
          and (rel_l2 is None or err <= rel_l2)
          and (max_abs is None or share <= max_abs))
    return {"rel_l2": err, "max_abs_of_max_f": share, "gate": gate,
            "within_gate": ok}


def compare(case: Case, module, base_lib, reps):
    cur_out = case.run()
    base_out = run_with(module, base_lib, case.run)
    torch.cuda.synchronize()
    a, b = case.pick(cur_out), case.pick(base_out)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
    if case.gate is None:
        verdict = {"passed": equal}
    else:
        verdict = within(a[0], b[0], case.gate)
        verdict["passed"] = verdict["within_gate"]
    del cur_out, base_out, a, b
    times = {"base": [], "cur": []}
    for which in ("base", "cur", "cur", "base"):
        fn = case.run if which == "cur" else (
            lambda: run_with(module, base_lib, case.run))
        times[which].append(_ms(fn, reps))
    ms_b, ms_c = np.mean(times["base"]), np.mean(times["cur"])
    check = case.check(case.run())
    rec = {**case.info, "baseline_ms": times["base"], "current_ms":
           times["cur"], "speedup": ms_b / ms_c, "outputs_bit_identical":
           equal, "max_abs_diff": diff, **verdict, **check}
    if "bound_ms" in case.info:
        rec.update(share_of_bound_current=case.info["bound_ms"] / ms_c,
                   share_of_bound_baseline=case.info["bound_ms"] / ms_b)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", required=True, type=Path,
                   help="directory with the baseline's csrc sources")
    p.add_argument("--case", action="append", choices=sorted(CASES))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--sass", metavar="KERNEL", action="append",
                   help="print the pair loops' instruction classes of the "
                        "kernels whose mangled name contains KERNEL")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device; this measurement runs on "
                         "the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from .cuda_build import library_path

    names = a.case or list(CASES)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for mod_name in dict.fromkeys(CASES[c][0] for c in names):
            module = importlib.import_module(f"..ops.{mod_name}", __package__)
            work = Path(tmp) / mod_name
            work.mkdir()
            cur = module._library()
            libs[mod_name] = (module, twin(cur, build(module, a.baseline, work)))
            if a.sass:
                for which, lib in (("baseline", work / f"lib{module._LIB[0]}.so"),
                                   ("current", library_path(*module._LIB))):
                    for k in a.sass:
                        print(json.dumps({"sass_loops": which, "library":
                                          lib.name, "kernels":
                                          sass_loops(lib, k)}), flush=True)
        for name in names:
            module, base_lib = libs[CASES[name][0]]
            case = CASES[name][1]()
            reps = max(2, a.reps // 4) if name.endswith("halo") else a.reps
            rec = compare(case, module, base_lib, reps)
            print(json.dumps({"case": name, **rec, "baseline": str(a.baseline),
                              "device": smi}), flush=True)
            if not rec["passed"]:
                failed.append(name)
            del case
            torch.cuda.empty_cache()
    if failed:
        print(f"kernel_ab: outputs differ from the baseline's beyond the "
              f"case's comparison: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
