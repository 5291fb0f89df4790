#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--dof 1000000] [--scipy-dof 200000]
                          [--ell-dof 140000]

Phases (any failure exits non-zero; there is no CPU path):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from padne_tpu_torch/csrc, timed;
3. kernel K1 (slab SpMV) against its plain PyTorch version on the card,
   on the operators of the DIA route's own set-up of the bench board at
   --dof: the level-0 f32 CG slab with its 8 slots at R = 1 and 4, and
   the level-1 bf16 cycle slab at R = 4 (random x); max relative error
   (bound 1e-5 of max|y|: f32 sums in another order) and ms per call of
   each, by CUDA events;
4. kernel K2 (compensated slab residual) on the same level-0 hi and lo
   slabs against its f64 plain version, bound 2e-13 * max(|A| |x|), and
   both times;
5. the DIA route: padne_tpu_torch.solver.solve on the generated 4-layer
   bench board at --dof (sized as bench.py sizes it), with the kernels'
   launch counters reset just before and read just after: K1 and K2
   must be > 0, the route "dia", and the full-system residual must meet
   the repo's 1e-9 gate;
6. a second DIA solve at --scipy-dof with the potentials held against
   scipy.sparse.linalg.spsolve on the same bordered system (max |dV|
   <= 1e-6 V);
7. kernel K3 (ELL SpMV) against its plain version at the ELL phase's
   shapes (its board's operator and the level-0 prolongation of its AMG
   hierarchy): square f32 at R = 1 and R = m+1, square f64 at R = 1,
   rectangular f32 at R = m+1; bounds 1e-5 (f32) and 1e-12 (f64) of
   max|y|, and both times;
8. the ELL route: the bench board at --ell-dof (n between 120,000 and
   199,999, the largest the auto route sends to ELL on the card),
   solved with counters reset: K3 > 0, K1 = K2 = 0, route "ell",
   residual < 1e-9, max |dV| vs spsolve <= 1e-6 V;
9. four small generated boards through the auto route, each within
   1e-6 V of spsolve at residual < 1e-9.

Beside each kernel, the line before the last reports the least time the
card could take for the same call (bound_ms: the bytes of the kernel's
operands over 3.35 TB/s, or flops over 67 TFLOP/s f32 / 34 TFLOP/s f64,
whichever is larger), the same bytes bound for a CSR of the operator's
nonzeros (csr_bound_ms: a slab stores every entry of its 128 x 128
blocks, mostly zeros), and the time of torch.sparse.mm (cuSPARSE) on
that CSR and the same inputs: f32 for K1 and K3, f64 for K2.  The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BPS = 3.35e12                                 # H100 SXM data sheet
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}         # non-tensor-core FMA
SMALL_BOARDS = ("gen_regulator", "gen_resistor_divider",
                "gen_via_stack_4layer", "gen_floating_island")
ELL_N = (120_000, 199_999)   # the sizes the auto route sends to ELL
DEV = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time of a call that must
    move `nbytes` and do `flops` of type `kind` on this card."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slab_csr(meta, w, slots=None, w_lo=None):
    """The operator of a slab (plus slot entries) as a torch CSR tensor of
    its nonzeros on the card: row rb*128 + c holds W[rb, o, k, c] at
    column (rb+o)*128 + k, f64 (W + W_lo) when w_lo is given, else f32.
    Columns sorted within each row."""
    import torch

    np_, b, g, ng, offs = meta
    nb, d = np_ // b, len(offs)
    dev = w.device
    dtype = torch.float64 if w_lo is not None else torch.float32
    wb = w.reshape(nb, d, b, b).to(dtype)
    if w_lo is not None:
        wb = wb + w_lo.reshape(nb, d, b, b).to(dtype)
    rb = torch.arange(nb, device=dev)[:, None]
    cb = rb + torch.tensor(offs, device=dev)[None, :]
    valid = (cb >= 0) & (cb < nb)
    cb = torch.where(valid, cb, rb)
    vals = (wb * valid[:, :, None, None]).permute(0, 3, 1, 2)  # rb c o k
    lane = torch.arange(b, device=dev, dtype=torch.int32)
    cols = (cb.to(torch.int32)[:, None, :, None] * b + lane).expand(
        nb, b, d, b)
    vals, cols = vals.reshape(np_, d * b), cols.reshape(np_, d * b)
    del wb
    if slots is not None:
        tgt, ci, we = slots
        e = we.shape[1]
        scol = tgt.reshape(nb, e, 1) * b + ci                  # rb e c
        cols = torch.cat([cols, scol.permute(0, 2, 1).reshape(np_, e)], 1)
        vals = torch.cat([vals, we.to(dtype).permute(0, 2, 1).reshape(
            np_, e)], 1)
    cols, order = cols.sort(dim=1)
    vals = torch.gather(vals, 1, order)
    del order
    keep = vals != 0
    crow = torch.zeros(np_ + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), cols[keep],
                                   vals[keep], size=(np_, np_))


def scipy_csr(a, dtype, dev):
    """A scipy CSR matrix as a torch CSR tensor on the card."""
    import torch

    a = a.tocoo().tocsr()     # canonical: sorted columns, no duplicates
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype("int32")),
        torch.from_numpy(a.indices.astype("int32")),
        torch.from_numpy(a.data), size=a.shape).to(device=dev, dtype=dtype)


def csr_bytes(csr, x, y_cols: int) -> int:
    """Bytes a CSR product must move: indices, values, row pointers, x
    read once, y (rows x y_cols in x's dtype) written once."""
    nnz = csr.values().numel()
    s = x.element_size()
    return (nnz * (csr.col_indices().element_size()
                   + csr.values().element_size())
            + csr.crow_indices().numel() * 4 + x.numel() * s
            + csr.shape[0] * y_cols * s)


def k1_case(name, meta, w, slots, r, seed, library=False):
    """K1 vs its plain version on one slab of the main path (random x)."""
    import torch

    from padne_tpu_torch.ops import dia

    np_, offs = meta[0], meta[4]
    nb = np_ // 128
    gen = torch.Generator(device=w.device).manual_seed(seed)
    xt = torch.randn(r, np_, generator=gen, device=w.device)
    y = dia.slab_matvec(meta, w, xt, slots)
    ref = dia.slab_matvec_plain(meta, w, xt, slots)
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    ms = time_ms(lambda: dia.slab_matvec(meta, w, xt, slots))
    plain_ms = time_ms(lambda: dia.slab_matvec_plain(meta, w, xt, slots))
    gbytes = w.numel() * w.element_size() / 1e9
    e = slots[2].shape[1] if slots is not None else 0
    nslot = nb * e * 128
    bound_ms, bound_by = bound(
        w.numel() * w.element_size() + 2 * xt.numel() * 4
        + nslot * 8 + nb * e * 4, 2 * r * (w.numel() + nslot), "f32")
    library_ms = csr_bound_ms = None
    if library:
        csr = slab_csr(meta, w, slots)
        xn = xt.T.contiguous()
        lib_err = float((torch.sparse.mm(csr, xn).T - ref).abs().max())
        library_ms = time_ms(lambda: torch.sparse.mm(csr, xn))
        csr_bound_ms = csr_bytes(csr, xn, r) / HBM_BPS * 1e3
        nnz = csr.values().numel()
        check(lib_err <= 1e-5 * float(ref.abs().max()),
              f"the CSR yardstick of K1 {name} computes another function")
        del csr, xn
        torch.cuda.empty_cache()
    print(f"[K1 {name}] np={np_} D={len(offs)} dmax={max(map(abs, offs))} "
          f"R={r} E={e} {str(w.dtype).removeprefix('torch.')}: "
          f"max_rel_err={rel:.3e} max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms ({gbytes / ms * 1e3:.0f} GB/s slab stream) "
          f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
          f"library(csr) {library_ms} ms"
          + (f" csr nnz {nnz} ({nnz / (np_ * (len(offs) * 128 + e)):.4f} "
             f"of the slab's entries) csr_bound {csr_bound_ms:.4f} ms"
             if library else ""), flush=True)
    check(rel <= 1e-5, f"K1 {name} disagrees with its plain version "
                       f"({rel:.3e})")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "csr_bound_ms": csr_bound_ms}


def k2_case(meta, w, w_lo, seed):
    """K2 vs its f64 plain version on the level-0 hi and lo slabs."""
    import torch

    from padne_tpu_torch.ops import comp

    np_, offs = meta[0], meta[4]
    gen = torch.Generator(device=w.device).manual_seed(seed)
    x = torch.randn(np_, generator=gen, device=w.device) + 1.0
    y = comp.comp_slab(meta, w, w_lo, x)
    ref = comp.comp_slab_plain(meta, w, w_lo, x)
    tol = 2e-13 * float(
        comp.comp_slab_plain(meta, w.abs(), w_lo.abs(), x.abs()).max())
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    ms = time_ms(lambda: comp.comp_slab(meta, w, w_lo, x))
    plain_ms = time_ms(lambda: comp.comp_slab_plain(meta, w, w_lo, x))
    bound_ms, bound_by = bound(2 * w.numel() * 4 + np_ * (4 + 8),
                               4 * w.numel(), "f64")
    csr = slab_csr(meta, w, w_lo=w_lo)
    x64 = x.double()[:, None]
    lib_err = float((torch.sparse.mm(csr, x64)[:, 0] - ref).abs().max())
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x64))
    csr_bound_ms = csr_bytes(csr, x64, 1) / HBM_BPS * 1e3
    check(lib_err <= tol, "the CSR yardstick of K2 computes another function")
    del csr
    torch.cuda.empty_cache()
    print(f"[K2 l0] np={np_} D={len(offs)} f32 hi+lo -> f64: "
          f"max_abs_err={abs_err:.3e} (bound {tol:.3e}) "
          f"kernel {ms:.4f} ms ({2 * w.numel() * 4 / ms / 1e6:.0f} GB/s "
          f"slab streams) plain(f64 bmm) {plain_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}) "
          f"library(csr f64) {library_ms:.4f} ms "
          f"csr_bound {csr_bound_ms:.4f} ms", flush=True)
    check(abs_err <= tol, "K2 disagrees with its f64 plain version")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "csr_bound_ms": csr_bound_ms}


def dia_kernel_cases(system):
    """K1 and K2 on the slabs the DIA route sets up for `system`, with
    the route's own defaults.  Returns (K1 cases, K2 case)."""
    import torch

    from padne_tpu_torch.ops import dia, schur

    t0 = time.perf_counter()
    s = schur.DiaBorderedSolver(system, device=DEV)
    print(f"[kernels] DIA set-up of the main path's operators "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    levels = s.hierarchy.levels
    meta0 = levels[0].pack.meta
    slots = dia._slots(s.op_params)
    w0 = s.op_params["w"]
    k1 = [k1_case("l0 CG operator", meta0, w0, slots, 1, 1),
          k1_case("l0 CG operator", meta0, w0, slots, 4, 2, library=True),
          k1_case("l1 cycle slab", levels[1].pack.meta,
                  s.cycle_params[1]["w"], None, 4, 3)]
    k2 = k2_case(meta0, w0, s._comp.params["w_lo"], 4)
    del s
    torch.cuda.empty_cache()
    return k1, k2


def check_fields(sol, n: int) -> None:
    """Finite per-layer fields of the expected shapes, and the 1 V source
    across the stack visible in the potential range."""
    import numpy as np

    check(len(sol.layer_solutions) == 4, "expected 4 copper layers")
    lo, hi, n_vals = np.inf, -np.inf, 0
    for layer in sol.layer_solutions:
        check(len(layer.potentials) >= 1, "a layer without potentials")
        for pot, pd in zip(layer.potentials, layer.power_densities):
            check(pot.values.shape == (pot.mesh.num_vertices,)
                  and pd.values.shape == (pd.mesh.num_faces,),
                  "field shapes do not match their meshes")
            check(np.isfinite(pot.values).all()
                  and np.isfinite(pd.values).all(),
                  "non-finite potentials or power densities")
            lo = min(lo, float(pot.values.min()))
            hi = max(hi, float(pot.values.max()))
            n_vals += len(pot.values)
    check(0.9 * n < n_vals <= n, "potentials do not cover the mesh")
    check(1.0 - 1e-6 <= hi - lo < 1.5,
          f"potential range {hi - lo:.6f} V is not that of a 1 V source")


def boardgen():
    """tests/boardgen.py, loaded by file path: an installed top-level
    `tests` package would shadow the repository's (namespace) tests
    directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "boardgen", REPO / "tests" / "boardgen.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_problem(tmp: pathlib.Path, dof: int):
    """The generated 4-layer bench board and a mesher config for `dof`
    (vertices ~ area / (0.43 size^2), as bench.py sizes it)."""
    from padne_tpu_torch import kicad, mesh

    prob = kicad.load_kicad_project(boardgen().gen_bench_4layer(tmp))
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * dof)) ** 0.5)
    return prob, mesh.Mesher.Config(maximum_size=size,
                                    variable_size_maximum_factor=1.0)


def k3_case(name, cols, vals, diag, x, csr, tol):
    """K3 against its plain version and against torch.sparse.mm on the
    CSR tensor of the same operator, on the card."""
    import torch

    from padne_tpu_torch.ops import spmv

    if diag is None:
        def kernel():
            return spmv.ell_rect_spmv(cols, vals, x)

        def plain():
            return spmv.ell_rect_spmv_plain(cols, vals, x)
    else:
        def kernel():
            return spmv.ell_spmv(cols, vals, diag, x)

        def plain():
            return spmv.ell_spmv_plain(cols, vals, diag, x)
    y, ref = kernel(), plain()
    lib = torch.sparse.mm(csr, x)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    abs_err = float((y - ref).abs().max())
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    k, n = cols.shape
    s = x.element_size()
    kind = "f64" if x.dtype == torch.float64 else "f32"
    r = x.shape[1]
    bound_ms, bound_by = bound(
        (4 + s) * k * n + (0 if diag is None else s * n) + s * x.numel()
        + s * n * r, 2 * k * n * r + (0 if diag is None else 2 * n * r),
        kind)
    csr_bound_ms = csr_bytes(csr, x, r) / HBM_BPS * 1e3
    print(f"[K3 {name}] n={n} nx={x.shape[0]} K={k} R={r} {kind}: "
          f"max_rel_err={abs_err / scale:.3e} max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}) "
          f"library(csr) {library_ms:.4f} ms "
          f"csr_bound {csr_bound_ms:.4f} ms", flush=True)
    check(abs_err <= tol * scale,
          f"K3 {name} disagrees with its plain version "
          f"({abs_err / scale:.3e})")
    check(float((lib - ref).abs().max()) <= 1e-5 * scale,
          f"the CSR yardstick of K3 {name} computes another function")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "csr_bound_ms": csr_bound_ms}


def k3_cases(system):
    """K3 at the ELL phase's shapes, on its own operator: the square
    form at R = 1 and m+1 (f32) and R = 1 (f64, the full residual), and
    the level-0 prolongation of its AMG hierarchy at R = m+1."""
    import numpy as np
    import scipy.sparse
    import torch

    from padne_tpu_torch.ops import amg, spmv

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(5)
    n, r = system.n, system.border.m + 1
    a = system.ell.to_scipy()
    out = []
    for dtype, nrhs, tol in ((torch.float32, 1, 1e-5),
                             (torch.float32, r, 1e-5),
                             (torch.float64, 1, 1e-12)):
        cols, vals, diag = system.ell.to_device(dev, dtype)
        x = torch.randn(n, nrhs, generator=gen, device=dev, dtype=dtype)
        out.append(k3_case(f"A {str(dtype)[6:]}", cols, vals, diag, x,
                           scipy_csr(a, dtype, dev), tol))
    lv = amg.build_hierarchy(system.ell).levels[0]
    nf, kp = lv.p_cols.shape
    p_csr = scipy.sparse.coo_matrix(
        (lv.p_vals.ravel(), (np.repeat(np.arange(nf), kp),
                             lv.p_cols.ravel())),
        shape=(nf, len(lv.r_cols))).tocsr()
    p_csr.eliminate_zeros()   # the ELL padding
    cols, vals = spmv.to_kmajor(lv.p_cols, lv.p_vals, dev, torch.float32)
    x = torch.randn(len(lv.r_cols), r, generator=gen, device=dev)
    out.append(k3_case("P f32", cols, vals, None, x,
                       scipy_csr(p_csr, torch.float32, dev), 1e-5))
    return out


def launch_counts() -> dict:
    from padne_tpu_torch.ops import comp, dia, spmv

    return {"dia_slab": dia.slab_matvec.launches,
            "comp_slab": comp.comp_slab.launches,
            "ell_spmv": spmv.ell_spmv.launches,
            "ell_rect_spmv": spmv.ell_rect_spmv.launches}


def reset_counts() -> None:
    from padne_tpu_torch.ops import comp, dia, spmv

    dia.slab_matvec.launches = comp.comp_slab.launches = 0
    spmv.ell_spmv.launches = spmv.ell_rect_spmv.launches = 0


def dia_phases(args, tmp: pathlib.Path):
    """K1 and K2 on the DIA route's operators at --dof, the DIA route at
    --dof, then the scipy check at --scipy-dof.  Returns (K1 cases, K2
    case, the main solve's launch counts)."""
    import torch

    from padne_tpu_torch import solver

    t0 = time.perf_counter()
    prob, cfg = bench_problem(tmp, args.dof)
    t_load = time.perf_counter() - t0
    k1, k2 = dia_kernel_cases(solver.build_system(prob, cfg)[0])
    torch.cuda.empty_cache()

    reset_counts()
    stats = {}
    sol = solver.solve(prob, mesher_config=cfg, stats=stats)
    launches = launch_counts()
    info = sol.solver_info
    print(f"[slice] route={stats['route']} n={stats['n']} m={stats['m']} "
          f"levels={stats['levels']} load={t_load:.2f}s "
          f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
          f"setup={stats['setup_s']:.2f}s solve={stats['solve_s']:.2f}s "
          f"postproc={stats['postproc_s']:.2f}s "
          f"cg_iterations={info.cg_iterations} "
          f"refinement_passes={info.refinement_steps + 1} "
          f"residual_norm={info.residual_norm:.3e} "
          f"launches={launches}", flush=True)
    check(stats["route"] == "dia", f"route {stats['route']} is not dia")
    for k in ("dia_slab", "comp_slab"):
        check(launches[k] > 0, f"the slice never launched {k}")
    check(info.residual_norm < 1e-9,
          f"residual {info.residual_norm:.3e} misses the 1e-9 gate")
    check_fields(sol, stats["n"])
    del sol

    prob, cfg = bench_problem(tmp / "scipy", args.scipy_dof)
    stats2 = {}
    sol = solver.solve(prob, mesher_config=cfg, check_against_scipy=True,
                       stats=stats2)
    dv = stats2["scipy_max_dv"]
    print(f"[scipy] route={stats2['route']} n={stats2['n']} "
          f"solve={stats2['solve_s']:.2f}s "
          f"residual_norm={sol.solver_info.residual_norm:.3e} "
          f"max|dV| vs spsolve={dv:.3e} V", flush=True)
    check(stats2["route"] == "dia", "the scipy check did not take the DIA "
                                    "route")
    check(dv <= 1e-6, f"max |dV| {dv:.3e} V vs scipy exceeds 1e-6 V")
    check_fields(sol, stats2["n"])
    check(sol.solver_info.residual_norm < 1e-9,
          "scipy-check solve misses the 1e-9 gate")
    return k1, k2, launches


def ell_phases(args, tmp: pathlib.Path):
    """K3 at the ELL phase's shapes, the ELL route at --ell-dof, and the
    small boards.  Returns (K3 cases, the ELL solve's launch counts)."""
    import torch

    from padne_tpu_torch import kicad, solver

    t0 = time.perf_counter()
    prob, cfg = bench_problem(tmp / "ell", args.ell_dof)
    t_load = time.perf_counter() - t0
    system = solver.build_system(prob, cfg)[0]
    check(ELL_N[0] <= system.n <= ELL_N[1],
          f"--ell-dof {args.ell_dof} gave n={system.n}, outside the ELL "
          f"range {ELL_N}")
    k3 = k3_cases(system)
    del system
    torch.cuda.empty_cache()

    reset_counts()
    stats = {}
    sol = solver.solve(prob, mesher_config=cfg, check_against_scipy=True,
                       stats=stats)
    launches = launch_counts()
    info = sol.solver_info
    dv = stats["scipy_max_dv"]
    print(f"[ell] route={stats['route']} n={stats['n']} m={stats['m']} "
          f"levels={stats['levels']} ell_k={stats['ell_k']} "
          f"load={t_load:.2f}s "
          f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
          f"setup={stats['setup_s']:.2f}s solve={stats['solve_s']:.2f}s "
          f"postproc={stats['postproc_s']:.2f}s "
          f"cg_iterations={info.cg_iterations} "
          f"refinement_passes={info.refinement_steps + 1} "
          f"escalated={stats['escalated']} "
          f"residual_norm={info.residual_norm:.3e} "
          f"max|dV| vs spsolve={dv:.3e} V launches={launches}", flush=True)
    check(stats["route"] == "ell", f"route {stats['route']} is not ell")
    check(launches["ell_spmv"] > 0 and launches["ell_rect_spmv"] > 0,
          "the ELL route never launched K3")
    check(launches["dia_slab"] == launches["comp_slab"] == 0,
          "the ELL route launched a DIA kernel")
    check(info.residual_norm < 1e-9,
          f"residual {info.residual_norm:.3e} misses the 1e-9 gate")
    check(dv <= 1e-6, f"ELL max |dV| {dv:.3e} V vs scipy exceeds 1e-6 V")
    check_fields(sol, stats["n"])
    del sol

    gen = boardgen()
    for name in SMALL_BOARDS:
        getattr(gen, name)(tmp)
        prob = kicad.load_kicad_project(tmp / name / f"{name}.kicad_pro")
        st = {}
        sol = solver.solve(prob, check_against_scipy=True, stats=st)
        res = sol.solver_info.residual_norm
        disconnected = sum(len(l.disconnected_meshes)
                           for l in sol.layer_solutions)
        print(f"[board {name}] route={st['route']} n={st['n']} m={st['m']} "
              f"cg_iterations={sol.solver_info.cg_iterations} "
              f"escalated={st.get('escalated')} residual_norm={res:.3e} "
              f"max|dV| vs spsolve={st['scipy_max_dv']:.3e} V "
              f"disconnected_meshes={disconnected}", flush=True)
        check(res < 1e-9, f"{name}: residual {res:.3e} misses the gate")
        check(st["scipy_max_dv"] <= 1e-6, f"{name}: max |dV| vs scipy")
        if name == "gen_floating_island":
            check(disconnected == 1, "the floating island did not reach "
                                     "the display meshes")
    return k3, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=1_000_000)
    ap.add_argument("--scipy-dof", type=int, default=200_000)
    ap.add_argument("--ell-dof", type=int, default=140_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    from padne_tpu_torch import device, kernels

    device.resolve(None)   # TF32 off, CUDA required
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    from padne_tpu_torch import geom  # noqa: F401  builds the C++ core (g++)
    print(f"[setup] host geometry core ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        k1, k2, dia_launches = dia_phases(args, pathlib.Path(tmp))
        torch.cuda.empty_cache()
        k3, ell_launches = ell_phases(args, pathlib.Path(tmp))

    def entry(name, source, replaces, launches, cases, main_case):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["abs_err"] for c in cases),
                **{key: main_case[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "csr_bound_ms")}}

    kernels_line = {"kernels": [
        entry("dia_slab", "padne_tpu_torch/csrc/dia_slab.cu",
              "padne_tpu/ops/dia.py:802", dia_launches["dia_slab"], k1,
              k1[1]),
        entry("comp_slab", "padne_tpu_torch/csrc/comp_slab.cu",
              "padne_tpu/ops/comp.py:274", dia_launches["comp_slab"], [k2],
              k2),
        entry("ell_spmv", "padne_tpu_torch/csrc/ell_spmv.cu",
              "padne_tpu/ops/spmv_pallas.py:84, "
              "padne_tpu/ops/spmv_pallas.py:172",
              ell_launches["ell_spmv"] + ell_launches["ell_rect_spmv"], k3,
              k3[1]),
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
