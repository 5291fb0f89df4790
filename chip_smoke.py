#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--dof 1000000] [--scipy-dof 200000]
                          [--ell-dof 140000]

Phases (any failure exits non-zero; there is no CPU path):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from padne_tpu_torch/csrc, timed;
3. kernel K1' (sliced-ELL SpMV) against its plain PyTorch version on
   the card, on the operators of the DIA route's own set-up of the bench
   board at --dof: the level-0 f32 CG operator at R = 4 and 1, the
   level-0 bf16 cycle operator at R = 1 and 4, the level-1 bf16 cycle
   operator at R = 4 and the coarsest level's at R = 1 (random x: the
   kernel instantiations and launch shapes the solve runs); max relative
   error (bound 1e-5 of max|y|: f32 sums in another order) and ms per
   call of each, by CUDA events, and the peak device memory of the DIA
   set-up;
4. kernel K2' (compensated residual) on the level-0 hi and lo values
   against its f64 plain version, bound 2e-13 * max(|A| |x|), and both
   times;
5. the DIA route: padne_tpu_torch.solver.solve on the generated 4-layer
   bench board at --dof (sized as bench.py sizes it), with the kernels'
   launch counters reset just before and read just after: K1' and K2'
   must be > 0, the route "dia", and the full-system residual must meet
   the repo's 1e-9 gate; the peak device memory of the solve (set-up
   included) is printed;
6. a second DIA solve at --scipy-dof with the potentials held against
   scipy.sparse.linalg.spsolve on the same bordered system (max |dV|
   <= 1e-6 V);
7. kernel K3' (sliced-ELL SpMV with fused epilogues) against its plain
   version on the ELL phase's board: every level of its AMG hierarchy in
   every form, type and width the solve launches (the four sparse lines
   of the cycle per level: residual, restriction, x0 + P xc and the
   damped-Jacobi step, at R = m+1 in f32 and, as an escalated solve runs
   them, in f64; the CG's product at R = m+1 in both types; the f64
   refinement residual at R = 1), and as yardsticks A level 0 f32 and
   f64 at R = 1, x0 + A x on A level 0, and P level 0 and A level 1
   plain; bounds 1e-5 (f32) and 1e-12 (f64) of the largest of the result
   and the operands passed; times by CUDA events and by replaying a
   captured CUDA graph of 20 calls (device time without the host's
   launch cost; a kernel of this package that cannot be captured fails
   the run, cuSPARSE keeps its event time), for the kernel and for
   cuSPARSE; the cycle's sparse lines summed; for the plain f32 R = m+1
   shapes also the kernel's graph time at every lanes-per-row setting
   beside the chosen one;
8. the ELL route: the bench board at --ell-dof (n between 120,000 and
   199,999, the largest the auto route sends to ELL on the card),
   solved with counters reset: K3' > 0, K1' = K2' = 0, route "ell",
   residual < 1e-9, max |dV| vs spsolve <= 1e-6 V; the launches of K3'
   in that solve are printed per shape and form, and a shape that phase
   7 did not hold against the plain version fails the run;
9. four small generated boards through the auto route, each within
   1e-6 V of spsolve at residual < 1e-9.

Beside each kernel, the line before the last reports the least time the
card could take for the same call (bound_ms: the bytes the product
needs over 3.35 TB/s, or flops over 67 TFLOP/s f32 / 34 TFLOP/s f64,
whichever is larger; the bytes are each off-diagonal nonzero once with
its index and value(s) as the format stores them, the diagonal, x and
every epilogue operand read once and y written once, not the padding or
the slice offsets; each K1'/K2' case line also prints the format's bytes
as stored), the
same bytes bound for a CSR of the operator's nonzeros and diagonal
(csr_bound_ms), and the time of torch.sparse.mm (cuSPARSE) on that CSR
and the same inputs: f32 for K1' and K3' (a bf16 operator's values
widened; f64 for K3''s f64 cases), f64 for K2'; for K3''s residual and
x0 + A x forms the one call is torch.addmm on that CSR, the
damped-Jacobi step has no single library call.  Each case line also
says whether the kernel met its targets: no slower than cuSPARSE, and at
least half of its own bound.
The last line is {"ok": true, "device": {...}}.
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


def graph_ms(fn, calls: int = 20, replays: int = 10, library: bool = False):
    """Mean device time of fn() from replays of one captured CUDA graph
    of `calls` calls: the calls run back to back on the card with no
    host launch cost between them.  A function that cannot be captured
    raises, unless it is a library call (library=True: cuSPARSE may
    allocate or synchronise inside), which gives None."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    error = None
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(calls):
                fn()
        except RuntimeError as exc:
            error = exc
        try:
            graph.capture_end()
        except RuntimeError as exc:
            error = error or exc
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if error is not None:
        if library:
            return None
        raise RuntimeError("chip_smoke check failed: a hand-written kernel "
                           "could not be captured in a CUDA graph") from error
    return time_ms(graph.replay, reps=replays) / calls


def fmt_ms(ms) -> str:
    return "none" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, flops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time of a call that must
    move `nbytes` and do `flops` of type `kind` on this card."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sell_csr(params, values=None):
    """The operator of a sliced-ELL params dict (ops.dia.build_sell) as
    a torch CSR tensor on the card: its stored nonzeros and diagonal,
    f32 (bf16 values widened), or f64 hi + lo for the compensated
    operator (values="f64")."""
    import torch

    from padne_tpu_torch.ops import dia

    (pos_a, col_a), (pos_b, col_b) = dia.sell_entries(params)
    perm = params["perm"].long()
    np_ = perm.numel()
    diag_rows = torch.arange(np_, device=perm.device)
    if values == "f64":
        vals = [params["a_val"].double() + params["a_lo"].double(),
                params["b_val"].double() + params["b_lo"].double(),
                params["diag64"]]
    else:
        vals = [params["a_val"].float(), params["b_val"], params["diag"]]
    rows = torch.cat([perm[pos_a], perm[pos_b], diag_rows])
    cols = torch.cat([col_a, col_b, diag_rows])
    vals = torch.cat(vals)
    keep = vals != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep], (np_, np_)).coalesce()
    return coo.to_sparse_csr()


def _size(t) -> int:
    return t.numel() * t.element_size()


def sell_bytes(params, x, y, lo: bool = False) -> tuple[int, int]:
    """(needed, stored) bytes of a K1'/K2' call.  Needed: each
    off-diagonal nonzero once with its index and value(s) as the format
    stores them (part A: 2 B index; part B: 4 B column), the diagonal, x
    read once, y written once.  Stored: every array of the format as it
    lies on the card (padding, permutation and slice offsets included)
    instead of the nonzeros."""
    val_a = params["a_val"].element_size() + (4 if lo else 0)
    val_b = 4 + (4 if lo else 0)
    nz_a = int((params["a_val"] != 0).sum())
    nz_b = int((params["b_val"] != 0).sum())
    diag = params["diag64"] if lo else params["diag"]
    common = _size(diag) + _size(x) + _size(y)
    needed = (nz_a * (params["a_idx"].element_size() + val_a)
              + nz_b * (params["b_col"].element_size() + val_b) + common)
    keys = ["perm", "a_ptr", "a_idx", "a_val", "b_ptr", "b_col", "b_val"]
    keys += ["a_lo", "b_lo"] if lo else []
    return needed, sum(_size(params[k]) for k in keys) + common


def nonzeros(params) -> int:
    """Stored off-diagonal nonzeros of a sliced-ELL params dict."""
    return int((params["a_val"] != 0).sum() + (params["b_val"] != 0).sum())


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


def target_note(ms, bound_ms, library_ms) -> str:
    """Both targets for one timing: at least half the bound, and no
    slower than the library call (where there is one)."""
    met = bound_ms / ms >= 0.5 and (library_ms is None or ms <= library_ms)
    lib = ("no library call" if library_ms is None
           else f"{library_ms / ms:.2f}x cuSPARSE's time")
    return (f"{bound_ms / ms:.1%} of bound, {lib}: targets "
            f"{'met' if met else 'missed'}")


def graph_note(g_ms, bound_ms, g_lib, library_ms) -> str:
    """target_note for graph-replay times; a library call that cannot be
    captured keeps its event time."""
    if g_lib is None and library_ms is not None:
        return (target_note(g_ms, bound_ms, library_ms)
                + " (cuSPARSE not capturable: its time by events)")
    return target_note(g_ms, bound_ms, g_lib)


def k1_case(name, params, r, seed, graph=False):
    """K1' vs its plain version and cuSPARSE on one operator of the main
    path (random x).  graph: also time both by CUDA-graph replay."""
    import torch

    from padne_tpu_torch.ops import dia

    np_ = params["perm"].numel()
    dev = params["perm"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    xt = torch.randn(r, np_, generator=gen, device=dev)
    y = dia.sell_matvec(params, xt)
    ref = dia.sell_matvec_plain(params, xt)
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    ms = time_ms(lambda: dia.sell_matvec(params, xt))
    plain_ms = time_ms(lambda: dia.sell_matvec_plain(params, xt))
    nbytes, stored_bytes = sell_bytes(params, xt, y)
    nnz = nonzeros(params)
    bound_ms, bound_by = bound(nbytes, 2 * r * (nnz + np_), "f32")
    csr = sell_csr(params)
    xn = xt.T.contiguous()
    lib_err = float((torch.sparse.mm(csr, xn).T - ref).abs().max())
    library_ms = time_ms(lambda: torch.sparse.mm(csr, xn))
    csr_bound_ms = csr_bytes(csr, xn, r) / HBM_BPS * 1e3
    check(lib_err <= 1e-5 * float(ref.abs().max()),
          f"the CSR yardstick of K1' {name} computes another function")
    if graph:
        g_ms = graph_ms(lambda: dia.sell_matvec(params, xt))
        g_lib = graph_ms(lambda: torch.sparse.mm(csr, xn), library=True)
        print(f"[K1' {name}] R={r} by CUDA-graph replay: kernel "
              f"{fmt_ms(g_ms)}, library(csr) {fmt_ms(g_lib)}; "
              f"{graph_note(g_ms, bound_ms, g_lib, library_ms)}", flush=True)
    del csr, xn
    torch.cuda.empty_cache()
    stored = params["a_val"].numel() + params["b_val"].numel()
    print(f"[K1' {name}] np={np_} nnz={nnz} stored={stored} "
          f"(padding {stored / nnz:.3f}) part_a={params['a_val'].numel()} "
          f"int32_part={params['b_val'].numel()} R={r} "
          f"{str(params['a_val'].dtype).removeprefix('torch.')}: "
          f"max_rel_err={rel:.3e} max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s needed) "
          f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB needed, {stored_bytes / 1e6:.1f} MB as "
          f"stored) csr_bound {csr_bound_ms:.4f} ms "
          f"library(csr) {library_ms:.4f} ms; "
          f"{target_note(ms, bound_ms, library_ms)}", flush=True)
    check(rel <= 1e-5, f"K1' {name} disagrees with its plain version "
                       f"({rel:.3e})")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "csr_bound_ms": csr_bound_ms}


def k2_case(params, seed):
    """K2' vs its f64 plain version and cuSPARSE (f64) on the level-0
    compensated operator."""
    import torch

    from padne_tpu_torch.ops import comp

    np_ = params["perm"].numel()
    dev = params["perm"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(np_, generator=gen, device=dev) + 1.0
    y = comp.comp_sell(params, x)
    ref = comp.comp_sell_plain(params, x)
    absp = {k: v.abs() if v.is_floating_point() else v
            for k, v in params.items()}
    tol = 2e-13 * float(comp.comp_sell_plain(absp, x.abs()).max())
    del absp
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    ms = time_ms(lambda: comp.comp_sell(params, x))
    plain_ms = time_ms(lambda: comp.comp_sell_plain(params, x))
    nbytes, stored_bytes = sell_bytes(params, x, y, lo=True)
    bound_ms, bound_by = bound(nbytes, 4 * nonzeros(params) + 2 * np_,
                               "f64")
    csr = sell_csr(params, values="f64")
    x64 = x.double()[:, None]
    lib_err = float((torch.sparse.mm(csr, x64)[:, 0] - ref).abs().max())
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x64))
    csr_bound_ms = csr_bytes(csr, x64, 1) / HBM_BPS * 1e3
    check(lib_err <= tol, "the CSR yardstick of K2' computes another "
                          "function")
    del csr
    torch.cuda.empty_cache()
    print(f"[K2' l0 CG operator] np={np_} f32 hi+lo -> f64: "
          f"max_abs_err={abs_err:.3e} (bound {tol:.3e}) "
          f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s needed) "
          f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB needed, {stored_bytes / 1e6:.1f} MB as "
          f"stored) csr_bound {csr_bound_ms:.4f} ms "
          f"library(csr f64) {library_ms:.4f} ms; "
          f"{target_note(ms, bound_ms, library_ms)}", flush=True)
    check(abs_err <= tol, "K2' disagrees with its f64 plain version")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "csr_bound_ms": csr_bound_ms}


def dia_kernel_cases(system):
    """K1' and K2' on the operators the DIA route sets up for `system`,
    with the route's own defaults.  Returns (K1' cases, K2' case)."""
    import torch

    from padne_tpu_torch.ops import schur

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = schur.DiaBorderedSolver(system, device=DEV)
    torch.cuda.synchronize()
    print(f"[kernels] DIA set-up of the main path's operators "
          f"{time.perf_counter() - t0:.2f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    op, cyc = s.op_params, s.cycle_params   # cyc[-1]: the coarse inverse
    k1 = [k1_case("l0 CG operator", op, 4, 2),
          k1_case("l0 CG operator", op, 1, 1),
          k1_case("l0 cycle operator", cyc[0], 1, 3),
          k1_case("l0 cycle operator", cyc[0], 4, 6),
          k1_case("l1 cycle operator", cyc[1], 4, 4),
          k1_case(f"l{len(cyc) - 2} cycle operator", cyc[-2], 1, 7,
                  graph=True)]
    k2 = k2_case(op, 5)
    del s, op, cyc
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


LANES = (1, 2, 4, 8, 16, 32)


def k3_form(b, w, x0) -> str:
    """The name of K3''s epilogue from the operands passed."""
    if w is not None:
        return "smooth"
    if b is not None:
        return "residual"
    return "plain" if x0 is None else "add"


def k3_key(op, x, b, w, x0) -> tuple:
    """What tells one K3' launch shape of the solve from another."""
    return (op.n, op.nx, x.shape[1], str(x.dtype).removeprefix("torch."),
            k3_form(b, w, x0))


def ell_csr(cols, vals, diag, nx):
    """Host ELL arrays (and the diagonal, or None) as a scipy CSR of the
    nonzeros."""
    import numpy as np
    import scipy.sparse

    n, k = cols.shape
    a = scipy.sparse.coo_matrix(
        (vals.ravel(), (np.repeat(np.arange(n), k), cols.ravel())),
        shape=(n, nx)).tocsr()
    if diag is not None:
        a = a + scipy.sparse.diags(diag)
    a.eliminate_zeros()     # the ELL padding
    return a


def k3_case(name, ell, dtype, r, form, gen, sweep=False):
    """K3' in one form on one operator of the ELL solve against its
    plain version and against the one library call of the same function
    on a CSR of the same operator.  ell: host (cols, vals, diag or None,
    nx).  sweep: also the kernel's graph time at every lanes setting."""
    import torch

    from padne_tpu_torch.ops import spmv

    cols, vals, diag, nx = ell
    dev = torch.device(DEV)
    op = spmv.build_operator(cols, vals, diag, nx, dev, dtype)
    n, s = op.n, op.val.element_size()
    kind = "f64" if dtype == torch.float64 else "f32"
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    x = torch.randn(nx, r, generator=gen, device=dev, dtype=dtype)
    b, x0 = (torch.randn(n, r, generator=gen, device=dev, dtype=dtype)
             for _ in range(2))
    w = torch.rand(n, generator=gen, device=dev, dtype=dtype)
    # As the solve calls them: the step corrects the x it multiplies.
    kw = {"plain": {}, "residual": {"b": b}, "add": {"x0": x0},
          "smooth": {"b": b, "w": w, "x0": x}}[form]
    csr = scipy_csr(ell_csr(cols, vals, diag, nx), dtype, dev)
    library = {"plain": lambda: torch.sparse.mm(csr, x),
               "residual": lambda: torch.addmm(b, csr, x, alpha=-1.0),
               "add": lambda: torch.addmm(x0, csr, x),
               "smooth": None}[form]

    def kernel():
        return spmv.ell_spmv(op, x, **kw)

    def plain():
        return spmv.ell_spmv_plain(op, x, **kw)

    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    # The scale of the result and of the operands this form was given.
    scale = max(float(t.abs().max()) for t in (ref, *kw.values()))
    abs_err = float((y - ref).abs().max())
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    g_ms = graph_ms(kernel)
    library_ms = g_lib = None
    if library is not None:
        check(float((library() - ref).abs().max()) <= tol * scale,
              f"the CSR yardstick of K3' {name} computes another function")
        library_ms = time_ms(library)
        g_lib = graph_ms(library, library=True)
    nnz = int((op.val != 0).sum())
    # Epilogue operands: b and x0 (n, R) unless x0 is x itself, w (n,).
    extra = sum(_size(t) for t in kw.values() if t is not x)
    nbytes = (nnz * (4 + s) + (0 if diag is None else s * n) + _size(x)
              + _size(y) + extra)
    flops = (2 * nnz + (0 if diag is None else 2 * n) + len(kw) * n) * r
    bound_ms, bound_by = bound(nbytes, flops, kind)
    csr_bound_ms = (csr_bytes(csr, x, r) + extra) / HBM_BPS * 1e3
    print(f"[K3' {name} {form}] n={n} nx={nx} R={r} {kind} lanes={op.lanes} "
          f"nnz={nnz} stored={op.val.numel()} (padding "
          f"{op.val.numel() / max(nnz, 1):.3f}): "
          f"max_rel_err={abs_err / scale:.3e} max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms by events, {fmt_ms(g_ms)} by graph replay; "
          f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.2f} MB needed) csr_bound {csr_bound_ms:.4f} ms; "
          f"library(csr) {fmt_ms(library_ms)} by events, {fmt_ms(g_lib)} by "
          f"graph replay; by events {target_note(ms, bound_ms, library_ms)}; "
          f"by graph replay "
          f"{graph_note(g_ms, bound_ms, g_lib, library_ms)}",
          flush=True)
    check(abs_err <= tol * scale,
          f"K3' {name} {form} disagrees with its plain version "
          f"({abs_err / scale:.3e})")
    if sweep:
        times = []
        for lanes in LANES:
            alt = spmv.build_operator(cols, vals, diag, nx, dev, dtype,
                                      lanes=lanes)
            t = graph_ms(lambda: spmv.ell_spmv(alt, x, **kw))
            times.append(f"{lanes}: {fmt_ms(t)} (padding "
                         f"{alt.val.numel() / max(nnz, 1):.2f})")
        print(f"[K3' {name} {form}] graph replay by lanes per row (chosen "
              f"{op.lanes}): " + ", ".join(times), flush=True)
    return {"name": f"{name} {form}", "key": k3_key(op, x, **{
                "b": None, "w": None, "x0": None, **kw}),
            "abs_err": abs_err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_graph_ms": g_lib,
            "csr_bound_ms": csr_bound_ms}


def k3_cases(system):
    """K3' on the ELL phase's own operator and on every level of the AMG
    hierarchy its solve builds, in every form, type and width the solve
    launches: the CG's product and true residual, the four sparse lines
    of the cycle per level (residual, restriction, prolongation with its
    add, damped-Jacobi step) in f32 and, as after an f64 escalation, in
    f64, and the f64 refinement residual; beside them the plain products
    that only serve as yardsticks.  Prints the cycle's sparse lines
    summed by graph replay."""
    import torch

    from padne_tpu_torch.ops import amg

    gen = torch.Generator(device=torch.device(DEV)).manual_seed(5)
    r = system.border.m + 1
    f32, f64 = torch.float32, torch.float64
    levels = amg.build_hierarchy(system.ell).levels
    check(len(levels) >= 3, "the ELL board's hierarchy has under 3 levels")
    sizes = [len(lv.a_diag) for lv in levels]

    def a(i):
        return (levels[i].a_cols, levels[i].a_vals, levels[i].a_diag,
                sizes[i])

    def p(i):
        return levels[i].p_cols, levels[i].p_vals, None, sizes[i + 1]

    def rt(i):
        return levels[i].r_cols, levels[i].r_vals, None, sizes[i]

    deep = len(levels) - 2
    cases = [
        k3_case("A l0", a(0), f32, 1, "plain", gen),
        k3_case("A l0", a(0), f32, r, "plain", gen, sweep=True),
        k3_case("A l0", a(0), f64, 1, "plain", gen),
        k3_case("A l0", a(0), f64, 1, "residual", gen),
        k3_case("A l0", a(0), f64, r, "plain", gen),
        k3_case("A l0", a(0), f32, r, "add", gen),
        k3_case("P l0", p(0), f32, r, "plain", gen, sweep=True),
        k3_case("A l1", a(1), f32, r, "plain", gen, sweep=True),
    ]
    for dtype in (f32, f64):
        lines = []
        for i in range(deep + 1):
            sweep = dtype == f32 and i in (0, deep)
            lines += [
                k3_case(f"A l{i}", a(i), dtype, r, "residual", gen),
                k3_case(f"R l{i}", rt(i), dtype, r, "plain", gen,
                        sweep=sweep),
                k3_case(f"P l{i}", p(i), dtype, r, "add", gen),
                k3_case(f"A l{i}", a(i), dtype, r, "smooth", gen)]
        cases += lines
        print(f"[K3' cycle] the {len(lines)} sparse lines of one cycle over "
              f"{deep + 1} levels at R={r} "
              f"{'f64' if dtype == f64 else 'f32'}, by graph replay: "
              f"{sum(c['graph_ms'] for c in lines) * 1e3:.1f} us, by events "
              f"{sum(c['ms'] for c in lines) * 1e3:.1f} us, bound "
              f"{sum(c['bound_ms'] for c in lines) * 1e3:.1f} us", flush=True)
    return cases


class K3Shapes:
    """Counts K3''s launches by shape and form while it is entered, by
    standing in for ops.spmv's launch function (the wrapper's own count
    is untouched)."""

    def __init__(self):
        import collections

        self.counts = collections.Counter()

    def __enter__(self):
        from padne_tpu_torch.ops import spmv

        self.real = spmv._launch

        def recording(op, x, b, w, x0):
            self.counts[k3_key(op, x, b, w, x0)] += 1
            return self.real(op, x, b, w, x0)

        spmv._launch = recording
        return self.counts

    def __exit__(self, *exc):
        from padne_tpu_torch.ops import spmv

        spmv._launch = self.real


def launch_counts() -> dict:
    from padne_tpu_torch.ops import comp, dia, spmv

    return {"dia_sell": dia.sell_matvec.launches,
            "comp_sell": comp.comp_sell.launches,
            "ell_spmv": spmv.ell_spmv.launches}


def reset_counts() -> None:
    from padne_tpu_torch.ops import comp, dia, spmv

    dia.sell_matvec.launches = comp.comp_sell.launches = 0
    spmv.ell_spmv.launches = 0


def dia_phases(args, tmp: pathlib.Path):
    """K1' and K2' on the DIA route's operators at --dof, the DIA route
    at --dof, then the scipy check at --scipy-dof.  Returns (K1' cases,
    K2' case, the main solve's launch counts)."""
    import torch

    from padne_tpu_torch import solver

    t0 = time.perf_counter()
    prob, cfg = bench_problem(tmp, args.dof)
    t_load = time.perf_counter() - t0
    k1, k2 = dia_kernel_cases(solver.build_system(prob, cfg)[0])
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    sol = solver.solve(prob, mesher_config=cfg, stats=stats)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    info = sol.solver_info
    print(f"[slice] route={stats['route']} n={stats['n']} m={stats['m']} "
          f"levels={stats['levels']} load={t_load:.2f}s "
          f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
          f"setup={stats['setup_s']:.2f}s solve={stats['solve_s']:.2f}s "
          f"postproc={stats['postproc_s']:.2f}s "
          f"cg_iterations={info.cg_iterations} "
          f"refinement_passes={info.refinement_steps + 1} "
          f"residual_norm={info.residual_norm:.3e} "
          f"peak_device_memory={peak_gb:.3f} GB "
          f"launches={launches}", flush=True)
    check(stats["route"] == "dia", f"route {stats['route']} is not dia")
    for k in ("dia_sell", "comp_sell"):
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
    """K3' at the ELL phase's shapes, the ELL route at --ell-dof, and the
    small boards.  Returns (K3' cases, the ELL solve's launch counts)."""
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
    with K3Shapes() as shapes:
        sol = solver.solve(prob, mesher_config=cfg,
                           check_against_scipy=True, stats=stats)
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
    check(launches["ell_spmv"] > 0, "the ELL route never launched K3'")
    check(sum(shapes.values()) == launches["ell_spmv"],
          "the per-shape launches of K3' do not add up to its count")
    timed = {c["key"]: c["name"] for c in k3}
    for key, count in sorted(shapes.items(), key=lambda kv: -kv[1]):
        n_, nx_, r_, kind, form = key
        print(f"[K3' launches] n={n_} nx={nx_} R={r_} {kind} {form}: "
              f"{count} in the ELL solve"
              + (f" (timed above as {timed[key]})" if key in timed else ""),
              flush=True)
    for c in k3:
        c["launches"] = shapes.get(c["key"], 0)
    missing = sorted(set(shapes) - set(timed))
    check(not missing, f"the ELL solve launched K3' at shapes that were not "
                       f"held against the plain version: {missing}")
    check(launches["dia_sell"] == launches["comp_sell"] == 0,
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
        entry("dia_sell", "padne_tpu_torch/csrc/dia_sell.cu",
              "padne_tpu/ops/dia.py:802", dia_launches["dia_sell"], k1,
              k1[0]),
        entry("comp_sell", "padne_tpu_torch/csrc/dia_sell.cu",
              "padne_tpu/ops/comp.py:274", dia_launches["comp_sell"], [k2],
              k2),
        entry("ell_spmv", "padne_tpu_torch/csrc/ell_spmv.cu",
              "padne_tpu/ops/spmv_pallas.py:84, "
              "padne_tpu/ops/spmv_pallas.py:172",
              ell_launches["ell_spmv"], k3, k3[1]),
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
