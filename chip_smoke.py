#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--dof 1000000] [--scipy-dof 200000]
                          [--ell-dof 140000] [--frag-dof 200000]

Phases (any failure exits non-zero; there is no CPU path):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from padne_tpu_torch/csrc, timed;
3. kernel K1' (sliced-ELL SpMV) against its plain PyTorch version on
   the card, on the operators of the DIA route's own set-up of the bench
   board at --dof: the level-0 f32 CG operator and every sparse level's
   bf16 cycle operator, each at R = m + 1 (the first solve) and at R = 1
   (the refinement passes): random x at every launch shape, and so
   every kernel instantiation, of the solve; max relative
   error (bound 1e-5 of max|y|: f32 sums in another order) and ms per
   call of each, by CUDA events and by replaying a captured CUDA graph
   of 20 calls (the card's time without the host's launch cost), and
   the peak device memory of the DIA set-up;
4. kernel K2' (compensated residual) on the level-0 hi and lo values
   against its f64 plain version, bound 2e-13 * max(|A| |x|), and both
   times, by CUDA events and by graph replay;
5. the user path on the DIA route ("cli"): padne_tpu_torch.cli.main
   (["solve", project, artifact, mesher flags]) in this process, with no
   --device (so: the card), on the generated 4-layer bench board at
   --dof (sized as bench.py sizes it), with the kernels' launch counters
   reset just before and read just after: K1' and K2' must be > 0, the
   route "dia", and the full-system residual must meet the repo's 1e-9
   gate; the launches of K1' and K2' in that solve are printed per
   shape (rows, value type, R), and a shape that phases 3 and 4 did not
   hold against the plain version fails the run; the peak device memory of the solve (set-up included) is
   printed; then `info`, `paraview` and `html` on the artifact: the
   reloaded potentials equal the solved ones bit for bit, every layer's
   VTU file and the HTML page exist and parse;
6. a second DIA solve at --scipy-dof with the potentials held against
   scipy.sparse.linalg.spsolve on the same bordered system (max |dV|
   <= 1e-6 V), its operators' K1' and K2' shapes held and checked as in
   phases 3 to 5;
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
   1e-6 V of spsolve at residual < 1e-9;
9b. the sharded solve ("sharded") over 4 shards of the one card
   (parallel.sharding.Mesh naming cuda:0 four times; shards sharing a
   card measure the decomposition's cost, not multi-card scaling):
   schur.DiaBorderedSolver(mesh=) on phase 5's assembled system (not
   meshed again), which must shard with at least 2 sharded levels;
   K1' on every shard's f32 CG operator and every sharded level's
   cycle operator over its halo window (rows, nx, x0), at R = m + 1
   and R = 1, on the one-device tail levels, and K2' on every shard,
   each against its plain version (the first shard of each shape also
   timed, by events and graph replay, with its bound and cuSPARSE on
   the shard's CSR over the same window); the solve with counters
   reset: residual <= 1e-9, potentials within 1e-6 * max(span, 1) V of
   phase 5's and border currents within 1e-6 of the largest, every
   launched K1'/K2' shape held.  Then solve_bordered(mesh=) on phase
   8's ELL board: K3' at the shard shapes (first shard) held, residual
   <= 1e-9, |dV| <= 1e-7 * span against phase 8; then `solve --tp N`
   for N beyond the card count ends in the `exceeds the K available
   device(s)` error.  Set-up and solve seconds beside phase 5's, CG
   iterations, passes, launches, peak device memory and the bytes of
   halo and far exchange per matvec are printed;
9b'. the solver options ("variants"), on phase 5's assembled system
   (not meshed again): one schur.DiaBorderedSolver per setting of
   VARIANTS (the defaults; cheb=3; cheb_deep=3; smooth_steps=2;
   cycle_lumped=False; coarse="device"; w_levels=0), each solved once to
   the 1e-10 target: residual <= 1e-9, potentials within 1e-7 x span of
   phase 5's, every launched K1'/K2' shape held against its plain
   version (level 0's exact bf16 cycle operator of cycle_lumped=False
   also timed), where the coarse inverse was built ("host (validation)"
   only when the device's failed its check); set-up and solve seconds,
   CG iterations, passes, residual, K1' launches and the device events
   and kernel ms per CG iteration (the solver's CG run to 10 and to 30
   iterations under the profiler, the difference over 20) printed per
   setting.
   Then solve_bordered(precond="jacobi") on the smallest of the four
   small boards above 5,000 unknowns at a 0.15 mm mesh (each K3' shape
   it launched held and timed, within 1e-6 V of spsolve), and
   solve_bordered(dia_shard_min=512) on phase 6's system over phase
   9b's mesh (at least 2 sharded levels, every K1'/K2' shape held,
   within 1e-7 x span of phase 6's solve);
9c. the dp x tp layout ("dp_tp"), on a parallel.sharding.Mesh of 8
   entries naming cuda:0, dp 2 x tp 4.  Part A, the standalone solvers
   on phase 5's system (not meshed again): batched_sharded_cg of 4
   conductance scales 1 + 0.5 b, R = 2 balanced source/sink columns
   each, f64, 200 iterations; sharded_cg of the scale-1 system on the 4
   shards of one dp row; no synchronizing call inside either loop
   (torch.cuda.set_sync_debug_mode("error")); K3' exactly once per
   iteration, shard and system, held against its plain version at the
   shard's and the whole operator's shape (the first timed by events
   and graph replay, with its bound and cuSPARSE on the same CSR); each
   system within 1e-9 of max|x| of sharded_cg on one device after 50
   iterations (DP_TP_CHECK_ITERS: later the runs part by CG's own
   rounding), and after 200 its |b - A x| / |b| within DP_TP_RES_SPREAD
   of the one-device run's after 200.  Printed: set-up seconds, wall
   ms, K3' launches and device events per iteration (profiler), host us
   per device event, busy share, |b - A x| / |b| of each system beside
   the one-device run's, the distance from one device after 50 and
   after 200 iterations, peak device memory.  Part B, the DIA
   production path's replicas: phase 6's system at conductance scales 1
   and 2, each a DiaBorderedSolver over its own dp row of 4 shards,
   residual < 1e-9 and within 1e-9 V of the one-device solve of its own
   scaled system, every K1'/K2' shape launched held;
10. a heavily fragmented board ("fragmented"): one copper layer cut into
   12 x 12 separate tiles and a rail, every tile held against the rail
   by its own voltage source and loaded by its own current source, at
   --frag-dof: more than 63 copper components on the DIA route (the
   segment-sum projector in the (R, N) layout).  K1' on its CG operator
   and on every sparse level of its cycle, at R = m + 1 and at R = 1,
   and K2' against their plain versions; then the solve with counters
   reset: route "dia", residual < 1e-9, max |dV| vs spsolve <= 1e-6 V,
   K1' and K2' > 0, and no launched shape that was not held;
11. a design sweep ("sweep"): padne_tpu_torch.sweep.solve_sweep on the
   ELL phase's board with 12 specs (conductance scale 0.5, 1, 2, 4 x
   source scale 1, 2, 3.3): one float64 multi-RHS CG for all of them,
   every product through K3' (launches printed by shape; a shape that
   phase 7 did not hold against the plain version fails the run); every
   spec's residual below 1e-8 of its right-hand side's norm, the spec
   (1, 1) within 1e-6 V of phase 8's single solve, the potentials
   proportional to the source scale and of the form v_V + v_I / s in the
   conductance scale; CG iterations, wall times of the one multi-RHS
   solve and of the 12 recoveries, and peak device memory are printed;
12. the resident solve server ("serve"): a cold `python -m
   padne_tpu_torch solve` of phase 6's project (--scipy-dof, still above
   the server's 200,000-unknown dispatch) with phase 6's mesher flags
   in a fresh process, with no server on the socket; then
   padne_tpu_torch.serve.serve on the card as a thread of this process
   (its launches counted from 0 and held by shape as in phase 5),
   `solve` and `gui` of the same project through it, each in a fresh
   process (`gui` writes padne_tpu_view.html without a display), `show`
   on the served artifact, and in this process serve.client_solve of
   phase 6's system, then of the same system with its excitation
   doubled; the server shut down.  Checks: the cold and served
   artifacts' potentials equal to phase 6's bit for bit (the same code,
   board and card), at residual < 1e-9; the server
   answered all four requests and both client processes report a
   served solve; the first request pays the set-up, the repeats report
   setup_seconds 0; K1' and K2' launched in the server at held shapes
   only, K3' not; the doubled solve within 2e-6 V of twice the first
   and within 1e-6 V of spsolve; both HTML pages parse and hold the
   solved meshes.  The wall time of each client process, the server's
   set-up and solve seconds per request and its peak device memory are
   printed;
13. repeats ("repeat"): a solve on the card is a function of its inputs.
   Run inside the phases whose systems and solvers it reuses (no board
   is meshed for it), each with CG iterations, passes, residual and the
   SHA-256 of the potentials printed, and all of these and every result
   array equal across the runs (np.array_equal, no tolerance): phase
   cli's board from a second set-up, solved 3 times (a solver's first
   solve also computes A^+ C and later ones reuse it, as in the JAX
   package, so the first is held against phase cli's solve and the
   other two against each other); phase 6's board from a second set-up
   against phase 6's solve; 5 more solves of phase 8's
   ELL board, each with its set-up, against phase 8's; the 12-spec sweep
   twice; the sharded DIA solver twice more; batched_sharded_cg's first
   call against its profiled second.  Beside them, the device time of
   the DIA route's fixed-order sums (Z^T r, B X, C j, the sharded
   projector's component sums) and of the ELL route's Z^T r against the
   atomic scatters they replaced, on the same operands, by CUDA events
   and graph replay.

Each of the phases cli, sharded, variants, dp_tp, fragmented, sweep,
serve and repeat also prints one JSON line {"phase": ...} with its
numbers.

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
MIN_FRAG_N = 200_000         # the fragmented board: the DIA route's sizes
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
    diag_cols = diag_rows + params["x0"]
    if values == "f64":
        vals = [params["a_val"].double() + params["a_lo"].double(),
                params["b_val"].double() + params["b_lo"].double(),
                params["diag64"]]
    else:
        vals = [params["a_val"].float(), params["b_val"], params["diag"]]
    rows = torch.cat([perm[pos_a], perm[pos_b], diag_rows])
    cols = torch.cat([col_a, col_b, diag_cols])
    vals = torch.cat(vals)
    keep = vals != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                  vals[keep],
                                  (np_, params["nx"])).coalesce()
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


def x_bytes(cols, x) -> int:
    """Bytes of x (nx, ...) that a product must read: each row that a
    nonzero's column names, once.  A shard's operator over the gathered
    x reads its own columns, its halo and its far columns, not all nx."""
    import torch

    return (int(torch.unique(cols).numel()) * (x.numel() // x.shape[0])
            * x.element_size())


def csr_bytes(csr, x, y_cols: int) -> int:
    """Bytes a CSR product must move: indices, values, row pointers, the
    rows of x its columns name read once, y (rows x y_cols in x's dtype)
    written once."""
    nnz = csr.values().numel()
    s = x.element_size()
    return (nnz * (csr.col_indices().element_size()
                   + csr.values().element_size())
            + csr.crow_indices().numel() * 4 + x_bytes(csr.col_indices(), x)
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


def k1_key(params, xt) -> tuple:
    """What tells one K1' launch shape from another: the rows, the
    window of x (nx columns, row 0's at x0), the type of the stored
    offset values and the width, which together pick the kernel's
    instantiation and its grid."""
    return ("K1'", params["perm"].numel(), params["nx"], params["x0"],
            str(params["a_val"].dtype).removeprefix("torch."), xt.shape[0])


def k2_key(params, x) -> tuple:
    return ("K2'", params["perm"].numel(), params["nx"], params["x0"])


def shape_text(key) -> str:
    """A K1' or K2' launch shape as printed."""
    text = f"np={key[1]}"
    if key[2:4] != (key[1], 0):
        text += f" nx={key[2]} x0={key[3]}"
    return text + (f" {key[4]} R={key[5]}" if key[0] == "K1'" else "")


def k1_case(name, params, r, seed, timed: bool = True):
    """K1' vs its plain version and cuSPARSE on one operator of the main
    path (random x), timed by CUDA events and by CUDA-graph replay
    (timed=False: the comparison with the plain version only)."""
    import torch

    from padne_tpu_torch.ops import dia

    np_, nx = params["perm"].numel(), params["nx"]
    dev = params["perm"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    xt = torch.randn(r, nx, generator=gen, device=dev)
    y = dia.sell_matvec(params, xt)
    ref = dia.sell_matvec_plain(params, xt)
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    check(rel <= 1e-5, f"K1' {name} disagrees with its plain version "
                       f"({rel:.3e})")
    if not timed:
        print(f"[K1' {name}] {shape_text(k1_key(params, xt))}: "
              f"max_rel_err={rel:.3e} max_abs_err={abs_err:.3e}", flush=True)
        return {"key": k1_key(params, xt), "name": f"{name} R={r}",
                "abs_err": abs_err}
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
    # Most K1' calls are shorter than the host's launch interval, which
    # events then read: graph replay reads the card's own time.
    g_ms = graph_ms(lambda: dia.sell_matvec(params, xt))
    g_lib = graph_ms(lambda: torch.sparse.mm(csr, xn), library=True)
    print(f"[K1' {name}] R={r} by CUDA-graph replay: kernel "
          f"{fmt_ms(g_ms)}, library(csr) {fmt_ms(g_lib)}; "
          f"{graph_note(g_ms, bound_ms, g_lib, library_ms)}", flush=True)
    del csr, xn
    torch.cuda.empty_cache()
    stored = params["a_val"].numel() + params["b_val"].numel()
    print(f"[K1' {name}] {shape_text(k1_key(params, xt))} nnz={nnz} "
          f"stored={stored} "
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
    return {"key": k1_key(params, xt), "name": f"{name} R={r}",
            "abs_err": abs_err, "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_graph_ms": g_lib,
            "csr_bound_ms": csr_bound_ms}


def k2_case(params, seed, name: str = "l0 CG operator", timed: bool = True):
    """K2' vs its f64 plain version and cuSPARSE (f64) on the level-0
    compensated operator (or one shard of it; timed=False: the
    comparison with the plain version only)."""
    import torch

    from padne_tpu_torch.ops import comp

    np_ = params["perm"].numel()
    dev = params["perm"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(params["nx"], generator=gen, device=dev) + 1.0
    y = comp.comp_sell(params, x)
    ref = comp.comp_sell_plain(params, x)
    absp = {k: v.abs() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in params.items()}
    tol = 2e-13 * float(comp.comp_sell_plain(absp, x.abs()).max())
    del absp
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    check(abs_err <= tol, f"K2' {name} disagrees with its f64 plain "
                          "version")
    if not timed:
        print(f"[K2' {name}] {shape_text(k2_key(params, x))}: "
              f"max_abs_err={abs_err:.3e} (bound {tol:.3e})", flush=True)
        return {"key": k2_key(params, x), "name": name, "abs_err": abs_err}
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
    # A call this short is timed by events at the host's launch rate:
    # graph replay reads the card's own time.
    g_ms = graph_ms(lambda: comp.comp_sell(params, x))
    g_lib = graph_ms(lambda: torch.sparse.mm(csr, x64), library=True)
    print(f"[K2' {name}] {shape_text(k2_key(params, x))} by CUDA-graph "
          f"replay: kernel "
          f"{fmt_ms(g_ms)}, library(csr f64) {fmt_ms(g_lib)}; "
          f"{graph_note(g_ms, bound_ms, g_lib, library_ms)}", flush=True)
    del csr
    torch.cuda.empty_cache()
    print(f"[K2' {name}] {shape_text(k2_key(params, x))} f32 hi+lo -> f64: "
          f"max_abs_err={abs_err:.3e} (bound {tol:.3e}) "
          f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s needed) "
          f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.1f} MB needed, {stored_bytes / 1e6:.1f} MB as "
          f"stored) csr_bound {csr_bound_ms:.4f} ms "
          f"library(csr f64) {library_ms:.4f} ms; "
          f"{target_note(ms, bound_ms, library_ms)}", flush=True)
    return {"key": k2_key(params, x), "name": name,
            "abs_err": abs_err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_graph_ms": g_lib,
            "csr_bound_ms": csr_bound_ms}


def dia_cases(s, label: str, seed: int, timed: bool = True):
    """K1' and K2' on every operator a set-up DiaBorderedSolver `s`
    launches them on, at both widths its solve has: the CG operator
    (f32) and each sparse level of the cycle, at R = m + 1 (the first
    solve, border columns and right-hand side together) and at R = 1
    (the refinement passes), and K2' on the CG operator (timed=False:
    the comparisons with the plain versions only).  Returns (K1' cases,
    K2' case); the CG operator at R = m + 1 comes first."""
    r = s.m + 1
    op, cyc = s.op_params, s.cycle_params   # cyc[-1]: the coarse inverse
    k1 = [k1_case(f"{label}l0 CG operator", op, r, seed, timed),
          k1_case(f"{label}l0 CG operator", op, 1, seed + 1, timed)]
    for i, level in enumerate(cyc[:-1]):
        for width in (r, 1):
            k1.append(k1_case(f"{label}l{i} cycle operator", level, width,
                              seed + 2 + 2 * i + (width == 1), timed))
            if "sm" in level:   # the lumped operator of the transfers
                k1.append(k1_case(
                    f"{label}l{i} transfer-smoothing operator", level["sm"],
                    width, seed + 50 + 2 * i + (width == 1), timed))
    return k1, k2_case(op, seed + 2 * len(cyc), timed=timed)


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
    k1, k2 = dia_cases(s, "", 1)
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


def fragmented_problem(dof: int, tiles=(12, 12), tile_mm: float = 10.0,
                       gap_mm: float = 0.5):
    """A heavily fragmented board and a mesher config for `dof`: one
    copper layer of tiles[0] x tiles[1] separate square tiles above a
    rail strip.  Every tile is live: its own voltage source holds it
    against the rail (0.5 V and up, 2 mV apart) and its own current
    source loads it, returning through the rail.  Each tile and the rail
    are one copper component each, and every component is touched by a
    border row, so the bordered system is nonsingular."""
    from padne_tpu_torch import geom, mesh, problem

    tx, ty = tiles
    pitch = tile_mm + gap_mm
    width = tx * pitch - gap_mm
    rail = geom.box(0.0, -gap_mm - 4.0, width, -gap_mm)
    origins = [(i * pitch, j * pitch) for i in range(tx) for j in range(ty)]
    boxes = [rail] + [geom.box(x0, y0, x0 + tile_mm, y0 + tile_mm)
                      for x0, y0 in origins]
    layer = problem.Layer(shape=geom.MultiPolygon(boxes), name="F.Cu",
                          conductance=5.95e4 * 0.035)
    networks = []
    for t, (x0, y0) in enumerate(origins):
        # Two rail taps per tile, spread along the rail.
        rx = (t + 0.5) / (tx * ty) * width
        feed, load, rail_a, rail_b = (
            problem.Connection(layer=layer, point=geom.Point(x, y))
            for x, y in ((x0 + 1.0, y0 + 1.0),
                         (x0 + tile_mm - 1.0, y0 + tile_mm - 1.0),
                         (rx, -gap_mm - 1.0), (rx, -gap_mm - 3.0)))
        networks.append(problem.Network(
            connections=[feed, load, rail_a, rail_b],
            elements=[
                problem.VoltageSource(p=feed.node_id, n=rail_a.node_id,
                                      voltage=0.5 + 0.002 * t),
                problem.CurrentSource(f=load.node_id, t=rail_b.node_id,
                                      current=0.2 + 0.002 * t)]))
    prob = problem.Problem(layers=[layer], networks=networks,
                           project_name="fragmented")
    size = max(0.05, (layer.shape.area / (0.43 * dof)) ** 0.5)
    return prob, mesh.Mesher.Config(maximum_size=size,
                                    variable_size_maximum_factor=1.0)


class SolveSpy:
    """Keeps what padne_tpu_torch.solver.solve returned and its stats
    while it is entered, by standing in for it: the command-line
    interface gives back neither."""

    def __enter__(self):
        from padne_tpu_torch import solver

        self.real = solver.solve
        self.stats, self.solution = {}, None

        def recording(prob, **kw):
            self.solution = self.real(prob, stats=self.stats, **kw)
            return self.solution

        solver.solve = recording
        return self

    def __exit__(self, *exc):
        from padne_tpu_torch import solver

        solver.solve = self.real


class BorderedSpy:
    """Keeps the system and the BorderedSolution of the last
    ops.schur.solve_bordered call while it is entered, by standing in
    for it (solver.solve returns neither)."""

    def __enter__(self):
        from padne_tpu_torch.ops import schur

        self.real = schur.solve_bordered
        self.system = self.result = None

        def recording(system, **kw):
            self.system = system
            self.result = self.real(system, **kw)
            return self.result

        schur.solve_bordered = recording
        return self

    def __exit__(self, *exc):
        from padne_tpu_torch.ops import schur

        schur.solve_bordered = self.real


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
    # As the solve calls them: the step corrects the x it multiplies (a
    # shard's rows of it, a block of their own, when x is gathered).
    kw = {"plain": {}, "residual": {"b": b}, "add": {"x0": x0},
          "smooth": {"b": b, "w": w, "x0": x if n == nx else x0}}[form]
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
    # x: the rows the nonzeros name (the diagonal's at the row's own).
    touched = op.col[op.val != 0].long()
    if op.diag is not None:
        touched = torch.cat([touched, op.diag.nonzero()[:, 0]])
    read_x = x_bytes(touched, x)
    nbytes = (nnz * (4 + s) + (0 if diag is None else s * n) + read_x
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
          f"{nbytes / 1e6:.2f} MB needed, x {read_x / 1e6:.2f} of "
          f"{_size(x) / 1e6:.2f} MB) csr_bound {csr_bound_ms:.4f} ms; "
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


class DiaShapes:
    """Counts K1''s and K2''s launches by shape while it is entered, by
    standing in for the launch functions of ops.dia and ops.comp (the
    wrappers' own counts are untouched)."""

    def __init__(self):
        import collections

        self.counts = collections.Counter()
        # K1''s launches by operator (the id of its params dict) and
        # width: two operators of one shape (level 0's exact and lumped
        # cycle operators) share a key of `counts`.
        self.by_params = collections.Counter()

    def __enter__(self):
        from padne_tpu_torch.ops import comp, dia

        self.real = dia._launch, comp._launch

        def k1(params, xt):
            self.counts[k1_key(params, xt)] += 1
            self.by_params[id(params), xt.shape[0]] += 1
            return self.real[0](params, xt)

        def k2(params, x):
            self.counts[k2_key(params, x)] += 1
            return self.real[1](params, x)

        dia._launch, comp._launch = k1, k2
        return self.counts

    def __exit__(self, *exc):
        from padne_tpu_torch.ops import comp, dia

        dia._launch, comp._launch = self.real


def check_dia_held(path: str, shapes, launches: dict, k1, k2) -> dict:
    """Fails if the solve of `path` launched K1' or K2' at a shape that
    no case of the lists `k1` + `k2` held against the plain version, or
    if the per-shape launches do not add up to the wrappers' counts.
    Prints and returns the launches by shape."""
    held = {c["key"]: c["name"] for c in k1 + k2}
    by_kernel = {"K1'": "dia_sell", "K2'": "comp_sell"}
    for kernel, name in by_kernel.items():
        check(sum(v for k, v in shapes.items() if k[0] == kernel)
              == launches[name],
              f"{path}: the per-shape launches of {kernel} do not add up "
              "to its count")
    by_shape = {}
    for key, count in sorted(shapes.items(), key=lambda kv: -kv[1]):
        text = shape_text(key)
        by_shape[f"{key[0]} {text}"] = count
        print(f"[{key[0]} launches] {text}: {count} in the {path} solve"
              + (f" (held above as {held[key]})" if key in held else ""),
              flush=True)
    missing = sorted(set(shapes) - set(held))
    check(not missing, f"the {path} solve launched DIA kernels at shapes "
                       f"that were not held against the plain version: "
                       f"{missing}")
    return by_shape


def launch_counts() -> dict:
    from padne_tpu_torch.ops import comp, dia, spmv

    return {"dia_sell": dia.sell_matvec.launches,
            "comp_sell": comp.comp_sell.launches,
            "ell_spmv": spmv.ell_spmv.launches}


def reset_counts() -> None:
    from padne_tpu_torch.ops import comp, dia, spmv

    dia.sell_matvec.launches = comp.comp_sell.launches = 0
    spmv.ell_spmv.launches = 0


def same_fields(a, b) -> bool:
    """Two Solutions hold bit-equal meshes, potentials and power
    densities."""
    import numpy as np

    def arrays(sol):
        for ls in sol.layer_solutions:
            for m in ls.meshes + ls.disconnected_meshes:
                yield m.vertices
                yield m.triangles
            for f in ls.potentials + ls.power_densities:
                yield f.values

    xs, ys = list(arrays(a)), list(arrays(b))
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(xs, ys))


def fingerprint(label: str, iterations, passes, residual, *arrays) -> dict:
    """One run of phase repeat: its CG iterations, refinement passes
    (None where the path has none), residual (a list where it has one a
    column or system) and result arrays, the potentials first, with the
    SHA-256 of the potentials' bytes."""
    import hashlib

    import numpy as np

    arrays = [np.ascontiguousarray(a) for a in arrays]
    return {"label": label, "cg_iterations": iterations, "passes": passes,
            "residual": residual,
            "sha256": hashlib.sha256(arrays[0].tobytes()).hexdigest(),
            "arrays": arrays}


def solution_print(label: str, sol) -> dict:
    """fingerprint of an ops.schur.BorderedSolution: v, then j."""
    return fingerprint(label, sol.cg_iterations, sol.refinement_steps + 1,
                       sol.residual_norm, sol.v, sol.j)


def hold_repeats(repeats: dict, name: str, runs: list) -> None:
    """Phase repeat: `runs` (fingerprints) of one path on the same
    inputs must be equal bit for bit, iterations, passes, residuals and
    every array (np.array_equal, no tolerance): a solve on the card is a
    function of its inputs.  Printed run by run and kept in `repeats`
    for the phase's JSON line."""
    import numpy as np

    for r in runs:
        print(f"[repeat] {name}, {r['label']}: cg_iterations="
              f"{r['cg_iterations']} passes={r['passes']} residual="
              f"{r['residual']!r} sha256={r['sha256']}", flush=True)
    first = runs[0]
    same = all(
        r["cg_iterations"] == first["cg_iterations"]
        and r["passes"] == first["passes"]
        and np.array_equal(np.asarray(r["residual"]),
                           np.asarray(first["residual"]))
        and len(r["arrays"]) == len(first["arrays"])
        and all(np.array_equal(a, b)
                for a, b in zip(r["arrays"], first["arrays"]))
        for r in runs[1:])
    repeats[name] = [{k: v for k, v in r.items() if k != "arrays"}
                     for r in runs]
    check(same, f"phase repeat: the runs of {name} are not bit-equal")


def sum_case(name: str, scatter, fixed, tol: float) -> dict:
    """The device time of one fixed-order sum of the solve (`fixed`)
    beside the atomic scatter it replaced (`scatter`), on the same
    inputs: by CUDA events and by CUDA-graph replay.  Both must agree
    within tol of the largest |result|."""
    import torch

    a, b = scatter(), fixed()
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    check(err <= tol * max(float(a.abs().max()), 1e-300),
          f"{name}: the fixed-order sum is {err:.3e} from the scatter")
    # The fixed-order sums must capture (they stand in the CG body); the
    # scatter is timed by graph replay where it captures.
    out = {"scatter_ms": time_ms(scatter), "fixed_ms": time_ms(fixed),
           "scatter_graph_ms": graph_ms(scatter, library=True),
           "fixed_graph_ms": graph_ms(fixed), "max_abs_diff": err}
    print(f"[repeat sums] {name}: atomic scatter {out['scatter_ms']:.4f} ms "
          f"(graph {fmt_ms(out['scatter_graph_ms'])}), fixed order "
          f"{out['fixed_ms']:.4f} ms (graph {fmt_ms(out['fixed_graph_ms'])})"
          f", max|diff| {err:.3e}", flush=True)
    return out


def dia_sum_cases(s) -> dict:
    """sum_case for the DIA route's sums on a set-up DiaBorderedSolver
    `s` (its own index arrays, random f64 / f32 operands): the ladder's
    Z^T r, the border products B X (R = m + 1, R = 1) and C j, and the
    sharded projector's component sums over SHARDS shards of the card
    (one-hot products, before this an f32 index_add_ per shard) at
    R = m + 1 and R = 1."""
    import torch

    from padne_tpu_torch.ops import cg
    from padne_tpu_torch.parallel import sharding

    dev, f64 = s.device, torch.float64
    gen = torch.Generator(device=dev).manual_seed(23)
    np0, m, p = s.np0, s.m, s.p
    border = s.system.border
    comp = s.comp_pad_dev
    row_idx = torch.as_tensor(border.row_idx, device=dev)
    col_pos = torch.as_tensor(s.posmap[border.col_node], device=dev)
    r64 = torch.randn(np0, generator=gen, device=dev, dtype=f64)
    x = torch.randn(np0, m + 1, generator=gen, device=dev, dtype=f64)
    j = torch.randn(m, generator=gen, device=dev, dtype=f64)

    def border_scatter(x):
        g = x[s._row_node_pos] * s._row_val64[:, None]
        return x.new_zeros(m, x.shape[1]).index_add_(0, row_idx, g)

    out = {
        f"Z^T r, f64 ({np0},), {p + 1} segments": sum_case(
            "Z^T r", lambda: r64.new_zeros(p + 1).index_add_(
                0, comp, r64)[:p], lambda: s._ztr(r64), 1e-12),
        f"B X, f64 ({np0}, {m + 1})": sum_case(
            "B X", lambda: border_scatter(x),
            lambda: s._border_apply(x), 1e-12),
        f"B x, f64 ({np0}, 1)": sum_case(
            "B x", lambda: border_scatter(x[:, :1]),
            lambda: s._border_apply(x[:, :1]), 1e-12),
        f"C j, f64 ({np0},)": sum_case(
            "C j", lambda: r64.new_zeros(np0).index_add_(
                0, col_pos, s._col_val64 * j[s._col_idx]),
            lambda: s._c_apply(j), 1e-12)}
    mesh = sharding.Mesh([dev] * SHARDS)
    rows = np0 - np0 % SHARDS
    shards = sharding.split(mesh, comp[:rows], dim=0)
    comps = [cg._Components(c, p + 1, 1) for c in shards]
    for r in (m + 1, 1):
        xs = [torch.rand(r, len(c), generator=gen, device=dev)
              for c in shards]
        out[f"sharded projector sums, f32 ({r}, {len(shards[0])}) x "
            f"{SHARDS}"] = sum_case(
            f"sharded projector R={r}",
            lambda xs=xs, r=r: sharding.psum(mesh, [
                x.new_zeros(r, p + 1).index_add_(1, c, x)
                for x, c in zip(xs, shards)]),
            lambda xs=xs: sharding.psum(mesh, [
                cc.sums(x) for x, cc in zip(xs, comps)]), 1e-4)
    return out


def cli_exports(sol, npz: pathlib.Path, tmp: pathlib.Path) -> dict:
    """`info`, `paraview` and `html` of the command-line interface on the
    artifact `npz` that `solve` wrote for `sol`; the checks of phase 5.
    Returns the wall times."""
    import contextlib
    import io
    import xml.etree.ElementTree as ET

    from padne_tpu_torch import cli
    from padne_tpu_torch.io import paraview
    from padne_tpu_torch.io import solution as solution_io

    times = {}
    t0 = time.perf_counter()
    loaded = solution_io.load_solution(npz)
    times["load_s"] = time.perf_counter() - t0
    check(same_fields(loaded, sol), "the reloaded artifact differs from "
                                    "the solved fields")
    check(loaded.solver_info == sol.solver_info,
          "the reloaded solver info differs")

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["info", str(npz)])
    times["info_s"] = time.perf_counter() - t0
    text = out.getvalue()
    check(f"system size: {sol.solver_info.system_size}" in text
          and all(f"  {l.name}: " in text for l in sol.problem.layers),
          "`info` does not describe the solved system")

    t0 = time.perf_counter()
    cli.main(["paraview", str(npz), str(tmp / "pv")])
    times["paraview_s"] = time.perf_counter() - t0
    used = set()
    for layer, ls in zip(sol.problem.layers, sol.layer_solutions):
        f = tmp / "pv" / (paraview.sanitize_filename(layer.name, used)
                          + ".vtu")
        check(f.exists(), f"{f.name} was not written")
        pieces = ET.parse(f).getroot().findall(".//Piece")
        check([int(p.get("NumberOfPoints")) for p in pieces]
              == [m.num_vertices for m in ls.meshes],
              f"{f.name} does not hold its layer's meshes")
        check(all(len(p.find("PointData/DataArray").text.split())
                  == int(p.get("NumberOfPoints")) for p in pieces),
              f"{f.name}: voltages do not match the points")

    t0 = time.perf_counter()
    cli.main(["html", str(npz), str(tmp / "view.html")])
    times["html_s"] = time.perf_counter() - t0
    check_html(tmp / "view.html", sol)
    return times


def check_html(page: pathlib.Path, sol) -> None:
    """The HTML viewer `page` exists, and its payload parses and holds
    the layers and meshes of `sol`."""
    import re

    check(page.exists(), f"{page.name} was not written")
    data = re.search(r"const DATA = (\{.*?\});\n", page.read_text(), re.S)
    check(data is not None, f"{page.name} holds no payload")
    payload = json.loads(data.group(1))
    check([l["name"] for l in payload["layers"]]
          == [l.name for l in sol.problem.layers]
          and sum(e["nv"] for l in payload["layers"] for e in l["meshes"])
          >= sum(m.num_vertices for ls in sol.layer_solutions
                 for m in ls.meshes),
          f"the payload of {page.name} does not hold the solved meshes")


def dia_phases(args, tmp: pathlib.Path, repeats: dict):
    """K1' and K2' on the DIA route's operators at --dof, the user path
    through the command-line interface at --dof, then the scipy check at
    --scipy-dof, each solve's launched shapes held against the cases;
    phase repeat's runs of both boards and the device time of the DIA
    route's sums (into `repeats`).  Returns (K1' cases, K2' cases, the
    main solve's launch counts, what later phases take from these: the
    cli solve's system and BorderedSolution for phase sharded; the scipy
    check's project, its mesher flags, its potentials and its system for
    phase serve)."""
    import numpy as np
    import torch

    from padne_tpu_torch import cli, solver
    from padne_tpu_torch.ops import schur

    t0 = time.perf_counter()
    prob, cfg = bench_problem(tmp, args.dof)
    t_load = time.perf_counter() - t0
    k1, k2 = dia_kernel_cases(solver.build_system(prob, cfg)[0])
    del prob
    torch.cuda.empty_cache()

    pro = tmp / "gen_bench_4layer" / "gen_bench_4layer.kicad_pro"
    npz = tmp / "bench.npz"
    flags = ["--mesh-size", repr(cfg.maximum_size),
             "--variable-size-maximum-factor",
             repr(cfg.variable_size_maximum_factor)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with SolveSpy() as spy, BorderedSpy() as bspy, DiaShapes() as shapes:
        cli.main(["solve", str(pro), str(npz), *flags])
    launches = launch_counts()
    t_cli = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats, sol = spy.stats, spy.solution
    check(sol is not None and npz.exists(), "`solve` wrote no artifact")
    info = sol.solver_info
    print(f"[cli solve] route={stats['route']} n={stats['n']} m={stats['m']} "
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
    by_shape = check_dia_held("cli", shapes, launches, k1, [k2])
    check(info.residual_norm < 1e-9,
          f"residual {info.residual_norm:.3e} misses the 1e-9 gate")
    check_fields(sol, stats["n"])
    times = cli_exports(sol, npz, tmp)
    print(f"[cli] solve {t_cli:.2f} s in all (artifact "
          f"{npz.stat().st_size / 1e6:.1f} MB); "
          + ", ".join(f"{k[:-2]} {v:.2f} s" for k, v in times.items()),
          flush=True)
    cli_run = {"system": bspy.system, "bordered": bspy.result,
               "setup_s": stats["setup_s"], "solve_s": stats["solve_s"],
               "cg_iterations": info.cg_iterations,
               "refinement_passes": info.refinement_steps + 1,
               "peak_device_memory_gb": peak_gb}
    check(bspy.system is not None and bspy.system.n == stats["n"],
          "the cli solve's system was not recorded")
    print(json.dumps({"phase": "cli", "route": stats["route"],
                      "n": stats["n"], "m": stats["m"],
                      "residual_norm": info.residual_norm,
                      "cg_iterations": info.cg_iterations,
                      "refinement_passes": info.refinement_steps + 1,
                      "launches": launches, "launches_by_shape": by_shape,
                      "peak_device_memory_gb": peak_gb,
                      "cli_solve_s": t_cli, "setup_s": stats["setup_s"],
                      "solve_s": stats["solve_s"], **times}), flush=True)
    del sol, spy
    # Phase repeat: a second set-up of phase cli's system solves 3 times.
    # A solver's first solve also computes A^+ C, which its later solves
    # reuse (as in the JAX package): the first is held against phase
    # cli's, itself a first solve, the later ones against each other.
    again = schur.DiaBorderedSolver(bspy.system, device=DEV)
    hold_repeats(repeats, f"cli board n={stats['n']}, two set-ups", [
        solution_print("phase cli", bspy.result),
        solution_print("a second set-up", again.solve(
            target_residual=1e-10))])
    hold_repeats(repeats, f"cli board n={stats['n']}, later solves", [
        solution_print(f"solve {i + 2}", again.solve(
            target_residual=1e-10)) for i in range(2)])
    repeats["sums"] = dia_sum_cases(again)
    del again
    # The graph captures of the one-hot products left cuBLAS workspaces
    # on their side streams: free them, or later phases' peak device
    # memory would count them.
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    torch.cuda.empty_cache()

    prob, cfg = bench_problem(tmp / "scipy", args.scipy_dof)
    scipy_system = solver.build_system(prob, cfg)[0]
    s = schur.DiaBorderedSolver(scipy_system, device=DEV)
    k1s, k2s = dia_cases(s, "scipy-check ", 21)
    torch.cuda.empty_cache()
    reset_counts()
    stats2 = {}
    with DiaShapes() as shapes, BorderedSpy() as bspy:
        sol = solver.solve(prob, mesher_config=cfg,
                           check_against_scipy=True, stats=stats2)
    check_dia_held("scipy-check", shapes, launch_counts(), k1s, [k2s])
    # Phase repeat: the first solve of the cases' set-up (not solved
    # before) against phase 6's, each from its own set-up.
    hold_repeats(repeats, f"scipy-check board n={scipy_system.n}, two "
                          "set-ups", [
                     solution_print("phase 6's set-up", bspy.result),
                     solution_print("a second set-up", s.solve(
                         target_residual=1e-10))])
    scipy_bordered = bspy.result
    del s, bspy
    torch.cuda.empty_cache()
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
    # Phase serve runs on this board: its project, flags and potentials.
    ctx = {"project": tmp / "scipy" / "gen_bench_4layer"
           / "gen_bench_4layer.kicad_pro",
           "flags": ["--mesh-size", repr(cfg.maximum_size),
                     "--variable-size-maximum-factor",
                     repr(cfg.variable_size_maximum_factor)],
           "ref_v": np.concatenate([pot.values for ls in sol.layer_solutions
                                    for pot in ls.potentials]),
           "scipy_system": scipy_system, "scipy_bordered": scipy_bordered,
           "cli": cli_run}
    return k1 + k1s, [k2, k2s], launches, ctx


def ell_phases(args, tmp: pathlib.Path, repeats: dict):
    """K3' at the ELL phase's shapes, the ELL route at --ell-dof, the
    sweep and the small boards; phase repeat's runs of the ELL solve and
    the sweep, and the device time of the ELL route's Z^T y (into
    `repeats`).  Returns (K3' cases, the ELL solve's launch counts, the
    sweep's numbers, the ELL solve's system and BorderedSolution for
    phase sharded)."""
    import torch

    from padne_tpu_torch import kicad, solver
    from padne_tpu_torch.ops import schur, segment

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
    with K3Shapes() as shapes, BorderedSpy() as bspy:
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
    ell_run = {"system": bspy.system, "bordered": bspy.result,
               "setup_s": stats["setup_s"], "solve_s": stats["solve_s"],
               "escalated": stats["escalated"]}
    # Phase repeat: 5 more solves of phase 8's system in this process,
    # each with its own set-up, as phase 8's.
    system = bspy.system
    hold_repeats(repeats, f"ELL board n={system.n}", [
        solution_print("phase 8", bspy.result)] + [
        solution_print(f"solve {i + 2}", schur.solve_bordered(
            system, inner_dtype=torch.float32, device=DEV))
        for i in range(5)])
    comp_id = torch.as_tensor(system.comp_id, device=DEV)
    p = system.num_components
    rc = torch.randn(system.n, device=DEV, dtype=torch.float64,
                     generator=torch.Generator(device=DEV).manual_seed(29))
    repeats["sums"][f"ELL Z^T r, f64 ({system.n},), {p} segments"] = \
        sum_case("ELL Z^T r", lambda: rc.new_zeros(p).index_add_(
            0, comp_id, rc), lambda z=segment.SegmentSum(comp_id, p): z(rc),
            1e-12)
    sweep = sweep_phase(prob, cfg, sol, timed, repeats)
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
    return k3, launches, sweep, ell_run


SWEEP_SPECS = [(s, src) for s in (0.5, 1.0, 2.0, 4.0)
               for src in (1.0, 2.0, 3.3)]


def sweep_phase(prob, cfg, single, timed: dict, repeats: dict) -> dict:
    """Phase 11: the design sweep on the ELL phase's board, then phase
    repeat's second run of it.  single: the Solution of phase 8's single
    solve; timed: the K3' shapes that phase 7 held against the plain
    version.  Returns the phase's numbers."""
    import numpy as np
    import torch

    from padne_tpu_torch import sweep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    with K3Shapes() as shapes:
        results = sweep.solve_sweep(
            prob, [sweep.SweepSpec(*x) for x in SWEEP_SPECS],
            mesher_config=cfg, stats=stats)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n, m = stats["n"], stats["m"]
    print(f"[sweep] n={n} m={m} p={stats['p']} specs={len(results)} "
          f"cg_iterations={stats['cg_iterations']} "
          f"cg_residual_norms={[f'{x:.2e}' for x in stats['cg_residual_norms']]} "
          f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
          f"setup={stats['setup_s']:.2f}s multi_rhs_cg={stats['cg_s']:.3f}s "
          f"recoveries={stats['recover_s']:.3f}s wall={wall:.2f}s "
          f"peak_device_memory={peak_gb:.3f} GB launches={launches}",
          flush=True)
    check(launches["ell_spmv"] > 0 and launches["dia_sell"]
          == launches["comp_sell"] == 0,
          "the sweep did not run on K3' alone")
    check(sum(shapes.values()) == launches["ell_spmv"],
          "the per-shape launches of K3' do not add up to its count")
    by_shape = {}
    for key, count in sorted(shapes.items(), key=lambda kv: -kv[1]):
        n_, nx_, r_, kind, form = key
        by_shape[f"n={n_} nx={nx_} R={r_} {kind} {form}"] = count
        print(f"[K3' launches] n={n_} nx={nx_} R={r_} {kind} {form}: "
              f"{count} in the sweep"
              + (f" (timed above as {timed[key]})" if key in timed else ""),
              flush=True)
    check(all(key[3] == "float64" for key in shapes),
          "the sweep launched K3' in another type than f64")
    missing = sorted(set(shapes) - set(timed))
    check(not missing, f"the sweep launched K3' at shapes that were not "
                       f"held against the plain version: {missing}")
    check(shapes[(n, n, 1, "float64", "residual")] == len(results),
          "the sweep did not take one fused residual launch per spec")

    # Each spec against its own right-hand side's norm: the sources
    # scale with the spec's source scale.
    rhs_norm = float(np.sqrt(stats["rhs_core_norm"] ** 2
                             + stats["rhs_border_norm"] ** 2))
    worst = 0.0
    for r in results:
        rel = r.residual_norm / (r.spec.source_scale * rhs_norm)
        worst = max(worst, rel)
        print(f"[sweep spec] conductance x{r.spec.conductance_scale} source "
              f"x{r.spec.source_scale}: residual {r.residual_norm:.3e} "
              f"({rel:.3e} of its right-hand side) span "
              f"{r.v.max() - r.v.min():.6f} V", flush=True)
        check(np.isfinite(r.v).all() and r.v.shape == (n,)
              and r.j.shape == (m,), "a spec's result is malformed")
        check(rel < 1e-8, f"spec {r.spec}: residual {rel:.3e} of its "
                          "right-hand side misses 1e-8")

    by_spec = {(r.spec.conductance_scale, r.spec.source_scale): r.v
               for r in results}
    v_single = np.concatenate([p.values for ls in single.layer_solutions
                               for p in ls.potentials])
    dv = float(np.abs(by_spec[(1.0, 1.0)][:len(v_single)] - v_single).max())
    check(dv <= 1e-6, f"spec (1, 1) is {dv:.3e} V from the single solve")
    # Linear in the sources: v(s, k src) = k v(s, src).
    lin = max(float(np.abs(by_spec[(s, k)] - k * by_spec[(s, 1.0)]).max())
              for s in (0.5, 1.0, 2.0, 4.0) for k in (2.0, 3.3))
    # v(s) = v_V + v_I / s: the voltage-driven part does not depend on
    # the conductance scale, the current-driven drop goes with 1 / s.
    d1 = by_spec[(0.5, 1.0)] - by_spec[(1.0, 1.0)]     # v_I
    d2 = by_spec[(1.0, 1.0)] - by_spec[(2.0, 1.0)]     # v_I / 2
    d3 = by_spec[(2.0, 1.0)] - by_spec[(4.0, 1.0)]     # v_I / 4
    law = max(float(np.abs(d1 - 2 * d2).max()),
              float(np.abs(d1 - 4 * d3).max()))
    print(f"[sweep] spec (1, 1) vs the single solve: max|dV|={dv:.3e} V; "
          f"source linearity {lin:.3e} V; v_V + v_I/s law {law:.3e} V "
          f"(current-driven drop {float(np.abs(d1).max()):.3e} V at s=1)",
          flush=True)
    check(lin <= 1e-8 and law <= 1e-8, "the sweep breaks its scaling laws")
    check(float(np.abs(d1).max()) > 1e-4, "the board has no current-driven "
                                          "drop to test the law on")
    out = {"phase": "sweep", "launches": launches, "n": n, "m": m,
           "specs": len(results),
           "cg_iterations": stats["cg_iterations"],
           "cg_residual_norms": stats["cg_residual_norms"],
           "k3_f64_launches": launches["ell_spmv"],
           "k3_launches_by_shape": by_shape,
           "worst_relative_residual": worst, "max_dv_vs_single_solve": dv,
           "mesh_assemble_s": stats["mesh_assemble_s"],
           "setup_s": stats["setup_s"], "multi_rhs_cg_s": stats["cg_s"],
           "recoveries_s": stats["recover_s"], "wall_s": wall,
           "peak_device_memory_gb": peak_gb}
    print(json.dumps(out), flush=True)

    def sweep_print(label, stats, results):
        return fingerprint(label, stats["cg_iterations"], None,
                           [r.residual_norm for r in results],
                           np.concatenate([r.v for r in results]),
                           np.concatenate([r.j for r in results]))

    stats2 = {}
    results2 = sweep.solve_sweep(
        prob, [sweep.SweepSpec(*x) for x in SWEEP_SPECS],
        mesher_config=cfg, stats=stats2)
    hold_repeats(repeats, f"sweep n={n}, {len(results)} specs", [
        sweep_print("run 1", stats, results),
        sweep_print("run 2", stats2, results2)])
    return out


SHARDS = 4   # phase sharded: shards of the one card


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def sharded_dia_cases(s, seed: int, timed: bool = True):
    """K1' and K2' at every shape the sharded DIA solver `s` launches:
    each shard's f32 CG operator and each sharded cycle level's operator
    per shard over its window, at R = m + 1 and R = 1, K2' on each
    shard's CG operator, and the one-device tail levels of the cycle at
    both widths.  Every shard is held against the plain version; the
    first shard of each (level, width), whose shape the others share, is
    also timed (timed=False: none).  Returns (K1' cases, K2' cases)."""
    r = s.m + 1
    k1, k2 = [], []
    for sh, prm in enumerate(s.op_params.params):
        name = f"sharded l0 CG operator shard {sh}"
        for width in (r, 1):
            k1.append(k1_case(name, prm, width, seed,
                              timed=timed and sh == 0))
            seed += 1
        k2.append(k2_case(prm, seed, name, timed=timed and sh == 0))
        seed += 1
    for i, level in enumerate(s.cycle_params[:-1]):
        shards = level["op"].params if "op" in level else [level]
        for sh, prm in enumerate(shards):
            name = (f"sharded l{i} cycle operator"
                    + (f" shard {sh}" if "op" in level else " (one device)"))
            for width in (r, 1):
                k1.append(k1_case(name, prm, width, seed,
                                  timed=timed and sh == 0))
                seed += 1
    return k1, k2


def sharded_k3_cases(system, gen):
    """K3' at every shape the sharded ELL route launches at R = m + 1,
    in f32 and, as after an f64 escalation, in f64, on the first shard's
    operators (the others have its shape): the CG's product over the
    gathered vector, and per level of the cycle the residual, the
    restriction, x0 + P xc and the damped-Jacobi step
    (ops.amg._make_vcycle_sharded)."""
    import torch

    from padne_tpu_torch.ops import amg

    tp, r = SHARDS, system.border.m + 1
    levels = amg.build_hierarchy(system.ell).levels
    pads = [-(-len(lv.a_diag) // tp) * tp for lv in levels]

    def first(cols, vals, diag, n_pad, nx):
        c, v = amg.shard_rows(cols, vals, diag, n_pad, tp)[0]
        return c, v, None, nx

    ell = system.ell
    cases = []
    for dtype in (torch.float32, torch.float64):
        cases.append(k3_case("sharded A", first(
            ell.cols, ell.vals, ell.diag, pads[0], pads[0]), dtype, r,
            "plain", gen))
        for i, lv in enumerate(levels[:-1]):
            a = first(lv.a_cols, lv.a_vals, lv.a_diag, pads[i], pads[i])
            cases += [
                k3_case(f"sharded A l{i}", a, dtype, r, "residual", gen),
                k3_case(f"sharded R l{i}", first(lv.r_cols, lv.r_vals, None,
                                                 pads[i + 1], pads[i]),
                        dtype, r, "plain", gen),
                k3_case(f"sharded P l{i}", first(lv.p_cols, lv.p_vals, None,
                                                 pads[i], pads[i + 1]),
                        dtype, r, "add", gen),
                k3_case(f"sharded A l{i}", a, dtype, r, "smooth", gen)]
    return cases


def sharded_phase(cli_run: dict, ell_run: dict, k3, project,
                  repeats: dict) -> dict:
    """Phase sharded: the solve row-sharded over SHARDS shards of the one
    card (parallel.sharding.Mesh naming cuda:0 SHARDS times).  The DIA
    route on phase cli's assembled system, the ELL route on phase 8's,
    each with its kernels held at every shape it launches and its answer
    against the one-device solve; then `--tp` beyond the card count
    through the command-line interface.  k3: phase 7's K3' cases.  Phase
    repeat: the sharded DIA solver solves twice more (into `repeats`)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from padne_tpu_torch import cli
    from padne_tpu_torch.ops import schur
    from padne_tpu_torch.parallel import sharding

    card = smi()
    mesh = sharding.Mesh([torch.device(DEV, 0)] * SHARDS)
    out = {"phase": "sharded", "tp": SHARDS, "card": card}

    # The DIA route.
    system, ref = cli_run["system"], cli_run["bordered"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = schur.DiaBorderedSolver(system, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() / 1e9
    levels = [(lv.pack.np_, lv.shard) for lv in s.hierarchy.levels]
    print(f"[sharded] DIA set-up over {SHARDS} shards {setup_s:.2f} s, "
          f"levels (rows, sharded) {levels}, peak device memory "
          f"{setup_peak:.3f} GB", flush=True)
    check(s.sharded and s.n_sharded >= 2,
          f"the DIA solve did not shard 2 levels: {levels}")
    k1, k2 = sharded_dia_cases(s, 31)
    exchange = {"l0 CG R=m+1": s.op_params.exchange_bytes(s.m + 1),
                "l0 CG R=1": s.op_params.exchange_bytes(1)}
    for i, level in enumerate(s.cycle_params[:s.n_sharded]):
        exchange[f"l{i} cycle R=m+1"] = level["op"].exchange_bytes(s.m + 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with DiaShapes() as shapes:
        sol = s.solve(target_residual=1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = max(setup_peak, torch.cuda.max_memory_allocated() / 1e9)
    span = float(ref.v.max() - ref.v.min())
    dv = float(np.abs(sol.v - ref.v).max())
    dj = float(np.abs(sol.j - ref.j).max() / np.abs(ref.j).max())
    print(f"[sharded] DIA n={system.n} m={s.m} solve {solve_s:.2f} s "
          f"(phase cli: set-up {cli_run['setup_s']:.2f} s, solve "
          f"{cli_run['solve_s']:.2f} s), cg_iterations={sol.cg_iterations} "
          f"(cli {cli_run['cg_iterations']}) refinement_passes="
          f"{sol.refinement_steps + 1} (cli {cli_run['refinement_passes']}) "
          f"residual_norm={sol.residual_norm:.3e} max|dV| vs cli {dv:.3e} V "
          f"(span {span:.6f} V) max|dj|/max|j| {dj:.3e} peak_device_memory="
          f"{peak:.3f} GB (cli {cli_run['peak_device_memory_gb']:.3f} GB) "
          f"exchange bytes per matvec {exchange} launches={launches}; "
          f"card {card}", flush=True)
    check(launches["dia_sell"] > 0 and launches["comp_sell"] > 0
          and launches["ell_spmv"] == 0,
          "the sharded DIA solve did not run on K1' and K2' alone")
    by_shape = check_dia_held("sharded", shapes, launches, k1, k2)
    check(sol.residual_norm <= 1e-9,
          f"sharded residual {sol.residual_norm:.3e} misses 1e-9")
    check(dv <= 1e-6 * max(span, 1.0), f"sharded potentials {dv:.3e} V "
                                        "from phase cli's")
    check(dj <= 1e-6, f"sharded border currents {dj:.3e} from phase cli's")
    # Phase repeat: two more solves on the cached A^+ C (see dia_phases).
    hold_repeats(repeats, f"sharded DIA n={system.n} over {SHARDS} shards",
                 [solution_print(f"solve {i + 2}", s.solve(
                     target_residual=1e-10)) for i in range(2)])
    out["dia"] = {
        "n": system.n, "m": s.m, "levels": levels,
        "sharded_levels": s.n_sharded, "setup_s": setup_s,
        "solve_s": solve_s, "cg_iterations": sol.cg_iterations,
        "refinement_passes": sol.refinement_steps + 1,
        "residual_norm": sol.residual_norm, "max_dv_vs_cli": dv,
        "max_dj_rel_vs_cli": dj, "peak_device_memory_gb": peak,
        "exchange_bytes_per_matvec": exchange, "launches": launches,
        "launches_by_shape": by_shape,
        "cli": {k: cli_run[k] for k in (
            "setup_s", "solve_s", "cg_iterations", "refinement_passes",
            "peak_device_memory_gb")},
        "k1_graph_ms": {c["name"]: c["graph_ms"] for c in k1
                        if "graph_ms" in c},
        "k2_graph_ms": {c["name"]: c["graph_ms"] for c in k2
                        if "graph_ms" in c}}
    del s, sol
    torch.cuda.empty_cache()

    # The ELL route.
    system, ref = ell_run["system"], ell_run["bordered"]
    gen = torch.Generator(device=torch.device(DEV)).manual_seed(9)
    k3s = sharded_k3_cases(system, gen)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    with K3Shapes() as k3_shapes:
        sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                                   device=DEV, mesh=mesh, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ell_launches = launch_counts()
    span = float(ref.v.max() - ref.v.min())
    dv = float(np.abs(sol.v - ref.v).max())
    print(f"[sharded] ELL n={system.n} route={stats['route']} "
          f"tp={stats['tp']} levels={stats['levels']} set-up "
          f"{stats['setup_s']:.2f} s, set-up and solve {wall:.2f} s "
          f"(phase 8: set-up {ell_run['setup_s']:.2f} s, solve "
          f"{ell_run['solve_s']:.2f} s) cg_iterations={sol.cg_iterations} "
          f"refinement_passes={sol.refinement_steps + 1} "
          f"escalated={stats['escalated']} residual_norm="
          f"{sol.residual_norm:.3e} max|dV| vs phase 8 {dv:.3e} V (span "
          f"{span:.6f} V) peak_device_memory="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"launches={ell_launches}", flush=True)
    check(stats["route"] == "ell" and stats["sharded"]
          and stats["tp"] == SHARDS, f"the ELL solve did not shard: {stats}")
    check(ell_launches["ell_spmv"] > 0 and ell_launches["dia_sell"]
          == ell_launches["comp_sell"] == 0,
          "the sharded ELL solve did not run on K3' alone")
    check(sum(k3_shapes.values()) == ell_launches["ell_spmv"],
          "the per-shape launches of K3' do not add up to its count")
    held = {c["key"]: c["name"] for c in k3 + k3s}
    ell_by_shape = {}
    for key, count in sorted(k3_shapes.items(), key=lambda kv: -kv[1]):
        n_, nx_, r_, kind, form = key
        ell_by_shape[f"n={n_} nx={nx_} R={r_} {kind} {form}"] = count
        print(f"[K3' launches] n={n_} nx={nx_} R={r_} {kind} {form}: "
              f"{count} in the sharded ELL solve"
              + (f" (held above as {held[key]})" if key in held else ""),
              flush=True)
    missing = sorted(set(k3_shapes) - set(held))
    check(not missing, f"the sharded ELL solve launched K3' at shapes that "
                       f"were not held against the plain version: {missing}")
    check(sol.residual_norm <= 1e-9,
          f"sharded ELL residual {sol.residual_norm:.3e} misses 1e-9")
    check(dv <= 1e-7 * span, f"sharded ELL potentials {dv:.3e} V from "
                             "phase 8's")
    out["ell"] = {"n": system.n, "levels": stats["levels"],
                  "setup_s": stats["setup_s"], "wall_s": wall,
                  "cg_iterations": sol.cg_iterations,
                  "refinement_passes": sol.refinement_steps + 1,
                  "escalated": stats["escalated"],
                  "residual_norm": sol.residual_norm,
                  "max_dv_vs_phase_8": dv, "launches": ell_launches,
                  "launches_by_shape": ell_by_shape}

    # --tp beyond the cards: the JAX package's error, exit code 1.
    count = torch.cuda.device_count()
    tp = max(2, count + 1)
    text = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(text), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            cli.main(["solve", str(project), "unused.npz", "--tp", str(tp)])
        except SystemExit as exc:
            code = exc.code
    want = f"--tp {tp} exceeds the {count} available device(s)"
    print(f"[sharded] cli solve --tp {tp}: exit {code}, "
          f"{text.getvalue().strip()!r}", flush=True)
    check(code == 1 and want in text.getvalue(),
          f"`solve --tp {tp}` did not end in {want!r}")
    out["cli_tp_error"] = want
    print(json.dumps(out), flush=True)
    return {"k1": k1, "k2": k2, "k3": k3s, "launches": launches,
            "ell_launches": ell_launches}


# Phase variants: the JAX package's A/B alternatives of the DIA solve,
# each a DiaBorderedSolver argument, beside the defaults.
VARIANTS = (("default", {}), ("cheb=3", {"cheb": 3}),
            ("cheb_deep=3", {"cheb_deep": 3}),
            ("smooth_steps=2", {"smooth_steps": 2}),
            ("cycle_lumped=False", {"cycle_lumped": False}),
            ("coarse=device", {"coarse": "device"}),
            ("w_levels=0", {"w_levels": 0}))
JACOBI_MESH = 0.15   # mm: the small boards meshed to 4,724-7,056 unknowns


class SolverSpy:
    """Keeps every ops.schur.DiaBorderedSolver built while it is entered
    (solve_bordered gives back none), by standing in for the class."""

    def __enter__(self):
        from padne_tpu_torch.ops import schur

        self.real = schur.DiaBorderedSolver
        self.solvers = []

        def recording(*args, **kw):
            self.solvers.append(self.real(*args, **kw))
            return self.solvers[-1]

        schur.DiaBorderedSolver = recording
        return self

    def __exit__(self, *exc):
        from padne_tpu_torch.ops import schur

        schur.DiaBorderedSolver = self.real


def variants_phase(cli_run: dict, ctx: dict, tmp: pathlib.Path) -> dict:
    """Phase variants: each setting of VARIANTS as a DiaBorderedSolver of
    phase cli's assembled system (not meshed again), solved once to the
    1e-10 target: residual <= 1e-9, potentials within 1e-7 x span of
    phase cli's, every launched K1'/K2' shape held against its plain
    version (cycle_lumped=False's exact level-0 bf16 operator also
    timed).  Per setting: set-up and solve seconds, CG iterations,
    passes, residual, K1' launches, device events and kernel ms per CG
    iteration (profiled apart from the timed solve: the profiler slows
    what it traces) and where the coarse inverse was built.  Then solve_bordered with
    precond="jacobi" on the smallest of the four small boards above
    5,000 unknowns at JACOBI_MESH (its K3' shapes held, within 1e-6 V
    of spsolve), and solve_bordered(dia_shard_min=512) on phase 6's
    system over phase sharded's mesh (at least 2 sharded levels, its
    K1'/K2' shapes held, within 1e-7 x span of phase 6's solve)."""
    import numpy as np
    import scipy.sparse.linalg
    import torch

    from padne_tpu_torch import kicad, mesh, solver
    from padne_tpu_torch.ops import schur
    from padne_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    card = smi()
    system, ref = cli_run["system"], cli_run["bordered"]
    span = float(ref.v.max() - ref.v.min())
    out = {"phase": "variants", "card": card, "n": system.n,
           "settings": {}}
    k1, k2 = [], []
    launches = {"dia_sell": 0, "comp_sell": 0, "ell_spmv": 0}
    for i, (name, kw) in enumerate(VARIANTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = schur.DiaBorderedSolver(system, device=DEV, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        spy = DiaShapes()
        t0 = time.perf_counter()
        with spy as shapes:
            sol = s.solve(target_residual=1e-10)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        got = launch_counts()
        for key in launches:
            launches[key] += got[key]
        cases, case2 = dia_cases(s, f"variants {name} ", 61 + 100 * i,
                                 timed=False)
        exact = None
        if "sm" in s.cycle_params[0]:
            # The exact level-0 operator in bf16: a K1' instantiation no
            # other phase launches; timed at both widths.
            l0 = s.cycle_params[0]
            exact = []
            for width in (s.m + 1, 1):
                exact.append(k1_case(f"variants {name} l0 exact bf16 "
                                     "cycle operator", l0, width,
                                     97 + width))
                exact[-1]["launches"] = spy.by_params[id(l0), width]
            cases += exact
        k1 += cases
        k2.append(case2)
        check_dia_held(f"variants {name}", shapes, got, cases, [case2])
        # Device events and kernel ms per CG iteration: the solver's CG
        # at R = 1 (the refinement passes' width) run to 10 and to 30
        # iterations (tol 0), each profiled; the difference over 20
        # leaves out the set-up and the final residual of a call.
        t0 = time.perf_counter()
        b1 = torch.randn(s.np0, 1, device=DEV, generator=torch.Generator(
            device=torch.device(DEV)).manual_seed(7))
        runs = [device_events(lambda k=k: s.cg_solver(b1, 0.0, k))
                for k in (10, 30)]
        check([r[2].iterations for r in runs] == [10, 30],
              f"variants {name}: the profiled CG stopped early")
        profile_s = time.perf_counter() - t0
        dv = float(np.abs(sol.v - ref.v).max())
        row = {"setup_s": setup_s, "solve_s": solve_s,
               "cg_iterations": sol.cg_iterations,
               "refinement_passes": sol.refinement_steps + 1,
               "residual_norm": sol.residual_norm, "max_dv_vs_cli": dv,
               "k1_launches": got["dia_sell"],
               "k2_launches": got["comp_sell"],
               "events_per_iteration": (runs[1][0] - runs[0][0]) / 20,
               "kernel_ms_per_iteration": (runs[1][1] - runs[0][1]) / 20,
               "profile_s": profile_s, "coarse": s.coarse,
               "levels": [lv.pack.np_ for lv in s.hierarchy.levels]}
        if exact is not None:
            row["l0_exact_k1"] = {c["name"]: {
                k: c[k] for k in ("graph_ms", "bound_ms", "library_ms",
                                  "library_graph_ms", "launches")}
                for c in exact}
        out["settings"][name] = row
        print(f"[variants] {name}: set-up {setup_s:.2f} s solve "
              f"{solve_s:.2f} s cg_iterations={sol.cg_iterations} "
              f"passes={sol.refinement_steps + 1} residual_norm="
              f"{sol.residual_norm:.3e} max|dV| vs cli {dv:.3e} V "
              f"K1'={got['dia_sell']} K2'={got['comp_sell']} "
              f"{row['events_per_iteration']:.1f} device events and "
              f"{row['kernel_ms_per_iteration']:.3f} ms of kernels per CG "
              f"iteration coarse={s.coarse}; card {card}", flush=True)
        check(got["dia_sell"] > 0 and got["comp_sell"] > 0
              and got["ell_spmv"] == 0,
              f"variants {name}: not on K1' and K2' alone")
        check(sol.residual_norm <= 1e-9,
              f"variants {name}: residual {sol.residual_norm:.3e}")
        check(dv <= 1e-7 * span, f"variants {name}: potentials {dv:.3e} V "
                                  "from phase cli's")
        check(s.coarse == ("device" if kw.get("coarse") == "device"
                           else "host")
              or s.coarse == "host (validation)" and "coarse" in kw,
              f"variants {name}: coarse inverse built on {s.coarse}")
        del s, sol, runs
        torch.cuda.empty_cache()

    # precond="jacobi" on the ELL route above the AMG threshold.
    gen = boardgen()
    jtmp = tmp / "jacobi"
    cfg = mesh.Mesher.Config(maximum_size=JACOBI_MESH,
                             variable_size_maximum_factor=1.0)
    small = []
    for name in SMALL_BOARDS:
        getattr(gen, name)(jtmp)
        prob = kicad.load_kicad_project(jtmp / name / f"{name}.kicad_pro")
        small.append((solver.build_system(prob, cfg)[0], name))
    sizes = {name: sys_.n for sys_, name in small}
    jsys, jname = min(((s_, n_) for s_, n_ in small if s_.n > 5000),
                      key=lambda t: t[0].n)
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    with K3Shapes() as k3_shapes:
        sol = schur.solve_bordered(jsys, precond="jacobi",
                                   inner_dtype=torch.float32, device=DEV,
                                   stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    for key in launches:
        launches[key] += got[key]
    L, r, *_ = schur.bordered_scipy_system(jsys)
    dv = float(np.abs(sol.v - scipy.sparse.linalg.spsolve(L, r)[:jsys.n])
               .max())
    ell = (jsys.ell.cols, jsys.ell.vals, jsys.ell.diag, jsys.n)
    k3_gen = torch.Generator(device=torch.device(DEV)).manual_seed(71)
    k3 = []
    for key, count in sorted(k3_shapes.items(), key=lambda kv: -kv[1]):
        n_, nx_, r_, kind, form = key
        check(n_ == nx_ == jsys.n, f"Jacobi solve: K3' on {key}, not A")
        case = k3_case(f"jacobi A ({jname}) {kind} R={r_}", ell,
                       getattr(torch, kind), r_, form, k3_gen)
        check(case["key"] == key, f"Jacobi solve: {key} was not held")
        case["launches"] = count
        k3.append(case)
    print(f"[variants] precond=jacobi on {jname} (n={jsys.n}; the small "
          f"boards at {JACOBI_MESH} mm: {sizes}): route={stats['route']} "
          f"levels={stats['levels']} escalated={stats['escalated']} "
          f"{wall:.2f} s cg_iterations={sol.cg_iterations} passes="
          f"{sol.refinement_steps + 1} residual_norm={sol.residual_norm:.3e}"
          f" max|dV| vs spsolve={dv:.3e} V launches={got}", flush=True)
    check(stats["route"] == "ell" and not stats["levels"],
          "precond='jacobi' did not take the Jacobi ELL route")
    check(got["ell_spmv"] > 0 and got["dia_sell"] == got["comp_sell"] == 0,
          "the Jacobi solve did not run on K3' alone")
    check(sol.residual_norm < 1e-9 and dv <= 1e-6,
          f"Jacobi solve: residual {sol.residual_norm:.3e}, |dV| {dv:.3e}")
    out["jacobi"] = {"board": jname, "n": jsys.n, "mesh_mm": JACOBI_MESH,
                     "small_board_sizes": sizes, "wall_s": wall,
                     "cg_iterations": sol.cg_iterations,
                     "refinement_passes": sol.refinement_steps + 1,
                     "escalated": stats["escalated"],
                     "residual_norm": sol.residual_norm,
                     "max_dv_vs_spsolve": dv, "launches": got,
                     "k3": {c["name"]: {k: c[k] for k in (
                         "graph_ms", "bound_ms", "library_ms",
                         "library_graph_ms", "launches")} for c in k3}}

    # dia_shard_min=512 over phase sharded's mesh.
    msys = ctx["scipy_system"]
    mref = ctx["scipy_bordered"]
    smesh = sharding.Mesh([torch.device(DEV, 0)] * SHARDS)
    reset_counts()
    stats = {}
    t0 = time.perf_counter()
    with SolverSpy() as built, DiaShapes() as shapes:
        sol = schur.solve_bordered(msys, inner_dtype=torch.float32,
                                   mesh=smesh, dia_shard_min=512,
                                   stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    for key in launches:
        launches[key] += got[key]
    s = built.solvers[-1]
    sk1, sk2 = sharded_dia_cases(s, 81, timed=False)
    k1 += sk1
    k2 += sk2
    check_dia_held("variants dia_shard_min=512", shapes, got, sk1, sk2)
    mspan = float(mref.v.max() - mref.v.min())
    dv = float(np.abs(sol.v - mref.v).max())
    levels = [(lv.pack.np_, lv.shard) for lv in s.hierarchy.levels]
    print(f"[variants] solve_bordered(dia_shard_min=512) n={msys.n} over "
          f"{SHARDS} shards: route={stats['route']} levels (rows, sharded) "
          f"{levels}, {s.n_sharded} sharded in the cycle, {wall:.2f} s "
          f"cg_iterations={sol.cg_iterations} passes="
          f"{sol.refinement_steps + 1} residual_norm={sol.residual_norm:.3e}"
          f" max|dV| vs phase 6 {dv:.3e} V launches={got}", flush=True)
    check(stats["route"] == "dia" and stats["sharded"] and s.n_sharded >= 2,
          f"dia_shard_min=512 did not shard 2 levels: {levels}")
    check(sol.residual_norm <= 1e-9 and dv <= 1e-7 * max(mspan, 1.0),
          f"dia_shard_min=512: residual {sol.residual_norm:.3e}, "
          f"|dV| {dv:.3e} V")
    out["dia_shard_min_512"] = {
        "n": msys.n, "levels": levels, "sharded_levels": s.n_sharded,
        "wall_s": wall, "cg_iterations": sol.cg_iterations,
        "refinement_passes": sol.refinement_steps + 1,
        "residual_norm": sol.residual_norm, "max_dv_vs_phase_6": dv,
        "launches": got}
    del s, built, sol
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps(out), flush=True)
    return {"k1": k1, "k2": k2, "k3": k3, "launches": launches}


DP_TP = (2, 4)       # phase dp_tp: dp rows x tp shards of the one card
DP_TP_BATCH = 4      # systems of the batched solve: conductance 1 + 0.5 b
DP_TP_ITERS = 200
# Where phase dp_tp holds the sharded solvers against one device.  Two
# f64 CG runs whose dots only sum in another order (the psum of shard
# partials) agree to rounding for the first ~50 iterations on phase
# cli's system, then part as CG loses orthogonality (2.4e-4 of max|x|
# after 200 on an NVIDIA H100 80GB HBM3 at 700 W), while one device
# against itself stays bit-equal.  The phase prints the distance at
# each count of DP_TP_CURVE.
DP_TP_CHECK_ITERS = 50
DP_TP_CURVE = (25, 50, 100, 150, 200)
# What rounding does not part: after DP_TP_ITERS each system's
# |b - A x| / |b| is within this fraction of the one-device run's.
DP_TP_RES_SPREAD = 0.05


def dp_tp_batch(system, seed: int = 1):
    """The batch of phase dp_tp on `system`'s core Laplacian, as
    __graft_entry__.dryrun_multichip builds it: DP_TP_BATCH conductance
    scales 1 + 0.5 b of one structure, each with R = 2 balanced
    source/sink columns (a source and a sink of one copper component, so
    that the singular system is consistent).  Returns (the batch as an
    EllMatrix, b (B, n, 2), the scales)."""
    import numpy as np

    from padne_tpu_torch.ops import assembly

    ell, n = system.ell, system.n
    scales = 1.0 + 0.5 * np.arange(DP_TP_BATCH)
    rng = np.random.default_rng(seed)
    b = np.zeros((DP_TP_BATCH, n, 2))
    for col in np.ndindex(DP_TP_BATCH, 2):
        i = int(rng.integers(n))
        same = np.flatnonzero(system.comp_id == system.comp_id[i])
        j = int(same[rng.integers(len(same))])
        b[col[0], i, col[1]] += 1.0
        b[col[0], j, col[1]] -= 1.0
    batch = assembly.EllMatrix(cols=ell.cols,
                               vals=ell.vals[None] * scales[:, None, None],
                               diag=ell.diag[None] * scales[:, None])
    return batch, b, scales


class SyncForbidden:
    """While entered, a call that makes the host wait for the card raises
    (torch.cuda.set_sync_debug_mode("error"))."""

    def __enter__(self):
        import torch

        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")


def device_events(fn) -> tuple[int, float, object]:
    """(device events, ms of kernels, fn's result) of one call of fn
    under torch.profiler: kernels and copies on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = sum(e.time_range.elapsed_us() for e in events
             if not e.name.startswith(("Memcpy", "Memset"))) / 1e3
    return len(events), ms, out


def dp_tp_solvers(system, k3_shapes, repeats: dict) -> dict:
    """Part A of phase dp_tp: parallel.sharding's standalone solvers at
    the main path's width (phase cli's system): batched_sharded_cg of
    DP_TP_BATCH conductance scales on a dp x tp mesh of the one card and
    sharded_cg of the scale-1 system on one dp row, DP_TP_ITERS
    iterations each with no synchronizing call inside either loop, K3'
    held at every shape launched (k3_shapes: the phase's K3Shapes
    counter).  Both are held against sharded_cg on one device: x after
    DP_TP_CHECK_ITERS iterations, and |b - A x| / |b| after DP_TP_ITERS
    (within DP_TP_RES_SPREAD), where rounding has parted the x (see
    DP_TP_CHECK_ITERS) and their distance is printed.  Phase repeat:
    the batched solver's first call against its profiled second (into
    `repeats`)."""
    import contextlib

    import numpy as np
    import torch

    from padne_tpu_torch.ops import amg, assembly
    from padne_tpu_torch.parallel import sharding

    dp, tp = DP_TP
    f64, iters = torch.float64, DP_TP_ITERS
    dev = torch.device(DEV, 0)
    mesh = sharding.Mesh([dev] * (dp * tp), dp=dp)
    one = sharding.Mesh([dev])
    ell, n = system.ell, system.n
    batch, b, scales = dp_tp_batch(system)
    n_pad = n + (-n) % tp

    # K3' at the phase's two shapes: a shard's rows over the gathered
    # vector (every shard and system of both solvers) and the whole
    # operator (the one-device references), f64, R = 2.
    gen = torch.Generator(device=dev).manual_seed(17)
    cases = []
    for name, rows, count in (("dp_tp A shard 0", n_pad, tp),
                              ("dp_tp A one device", n, 1)):
        c, v = amg.shard_rows(ell.cols, ell.vals, ell.diag, rows, count)[0]
        cases.append(k3_case(name, (c, v, None, rows), f64, 2, "plain",
                             gen))
    torch.cuda.empty_cache()
    held = {c["key"]: c["name"] for c in cases}

    def timed(fn, guard=contextlib.nullcontext):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with guard():
            out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    launches = {"dia_sell": 0, "comp_sell": 0, "ell_spmv": 0}

    def counted(fn):
        reset_counts()
        out = fn()
        for key, count in launch_counts().items():
            launches[key] += count
        return out

    torch.cuda.reset_peak_memory_stats()
    placed, setup_s = timed(
        lambda: sharding.prepare_sharded_system(batch, b, mesh))
    single = assembly.EllMatrix(cols=ell.cols, vals=ell.vals, diag=ell.diag)
    placed1, setup1_s = timed(
        lambda: sharding.prepare_sharded_system(single, b[0], mesh))

    def batched(k=iters):
        return sharding.batched_sharded_cg(mesh, *placed, iters=k)

    def row(k=iters):
        return sharding.sharded_cg(mesh, *placed1, iters=k)

    x, wall = timed(lambda: counted(batched), SyncForbidden)
    check(launches["ell_spmv"] == iters * DP_TP_BATCH * tp,
          f"batched_sharded_cg launched K3' {launches['ell_spmv']} times, "
          "not once per iteration, shard and system")
    x1, wall1 = timed(lambda: counted(row), SyncForbidden)
    check(launches["ell_spmv"] == iters * (DP_TP_BATCH + 1) * tp,
          "sharded_cg did not launch K3' once per iteration and shard")
    # Device events and kernel time of one whole call each, under the
    # profiler (its set-up and gather are a few events of thousands).
    events, kernel_ms, x2 = device_events(batched)
    x2 = x2.cpu().numpy()   # phase repeat's; off the card before the peak
    events1, _, _ = device_events(row)
    early = counted(lambda: batched(DP_TP_CHECK_ITERS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    a0 = ell.to_scipy()

    def rel_residual(j, xj):
        return float(np.linalg.norm(b[j] - scales[j] * (a0 @ xj))
                     / np.linalg.norm(b[j]))

    def dist(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    gap, gap_late, rel_res, ref_res, curve = [], [], [], [], {}
    for j in range(DP_TP_BATCH):
        system_j = assembly.EllMatrix(cols=ell.cols, vals=batch.vals[j],
                                      diag=batch.diag[j])
        placed_j = sharding.prepare_sharded_system(system_j, b[j], one)
        ref = {k: counted(lambda k=k: sharding.sharded_cg(
            one, *placed_j, iters=k))[:n].cpu().numpy()
            for k in (DP_TP_CURVE if j == 0 else (DP_TP_CHECK_ITERS, iters))}
        del placed_j
        got = [early[j, :n].cpu().numpy()]
        late = [x[j, :n].cpu().numpy()]
        if j == 0:
            # sharded_cg on one dp row (system 0) against one device, by
            # the iteration count: where the two runs part.
            curve = {k: dist(counted(lambda k=k: row(k))[:n].cpu().numpy(),
                             ref[k]) for k in DP_TP_CURVE}
            late.append(x1[:n].cpu().numpy())
        gap.append(max([dist(g, ref[DP_TP_CHECK_ITERS]) for g in got]
                       + ([curve[DP_TP_CHECK_ITERS]] if j == 0 else [])))
        gap_late.append(max(dist(g, ref[iters]) for g in late))
        check(gap[-1] <= 1e-9, f"system {j} after {DP_TP_CHECK_ITERS} "
                               f"iterations is {gap[-1]:.3e} of max|x| "
                               "from the one-device run")
        # Batched (and for system 0 sharded_cg) against one device.
        ref_res.append(rel_residual(j, ref[iters]))
        rel_res.append([rel_residual(j, g) for g in late])
        check(np.isfinite(late).all() and all(
            abs(r / ref_res[-1] - 1.0) <= DP_TP_RES_SPREAD
            for r in rel_res[-1]),
            f"system {j}: |b - A x| / |b| "
            f"{', '.join(f'{r:.4e}' for r in rel_res[-1])} after {iters} "
            f"iterations, one device {ref_res[-1]:.4e}")
    hold_repeats(repeats, f"batched_sharded_cg n={n} B={DP_TP_BATCH} "
                          f"dp {dp} x tp {tp}", [
        fingerprint(label, iters, None, [
            rel_residual(j, xs[j, :n]) for j in range(DP_TP_BATCH)], xs)
        for label, xs in (("call 1", x.cpu().numpy()),
                          ("call 2 (profiled)", x2))])
    del placed, placed1, x2
    torch.cuda.empty_cache()
    missing = sorted(set(k3_shapes) - set(held))
    check(not missing, f"phase dp_tp launched K3' at shapes that were not "
                       f"held against the plain version: {missing}")
    check(launches["dia_sell"] == launches["comp_sell"] == 0,
          "the standalone solvers launched a DIA kernel")
    wall_it_ms = wall / iters * 1e3
    out = {"n": n, "n_pad": n_pad, "dp": dp, "tp": tp,
           "batch": DP_TP_BATCH, "r": 2, "dtype": "f64", "iters": iters,
           "setup_s": setup_s, "wall_s": wall,
           "wall_ms_per_iteration": wall_it_ms,
           "k3_launches_per_iteration": DP_TP_BATCH * tp,
           "device_events_per_iteration": events / iters,
           "host_us_per_launch": wall * 1e6 / events,
           "busy_share": kernel_ms / (wall * 1e3),
           "rel_residual": [r[0] for r in rel_res],
           "rel_residual_one_device": ref_res,
           "sharded_cg_rel_residual": rel_res[0][1],
           "check_iters": DP_TP_CHECK_ITERS,
           "max_dx_vs_one_device": max(gap),
           "max_dx_vs_one_device_after_iters": max(gap_late),
           "sharded_cg_dx_vs_one_device_by_iters": curve,
           "peak_device_memory_gb": peak,
           "sharded_cg": {"setup_s": setup1_s, "wall_s": wall1,
                          "wall_ms_per_iteration": wall1 / iters * 1e3,
                          "device_events_per_iteration": events1 / iters},
           "k3_cases": {c["name"]: {k: c[k] for k in (
               "ms", "graph_ms", "plain_ms", "bound_ms", "library_ms",
               "library_graph_ms")} for c in cases}}
    print(f"[dp_tp] batched_sharded_cg n={n} dp {dp} x tp {tp} B="
          f"{DP_TP_BATCH} R=2 f64 {iters} iterations: set-up {setup_s:.2f} "
          f"s, {wall_it_ms:.3f} ms an iteration ({wall:.3f} s), K3' "
          f"{DP_TP_BATCH * tp} and device events {events / iters:.1f} an "
          f"iteration, host {out['host_us_per_launch']:.2f} us a device "
          f"event, busy share {out['busy_share']:.3f} (profiled kernel "
          f"time of a second call over this call's wall), |b - A x| / |b| "
          f"{', '.join(f'{r[0]:.4e}' for r in rel_res)} (one device "
          f"{', '.join(f'{r:.4e}' for r in ref_res)}); sharded_cg on one "
          f"dp row: set-up {setup1_s:.2f} s, {wall1 / iters * 1e3:.3f} ms "
          f"an iteration, device events {events1 / iters:.1f} an "
          f"iteration, |b - A x| / |b| {rel_res[0][1]:.4e}; "
          f"max|dx| vs one device {max(gap):.3e} of max|x| after "
          f"{DP_TP_CHECK_ITERS} iterations, {max(gap_late):.3e} after "
          f"{iters}; sharded_cg's by iterations "
          f"{', '.join(f'{k}: {v:.3e}' for k, v in curve.items())}; no "
          f"synchronizing call in either loop; peak device memory "
          f"{peak:.3f} GB", flush=True)
    return {"out": out, "cases": cases, "launches": launches}


def dp_tp_replicas(system, seed: int = 41) -> dict:
    """Part B of phase dp_tp: the dp x tp layout of the DIA production
    path (__graft_entry__.dryrun_multichip, JAX
    test_dp_x_tp_production_replicas) on `system` (phase 6's): the rows
    of a dp x tp mesh of the one card as replicas, each a
    DiaBorderedSolver over its own row for the system at conductance
    scale 1 + d, each against the one-device solve of its own scaled
    system; every K1'/K2' shape that any of the solves launches held
    against the plain version."""
    import dataclasses

    import numpy as np
    import torch

    from padne_tpu_torch.ops import assembly, schur
    from padne_tpu_torch.parallel import sharding

    dp, tp = DP_TP
    mesh = sharding.Mesh([torch.device(DEV, 0)] * (dp * tp), dp=dp)
    k1, k2, replicas, solved = [], [], [], []
    for d, row in enumerate(mesh.grid):
        ell = system.ell
        scaled = dataclasses.replace(system, ell=assembly.EllMatrix(
            cols=ell.cols, vals=ell.vals * (1.0 + d),
            diag=ell.diag * (1.0 + d)))
        t0 = time.perf_counter()
        s = schur.DiaBorderedSolver(scaled, mesh=sharding.Mesh(row))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(s.sharded, f"replica {d} did not shard")
        ref = schur.DiaBorderedSolver(scaled, device=DEV)
        for cases in (sharded_dia_cases(s, seed, timed=False),
                      dia_cases(ref, f"dp_tp one-device x{1.0 + d} ",
                                seed + 50, timed=False)):
            k1 += cases[0]
            k2 += cases[1] if isinstance(cases[1], list) else [cases[1]]
        seed += 100
        replicas.append((s, ref, scaled.n, setup_s))
    reset_counts()
    with DiaShapes() as shapes:
        for d, (s, ref, n, setup_s) in enumerate(replicas):
            t0 = time.perf_counter()
            sol = s.solve()
            solve_s = time.perf_counter() - t0
            one = ref.solve()
            dv = float(np.abs(sol.v - one.v).max())
            dj = float(np.abs(sol.j - one.j).max() / np.abs(one.j).max())
            solved.append({"scale": 1.0 + d, "sharded_levels": s.n_sharded,
                           "levels": [(lv.pack.np_, lv.shard)
                                      for lv in s.hierarchy.levels],
                           "setup_s": setup_s, "solve_s": solve_s,
                           "cg_iterations": sol.cg_iterations,
                           "residual_norm": sol.residual_norm,
                           "max_dv_vs_one_device": dv,
                           "max_dj_rel_vs_one_device": dj})
            print(f"[dp_tp] DIA replica {d} (row {d} of dp {dp} x tp {tp}, "
                  f"conductance x{1.0 + d}) n={n}: "
                  f"{s.n_sharded} sharded levels {solved[-1]['levels']}, "
                  f"set-up {setup_s:.2f} s, solve {solve_s:.2f} s, "
                  f"cg_iterations={sol.cg_iterations} residual_norm="
                  f"{sol.residual_norm:.3e} max|dV| vs one device {dv:.3e} "
                  f"V, max|dj|/max|j| {dj:.3e}", flush=True)
            check(sol.residual_norm < 1e-9,
                  f"replica {d}: residual {sol.residual_norm:.3e}")
            check(dv <= 1e-9, f"replica {d}: |dV| {dv:.3e} V from its "
                              "one-device solve")
        launches = launch_counts()
    check(launches["ell_spmv"] == 0, "the DIA replicas launched K3'")
    by_shape = check_dia_held("dp_tp", shapes, launches, k1, k2)
    del replicas
    torch.cuda.empty_cache()
    return {"replicas": solved, "launches": launches,
            "launches_by_shape": by_shape, "k1": k1, "k2": k2}


def dp_tp_phase(cli_system, scipy_system, repeats: dict) -> dict:
    """Phase dp_tp: part A (`dp_tp_solvers`) on phase cli's system, part
    B (`dp_tp_replicas`) on phase 6's."""
    out = {"phase": "dp_tp", "card": smi()}
    with K3Shapes() as k3_shapes:
        part_a = dp_tp_solvers(cli_system, k3_shapes, repeats)
    part_b = dp_tp_replicas(scipy_system)
    launches = {k: part_a["launches"][k] + part_b["launches"][k]
                for k in part_a["launches"]}
    out.update(solvers=part_a["out"], replicas=part_b["replicas"],
               launches=launches,
               dia_launches_by_shape=part_b["launches_by_shape"])
    print(json.dumps(out), flush=True)
    return {"k1": part_b["k1"], "k2": part_b["k2"], "k3": part_a["cases"],
            "launches": launches}


def fragmented_phase(args) -> dict:
    """Phase 10: more than 63 copper components on the DIA route."""
    import torch

    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur

    t0 = time.perf_counter()
    prob, cfg = fragmented_problem(args.frag_dof)
    system = solver.build_system(prob, cfg)[0]
    n, m, p = system.n, system.border.m, system.num_components
    print(f"[fragmented] n={n} m={m} components={p} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(p >= 100 and p + 1 > 64, f"only {p} copper components")
    s = schur.DiaBorderedSolver(system, device=DEV)
    k1, k2 = dia_cases(s, "fragmented ", 11)
    del s, system
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = {}
    with DiaShapes() as shapes:
        sol = solver.solve(prob, mesher_config=cfg,
                           check_against_scipy=True, stats=stats)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    info = sol.solver_info
    dv = stats["scipy_max_dv"]
    print(f"[fragmented] route={stats['route']} n={stats['n']} "
          f"m={stats['m']} components={p} levels={stats['levels']} "
          f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
          f"setup={stats['setup_s']:.2f}s solve={stats['solve_s']:.2f}s "
          f"cg_iterations={info.cg_iterations} "
          f"refinement_passes={info.refinement_steps + 1} "
          f"residual_norm={info.residual_norm:.3e} "
          f"max|dV| vs spsolve={dv:.3e} V "
          f"peak_device_memory={peak_gb:.3f} GB launches={launches}",
          flush=True)
    check(stats["route"] == "dia", f"route {stats['route']} is not dia")
    check(stats["n"] >= MIN_FRAG_N, f"n={stats['n']} is under {MIN_FRAG_N}")
    for k in ("dia_sell", "comp_sell"):
        check(launches[k] > 0, f"the fragmented solve never launched {k}")
    check(launches["ell_spmv"] == 0, "the DIA route launched K3'")
    by_shape = check_dia_held("fragmented", shapes, launches, k1, [k2])
    check(info.residual_norm < 1e-9,
          f"residual {info.residual_norm:.3e} misses the 1e-9 gate")
    check(dv <= 1e-6, f"max |dV| {dv:.3e} V vs scipy exceeds 1e-6 V")
    pots = [pot.values for ls in sol.layer_solutions for pot in ls.potentials]
    check(len(pots) == p and all(len(v) and (v == v).all() for v in pots),
          "a tile has no finite potentials")
    out = {"phase": "fragmented", "route": stats["route"], "n": stats["n"],
           "m": stats["m"], "components": p, "levels": stats["levels"],
           "residual_norm": info.residual_norm, "max_dv_vs_spsolve": dv,
           "cg_iterations": info.cg_iterations,
           "refinement_passes": info.refinement_steps + 1,
           "launches": launches, "launches_by_shape": by_shape,
           "setup_s": stats["setup_s"],
           "solve_s": stats["solve_s"], "peak_device_memory_gb": peak_gb,
           "k1_ms": {c["name"].removeprefix("fragmented "): c["ms"]
                     for c in k1},
           "k1_graph_ms": {c["name"].removeprefix("fragmented "):
                           c["graph_ms"] for c in k1},
           "k2_ms": k2["ms"], "k2_graph_ms": k2["graph_ms"]}
    print(json.dumps(out), flush=True)
    return {"k1": k1, "k2": k2, "launches": launches}


class ServeSpy:
    """Records each solve request the resident server answers (n, ok,
    setup_seconds, solve_seconds) while it is entered, by standing in
    for padne_tpu_torch.serve._handle_solve."""

    def __enter__(self):
        from padne_tpu_torch import serve

        self.real = serve._handle_solve
        self.records = []

        def recording(z, *args):
            reply = self.real(z, *args)
            r = serve._unpack(reply)
            ok = bool(int(r["ok"]))
            self.records.append({
                "n": int(z["n"]), "ok": ok,
                "setup_s": float(r["setup_seconds"]) if ok else None,
                "solve_s": float(r["solve_seconds"]) if ok else None})
            return reply

        serve._handle_solve = recording
        return self.records

    def __exit__(self, *exc):
        from padne_tpu_torch import serve

        serve._handle_solve = self.real


def client_run(argv, cwd: pathlib.Path, env: dict, what: str):
    """`python -m padne_tpu_torch argv` in a fresh process; fails the
    run on a non-zero exit.  Returns (wall seconds, its log, the
    timeline of its log: see `timeline`)."""
    start, t0 = time.time(), time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "padne_tpu_torch", *argv],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n",
              file=sys.stderr)
    check(proc.returncode == 0, f"{what} exited {proc.returncode}")
    text = proc.stdout + proc.stderr
    return wall, text, timeline(text, start)


def timeline(text: str, start: float) -> list:
    """[seconds after `start`, message] of each line a client's command
    line interface, solver or server client logged: where its wall time
    went (interpreter and imports before the first line)."""
    import datetime
    import re

    out = []
    for line in text.splitlines():
        m = re.match(r"(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) - "
                     r"padne_tpu_torch\.(cli|solver|serve) - INFO - (.*)",
                     line)
        if m:
            at = datetime.datetime.strptime(
                m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            out.append([round(at - start, 2), m.group(3)[:80]])
    return out


def potentials_of(path: pathlib.Path):
    """(all potentials, solver info, Solution) of an artifact."""
    import numpy as np

    from padne_tpu_torch.io import solution as solution_io

    sol = solution_io.load_solution(path)
    v = np.concatenate([p.values for ls in sol.layer_solutions
                        for p in ls.potentials])
    return v, sol.solver_info, sol


def short_socket(tmp: pathlib.Path) -> tuple[str, str | None]:
    """(socket path, a directory to remove after) under `tmp`, or in a
    fresh temporary directory when that path would pass the 107 bytes a
    unix socket's path may have."""
    path = str(tmp / "serve.sock")
    if len(path.encode()) <= 100:
        return path, None
    extra = tempfile.mkdtemp(prefix="pts")
    return str(pathlib.Path(extra) / "serve.sock"), extra


def serve_phase(tmp: pathlib.Path, ctx: dict, k1, k2) -> dict:
    """Phase 12: the resident solve server on the card.  A cold `solve`
    of phase 6's project in a fresh process with no server, then the
    server as a thread of this process (so the counters and DiaShapes
    see its launches), `solve` and `gui` through it in fresh processes,
    `show` on the served artifact, and in this process the scipy check's
    system twice, the second time with its excitation doubled.  k1, k2:
    the K1' and K2' cases of phases 3, 4 and 6."""
    import dataclasses
    import os
    import shutil
    import threading

    import numpy as np
    import scipy.sparse.linalg
    import torch

    from padne_tpu_torch import serve
    from padne_tpu_torch.ops import schur

    pro, flags, ref_v = str(ctx["project"]), ctx["flags"], ctx["ref_v"]
    sock, extra_dir = short_socket(tmp)
    env = dict(os.environ, PADNE_TORCH_SOCKET=sock, PADNE_TORCH_SERVER="1",
               MPLBACKEND="Agg", PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    walls, lines = {}, {}
    try:
        check(serve.ping(sock) is None, "a server answers before the phase")
        cold = tmp / "cold.npz"
        walls["cold_solve_s"], _, lines["cold solve"] = client_run(
            ["solve", pro, str(cold), *flags], tmp, env, "the cold `solve`")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ready = threading.Event()
        with ServeSpy() as records, DiaShapes() as shapes:
            daemon = threading.Thread(
                target=serve.serve, daemon=True,
                kwargs={"socket_path": sock, "ready_event": ready})
            daemon.start()
            check(ready.wait(60), "the server did not come up")
            info = serve.ping(sock)
            check(info is not None and info["pid"] == os.getpid()
                  and info["device"] == torch.device(DEV).type,
                  f"the server's ping answered {info}")
            served = tmp / "served.npz"
            walls["served_solve_s"], log_solve, lines["served solve"] = \
                client_run(["solve", pro, str(served), *flags], tmp, env,
                           "`solve` through the server")
            (tmp / "gui").mkdir()
            walls["served_gui_s"], log_gui, lines["cached gui"] = client_run(
                ["gui", pro, *flags], tmp / "gui", env,
                "`gui` through the server")
            (tmp / "show").mkdir()
            walls["show_s"], _, lines["show"] = client_run(
                ["show", str(served)], tmp / "show", env, "`show`")

            system = ctx["scipy_system"]
            st1, st2 = {}, {}
            t0 = time.perf_counter()
            first = serve.client_solve(system, 1e-10, 8, socket_path=sock,
                                       device=DEV, stats=st1)
            walls["client_scipy_board_s"] = time.perf_counter() - t0
            doubled = dataclasses.replace(
                system, r_core=system.r_core * 2.0,
                border=dataclasses.replace(system.border,
                                           rhs=system.border.rhs * 2.0))
            t0 = time.perf_counter()
            second = serve.client_solve(doubled, 2e-10, 8, socket_path=sock,
                                        device=DEV, stats=st2)
            walls["client_scipy_board_doubled_s"] = time.perf_counter() - t0
            check(serve.shutdown(sock), "the server did not shut down")
            daemon.join(timeout=120)
            check(not daemon.is_alive(), "the server thread is still running")
        launches = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        if serve.ping(sock) is not None:
            serve.shutdown(sock)
        if extra_dir is not None:
            shutil.rmtree(extra_dir, ignore_errors=True)

    for name, marks in lines.items():
        print(f"[serve client {name}] " + "; ".join(
            f"+{at:.2f} s {msg}" for at, msg in marks), flush=True)
    for rec in records:
        print(f"[serve request] n={rec['n']} ok={rec['ok']} "
              f"setup_seconds={rec['setup_s']} "
              f"solve_seconds={rec['solve_s']}", flush=True)
    print("[serve] client processes: " + ", ".join(
        f"{k[:-2]} {v:.2f} s" for k, v in walls.items())
        + f"; server peak device memory {peak_gb:.3f} GB; launches "
        f"{launches}", flush=True)

    # Who solved: four answered requests on the one board, and the
    # clients said so.
    n = system.n
    check([(r["n"], r["ok"]) for r in records] == [(n, True)] * 4,
          f"the server did not answer every request: {records}")
    check(all("solved by the server (pid" in text
              for text in (log_solve, log_gui)),
          "a client process did not report a served solve")
    check(first is not None and second is not None
          and st1["served_by"] == st2["served_by"] == os.getpid(),
          "the in-process requests were not served")
    check(records[0]["setup_s"] > 0, "a new structure reported no set-up")
    check(records[1]["setup_s"] == 0.0 and records[3]["setup_s"] == 0.0
          and st2["setup_s"] == 0.0,
          "a repeat request on a structure paid a set-up")
    for k in ("dia_sell", "comp_sell"):
        check(launches[k] > 0, f"the server never launched {k}")
    check(launches["ell_spmv"] == 0, "the server launched K3'")
    by_shape = check_dia_held("serve", shapes, launches, k1, k2)

    # The answers.
    # The same code, board and card: the same bits as phase 6's.
    dv = {}
    for name, path in (("cold", cold), ("served", served)):
        v, solver_info, sol = potentials_of(path)
        dv[name] = float(np.abs(v - ref_v).max())
        check(v.dtype == ref_v.dtype and np.array_equal(v, ref_v),
              f"the {name} artifact's potentials are not phase 6's bit for "
              f"bit (max|dV| {dv[name]:.3e} V)")
        check(solver_info.residual_norm < 1e-9, f"the {name} solve's "
              f"residual {solver_info.residual_norm:.3e}")
    # `sol`: the served artifact, whose meshes gui's solve has too.
    check_html(tmp / "gui" / "padne_tpu_view.html", sol)
    check_html(tmp / "show" / "padne_tpu_view.html", sol)
    check(first.residual_norm < 1e-9 and second.residual_norm < 2e-9,
          "an in-process served solve misses the gate")
    lin = float(np.abs(second.v - 2.0 * first.v).max())
    L, r, *_ = schur.bordered_scipy_system(doubled)
    dv_scipy = float(np.abs(scipy.sparse.linalg.spsolve(L, r)[:n]
                            - second.v).max())
    print(f"[serve] max|dV| vs phase 6: cold {dv['cold']:.3e} V, served "
          f"{dv['served']:.3e} V; doubled excitation vs 2x the first "
          f"{lin:.3e} V, vs spsolve {dv_scipy:.3e} V", flush=True)
    check(lin <= 2e-6, f"the doubled excitation is {lin:.3e} V from 2x")
    check(dv_scipy <= 1e-6, f"the doubled solve is {dv_scipy:.3e} V from "
                            "spsolve")
    out = {"phase": "serve", **walls, "requests": records,
           "client_timelines": lines,
           "launches": launches, "launches_by_shape": by_shape,
           "peak_device_memory_gb": peak_gb, "max_dv_cold": dv["cold"],
           "max_dv_served": dv["served"], "doubled_vs_2x": lin,
           "doubled_vs_spsolve": dv_scipy}
    print(json.dumps(out), flush=True)
    return {"launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=1_000_000)
    ap.add_argument("--scipy-dof", type=int, default=200_000)
    ap.add_argument("--ell-dof", type=int, default=140_000)
    ap.add_argument("--frag-dof", type=int, default=200_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    print(smi().splitlines()[0], flush=True)

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
        # Phase repeat runs inside the phases whose systems and solvers
        # it reuses, and prints its line at the end.
        repeats = {}
        k1, k2, dia_launches, ctx = dia_phases(args, pathlib.Path(tmp),
                                               repeats)
        torch.cuda.empty_cache()
        k3, ell_launches, sweep, ell_run = ell_phases(
            args, pathlib.Path(tmp), repeats)
        torch.cuda.empty_cache()
        cli_run = ctx.pop("cli")
        sharded = sharded_phase(cli_run, ell_run, k3, ctx["project"],
                                repeats)
        del ell_run
        torch.cuda.empty_cache()
        variants = variants_phase(cli_run, ctx, pathlib.Path(tmp))
        torch.cuda.empty_cache()
        dp_tp = dp_tp_phase(cli_run.pop("system"), ctx["scipy_system"],
                            repeats)
        del cli_run
        torch.cuda.empty_cache()
        frag = fragmented_phase(args)
        torch.cuda.empty_cache()
        served = serve_phase(pathlib.Path(tmp), ctx, k1, k2)
        print(json.dumps({"phase": "repeat", "card": smi(), **repeats}),
              flush=True)

    def entry(name, source, replaces, launches, cases, main_case):
        # launches: on the first main path that runs the kernel (the cli
        # solve for K1' and K2', the ELL solve for K3'); launches_by_path:
        # on every path, each counted from 0.
        by_path = {"cli": dia_launches[name], "ell": ell_launches[name],
                   "sharded": sharded["launches"][name],
                   "sharded_ell": sharded["ell_launches"][name],
                   "variants": variants["launches"][name],
                   "dp_tp": dp_tp["launches"][name],
                   "fragmented": frag["launches"][name],
                   "sweep": sweep["launches"][name],
                   "serve": served["launches"][name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_by_path": by_path,
                "max_abs_err": max(c["abs_err"] for c in cases),
                **{key: main_case[key] for key in (
                    "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_graph_ms", "csr_bound_ms")}}

    kernels_line = {"kernels": [
        entry("dia_sell", "padne_tpu_torch/csrc/dia_sell.cu",
              "padne_tpu/ops/dia.py:802", dia_launches["dia_sell"],
              k1 + sharded["k1"] + dp_tp["k1"] + frag["k1"]
              + variants["k1"], k1[0]),
        entry("comp_sell", "padne_tpu_torch/csrc/dia_sell.cu",
              "padne_tpu/ops/comp.py:274", dia_launches["comp_sell"],
              k2 + sharded["k2"] + dp_tp["k2"] + [frag["k2"]]
              + variants["k2"], k2[0]),
        entry("ell_spmv", "padne_tpu_torch/csrc/ell_spmv.cu",
              "padne_tpu/ops/spmv_pallas.py:84, "
              "padne_tpu/ops/spmv_pallas.py:172",
              ell_launches["ell_spmv"],
              k3 + sharded["k3"] + dp_tp["k3"] + variants["k3"], k3[1]),
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
