#!/usr/bin/env python3
"""Where the port's device time goes: warm bordered solves of the
generated 4-layer bench board, one of them under torch.profiler, on one
NVIDIA GPU.

Run from the repository root:

    python3 trace_port.py [--dof 140000] [--warm 3] [--top 12]
                          [--trace out.json] [--tree DIR] [--sweep]
                          [--startup] [--tp N [--dp D]]

The board is meshed for --dof as chip_smoke.py sizes it; the auto route
picks DIA (n >= 200k) or ELL.  One solve runs first (kernel build,
first-call costs), then --warm solves untraced, then one under the
profiler.  Printed: each solve's wall time with and without its set-up
(setup_s of the solve's stats: hierarchy build and uploads), CG
iterations and refinement passes, and the least, median and largest
wall time without set-up of the untraced warm solves; for the traced
solve, split at the end of its set-up: the route, the summed device time
of kernels and of memory copies in the solve proper and in the set-up,
the kernels' share of the solve's wall time (busy share), the device
events (kernels and copies) of the solve proper in all and per CG
iteration, the peak device memory (set-up included), the time and calls
of each hand-written kernel (by its name in csrc/), and the solve's
device events by total time (calls, ms, share).

--sweep traces the design sweep instead (padne_tpu_torch.sweep.
solve_sweep with chip_smoke.py's 12 specs on the same board, whatever
its size: the sweep always runs the ELL operator in float64): one sweep
first, --warm untraced, one under the profiler.  Printed per sweep: the
wall times of meshing and assembly, of the set-up (hierarchy and
uploads), of the one multi-RHS CG and of the 12 recoveries, and the CG's
iterations; for the traced one the summed device time of kernels and
copies over the whole call, the kernels' share of the wall time after
assembly, K3''s time and calls, and the peak device memory.

--startup times instead what a fresh client process (`python -m
padne_tpu_torch solve ...`) pays before its first log line, step by
step, each in --warm + 1 fresh processes: the interpreter, `import
torch`, the CUDA context (a first tensor on the card), the imports of
the port's solve path, and the last two together; printed: the least,
median and largest wall time of each.

--tp N traces the bordered solve row-sharded over N shards of the one
card (parallel.sharding.Mesh naming cuda:0 N times), then
parallel.sharding.batched_sharded_cg on the same board: chip_smoke.py's
batch of 4 conductance scales (R = 2, f64, 200 iterations) over a mesh of
--dp rows of N shards (--dp divides 4), placed once, run --warm + 1
times untraced, once under the profiler and --warm + 1 times untraced
again; printed for the batched solve: wall ms an iteration before and
after the traced run, kernels (K3' among them) and copies an iteration,
host us per kernel and the busy share.

--tree names a directory holding another version of padne_tpu_torch (an
unpacked earlier commit) to trace instead of this repository's, so that
two versions can be run in turns in one go on one card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
OWN_KERNELS = ("dia_sell_kernel", "comp_sell_kernel", "ell_sell_kernel")


def device_ms(prof):
    """(ms of kernels, ms of copies, ms and calls by kernel name) of a
    profile's device-side events."""
    import torch

    kernels = copies = 0.0
    ms_by_name, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        if e.name.startswith(("Memcpy", "Memset")):
            copies += ms
        else:
            kernels += ms
            ms_by_name[e.name] += ms
            calls[e.name] += 1
    return kernels, copies, ms_by_name, calls


def trace_sweep(args, prob, cfg, specs) -> int:
    """The --sweep mode: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from padne_tpu_torch import sweep

    def run():
        stats = {}
        t0 = time.perf_counter()
        results = sweep.solve_sweep(
            prob, [sweep.SweepSpec(*x) for x in specs], mesher_config=cfg,
            stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        worst = max(r.residual_norm for r in results)
        print(f"[sweep] n={stats['n']} specs={len(results)} wall={wall:.3f}s "
              f"mesh+assemble={stats['mesh_assemble_s']:.3f}s "
              f"setup={stats['setup_s']:.3f}s "
              f"multi_rhs_cg={stats['cg_s'] * 1e3:.1f}ms "
              f"recoveries={stats['recover_s'] * 1e3:.1f}ms "
              f"cg_iterations={stats['cg_iterations']} "
              f"worst_residual_norm={worst:.3e}", flush=True)
        return wall, stats

    run()
    for _ in range(args.warm):
        run()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, stats = run()
    kernels, copies, ms_by_name, calls = device_ms(prof)
    device_wall = wall - stats["mesh_assemble_s"]
    print(f"[trace] sweep n={stats['n']} wall after assembly "
          f"{device_wall * 1e3:.1f}ms kernel_sum={kernels:.1f}ms "
          f"copy_sum={copies:.1f}ms busy_share="
          f"{kernels / (device_wall * 1e3):.3f} device_events="
          f"{sum(calls.values())} peak_device_memory="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}GB")
    for own in OWN_KERNELS:
        names = [k for k in ms_by_name if own in k]
        if names:
            ms = sum(ms_by_name[k] for k in names)
            count = sum(calls[k] for k in names)
            print(f"[trace] {own}: {ms:.3f} ms over {count} calls "
                  f"({ms / count * 1e3:.2f} us a call)")
    total = sum(ms_by_name.values())
    for name, ms in ms_by_name.most_common(args.top):
        print(f"  {ms:9.3f} ms {ms / total:6.1%} {calls[name]:6d} calls  "
              f"{name[:90]}")
    if args.trace:
        prof.export_chrome_trace(str(args.trace))
    return 0


def trace_batched(args, system) -> None:
    """The batched solve of --tp: see the module docstring."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from padne_tpu_torch.parallel import sharding

    iters = chip_smoke.DP_TP_ITERS
    mesh = sharding.Mesh(["cuda:0"] * (args.dp * args.tp), dp=args.dp)
    batch, b, _ = chip_smoke.dp_tp_batch(system)
    t0 = time.perf_counter()
    placed = sharding.prepare_sharded_system(batch, b, mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharding.batched_sharded_cg(mesh, *placed, iters=iters)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def untraced():
        walls = sorted(run() for _ in range(args.warm + 1))
        return walls[len(walls) // 2], f"{walls[0] / iters * 1e3:.3f}-" \
            f"{walls[-1] / iters * 1e3:.3f} ms an iteration over " \
            f"{len(walls)} runs"

    median, before = untraced()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    kernels, copies, ms_by_name, calls = device_ms(prof)
    copy_calls = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name.startswith(("Memcpy", "Memset")))
    del prof
    gc.collect()
    after = untraced()[1]
    events = sum(calls.values())
    k3 = sum(c for k, c in calls.items() if OWN_KERNELS[2] in k)
    print(f"[batched] n={system.n} dp {args.dp} x tp {args.tp} "
          f"B={len(b)} R={b.shape[2]} f64 {iters} iterations: set-up "
          f"{setup_s:.2f} s; untraced wall {before} (after the traced "
          f"run: {after}); traced {wall / iters * 1e3:.3f} ms an "
          f"iteration, kernel_sum={kernels:.1f}ms copy_sum={copies:.1f}ms "
          f"busy_share={kernels / (wall * 1e3):.3f} (of the untraced "
          f"median: {kernels / (median * 1e3):.3f}) "
          f"kernels={events} per_iteration={events / iters:.1f} "
          f"(K3' {k3 / iters:.1f}), copies per iteration "
          f"{sum(copy_calls.values()) / iters:.1f} {dict(copy_calls)}, "
          f"host {median * 1e6 / max(events, 1):.2f} us a kernel "
          f"(untraced median)", flush=True)
    total = sum(ms_by_name.values())
    for name, ms in ms_by_name.most_common(args.top):
        print(f"  {ms:9.3f} ms {ms / total:6.1%} {calls[name]:6d} calls  "
              f"{name[:90]}")


STARTUP_STEPS = (
    ("interpreter", "pass"),
    ("import torch", "import torch"),
    ("CUDA context", "import torch; torch.zeros(1, device='cuda'); "
                     "torch.cuda.synchronize()"),
    ("the port's imports", "import padne_tpu_torch.cli, "
                           "padne_tpu_torch.kicad, padne_tpu_torch.solver"),
    ("both", "import padne_tpu_torch.cli, padne_tpu_torch.kicad, "
             "padne_tpu_torch.solver, torch; torch.zeros(1, device='cuda'); "
             "torch.cuda.synchronize()"),
)


def trace_startup(args) -> int:
    """The --startup mode: see the module docstring."""
    import os
    import statistics
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(args.tree.resolve()))
    for name, code in STARTUP_STEPS:
        walls = []
        for _ in range(args.warm + 1):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], env=env, check=True,
                           cwd=args.tree, timeout=300)
            walls.append(time.perf_counter() - t0)
        print(f"[startup] {name}: min {min(walls):.2f} s, median "
              f"{statistics.median(walls):.2f} s, max {max(walls):.2f} s "
              f"over {len(walls)} fresh processes", flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=140_000)
    ap.add_argument("--warm", type=int, default=3,
                    help="untraced warm solves before the traced one")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also write a Chrome trace here")
    ap.add_argument("--tree", type=pathlib.Path, default=REPO)
    ap.add_argument("--sweep", action="store_true",
                    help="trace the 12-spec design sweep, not one solve")
    ap.add_argument("--startup", action="store_true",
                    help="time a fresh client process's start, step by step")
    ap.add_argument("--tp", type=int, default=1,
                    help="shards of the one card for the solve, and tp of "
                         "the batched solve traced after it")
    ap.add_argument("--dp", type=int, default=1, choices=(1, 2, 4),
                    help="dp rows of the batched solve (with --tp)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("trace_port: no CUDA device", file=sys.stderr)
        return 2
    if args.startup:
        return trace_startup(args)
    from torch.profiler import ProfilerActivity, profile, record_function

    # The board generator is this repository's; the package under test is
    # the tree's.
    import chip_smoke

    sys.path.insert(0, str(args.tree.resolve()))
    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur
    from padne_tpu_torch.parallel import sharding

    mesh = None if args.tp == 1 else sharding.Mesh(["cuda:0"] * args.tp)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        prob, cfg = chip_smoke.bench_problem(pathlib.Path(tmp), args.dof)
        if args.sweep:
            return trace_sweep(args, prob, cfg, chip_smoke.SWEEP_SPECS)
        system = solver.build_system(prob, cfg)[0]

    class Stats(dict):
        """The solve's stats dict; opens the profiler range "solve" when
        the set-up reports its end (setup_s)."""

        mark = None

        def update(self, *a, **kw):
            super().update(*a, **kw)
            if "setup_s" in self and self.mark is None:
                torch.cuda.synchronize()
                self.mark = record_function("solve")
                self.mark.__enter__()

    def run():
        stats = Stats()
        t0 = time.perf_counter()
        sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                                   device="cuda", mesh=mesh, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats.mark.__exit__(None, None, None)
        print(f"[solve] wall={wall:.3f}s setup={stats['setup_s']:.3f}s "
              f"solve_wall={(wall - stats['setup_s']) * 1e3:.1f}ms "
              f"cg_iterations={sol.cg_iterations} "
              f"refinement_passes={sol.refinement_steps + 1} "
              f"residual_norm={sol.residual_norm:.3e}", flush=True)
        return wall, sol.cg_iterations, stats

    run()
    warm = sorted((wall - stats["setup_s"]) * 1e3 for wall, _, stats in
                  (run() for _ in range(args.warm)))
    if warm:
        print(f"[warm] solve_wall over {len(warm)} untraced warm solves: "
              f"min {warm[0]:.1f} ms, median {warm[len(warm) // 2]:.1f} ms, "
              f"max {warm[-1]:.1f} ms", flush=True)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, iterations, stats = run()
    solve_wall = wall - stats["setup_s"]
    events = list(prof.events())
    start = next(e.time_range.start for e in events if e.name == "solve")
    # Device-side events only (the aten ops on the host carry their
    # kernels' time as well), split at the start of the "solve" range.
    phase_ms = collections.Counter()      # (phase, kernels or copies)
    ms_by_name, calls = collections.Counter(), collections.Counter()
    for e in events:
        # (the "solve" range has a device-side twin: not a device event)
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name == "solve"):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        phase = "solve" if e.time_range.start >= start else "setup"
        copy = e.name.startswith(("Memcpy", "Memset"))
        phase_ms[phase, "copies" if copy else "kernels"] += ms
        if phase == "solve":
            ms_by_name[e.name] += ms
            calls[e.name] += 1
    n_events = sum(calls.values())
    kernel_sum = phase_ms["solve", "kernels"]
    print(f"[trace] route={stats['route']} n={system.n} tp={args.tp} "
          f"levels={stats['levels']} setup={stats['setup_s']:.3f}s "
          f"solve_wall={solve_wall * 1e3:.1f}ms "
          f"kernel_sum={kernel_sum:.1f}ms "
          f"copy_sum={phase_ms['solve', 'copies']:.1f}ms "
          f"busy_share={kernel_sum / (solve_wall * 1e3):.3f} "
          f"device_events={n_events} "
          f"per_cg_iteration={n_events / max(iterations, 1):.1f} "
          f"(set-up: kernels {phase_ms['setup', 'kernels']:.1f}ms, copies "
          f"{phase_ms['setup', 'copies']:.1f}ms) peak_device_memory="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}GB")
    for own in OWN_KERNELS:
        names = [k for k in ms_by_name if own in k]
        if names:
            ms = sum(ms_by_name[k] for k in names)
            count = sum(calls[k] for k in names)
            print(f"[trace] {own}: {ms:.3f} ms over {count} calls "
                  f"({ms / count * 1e3:.2f} us a call)")
    total = sum(ms_by_name.values())
    for name, ms in ms_by_name.most_common(args.top):
        print(f"  {ms:9.3f} ms {ms / total:6.1%} {calls[name]:6d} calls  "
              f"{name[:90]}")
    if args.trace:
        prof.export_chrome_trace(str(args.trace))
    if mesh is not None:
        # The profile's events are many Python objects: let the batched
        # solve's untraced runs not pay for them in the collector.
        del prof, events
        gc.collect()
        trace_batched(args, system)
    return 0


if __name__ == "__main__":
    sys.exit(main())
