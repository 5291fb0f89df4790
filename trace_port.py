#!/usr/bin/env python3
"""Where the port's device time goes: warm bordered solves of the
generated 4-layer bench board, one of them under torch.profiler, on one
NVIDIA GPU.

Run from the repository root:

    python3 trace_port.py [--dof 140000] [--warm 3] [--top 12]
                          [--trace out.json] [--tree DIR]

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

--tree names a directory holding another version of padne_tpu_torch (an
unpacked earlier commit) to trace instead of this repository's, so that
two versions can be run in turns in one go on one card.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
OWN_KERNELS = ("dia_sell_kernel", "comp_sell_kernel", "ell_sell_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=140_000)
    ap.add_argument("--warm", type=int, default=3,
                    help="untraced warm solves before the traced one")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also write a Chrome trace here")
    ap.add_argument("--tree", type=pathlib.Path, default=REPO)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("trace_port: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile, record_function

    # The board generator is this repository's; the package under test is
    # the tree's.
    import chip_smoke

    sys.path.insert(0, str(args.tree.resolve()))
    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        prob, cfg = chip_smoke.bench_problem(pathlib.Path(tmp), args.dof)
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
                                   device="cuda", stats=stats)
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
    print(f"[trace] route={stats['route']} n={system.n} "
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
