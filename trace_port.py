#!/usr/bin/env python3
"""Where the port's device time goes: one warm bordered solve of the
generated 4-layer bench board under torch.profiler, on one NVIDIA GPU.

Run from the repository root:

    python3 trace_port.py [--dof 140000] [--top 12] [--trace out.json]

The board is meshed for --dof as chip_smoke.py sizes it; the auto route
picks DIA (n >= 200k) or ELL.  One solve runs untraced (kernel build,
first-call costs), the second under the profiler.  Printed: the route,
each solve's wall time, CG iterations and refinement passes, the traced
solve's wall time without its host setup (setup_s of the solve's
stats), the summed device time of kernels and of memory copies (the
copies include the setup's uploads), the kernels' share of the solve's
wall time, the count of device events (kernels and copies), the peak
device memory of the traced solve (set-up included), and the device
events by total time (calls, ms, share).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=140_000)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="also write a Chrome trace here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("trace_port: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from padne_tpu_torch import solver
    from padne_tpu_torch.ops import schur

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        prob, cfg = chip_smoke.bench_problem(pathlib.Path(tmp), args.dof)
        system = solver.build_system(prob, cfg)[0]

    def run(stats):
        t0 = time.perf_counter()
        sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                                   device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[solve] wall={wall:.3f}s setup={stats['setup_s']:.3f}s "
              f"cg_iterations={sol.cg_iterations} "
              f"refinement_passes={sol.refinement_steps + 1} "
              f"residual_norm={sol.residual_norm:.3e}", flush=True)
        return wall

    run({})
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(stats)
    solve_wall = wall - stats["setup_s"]
    # Device-side events only (the aten ops on the host carry their
    # kernels' time as well).
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    copies = sum(e.self_device_time_total for e in device
                 if e.key.startswith(("Memcpy", "Memset"))) / 1e3  # ms
    total = sum(e.self_device_time_total for e in device) / 1e3
    kernel_sum = total - copies
    print(f"[trace] route={stats['route']} n={system.n} "
          f"levels={stats['levels']} setup={stats['setup_s']:.3f}s "
          f"solve_wall={solve_wall * 1e3:.1f}ms "
          f"kernel_sum={kernel_sum:.1f}ms copy_sum={copies:.1f}ms "
          f"busy_share={kernel_sum / (solve_wall * 1e3):.3f} "
          f"device_events={sum(e.count for e in device)} "
          f"peak_device_memory="
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f}GB")
    device.sort(key=lambda e: -e.self_device_time_total)
    for e in device[:args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.3f} ms {ms / total:6.1%} {e.count:6d} calls  "
              f"{e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(str(args.trace))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
