"""Run one cell of BENCHMARK.json once on the CUDA card(s) of this
machine and print its result as the last line of standard output:

    python3 pdnbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With --trace 0 the metrics are the cell's end-to-end ones, with
--trace 1 its per-layer ones (a few more requests run under the
profiler after the window).  The numbers that decide `correct` are
printed beside their limits as the last lines of standard error and
under the result's last key, `check`.  Without a CUDA card, or with
fewer than the cell asks for, it prints no result and exits 2; it exits
3 if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "pdnbench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from pdnbench import harness

    bench = harness.load_benchmark(ROOT)
    chips = harness.cell_of(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pdnbench: the cell needs {chips} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    result, checks = harness.run_cell(bench, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      device, T_START, ROOT)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"pdnbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips,
           "memory_peak_bytes": result.pop("memory_peak_bytes")}
    if args.trace:
        dev["busy_s"] = result.pop("busy_s")
        dev["window_s"] = result.pop("window_s")
    breakdown = result.pop("breakdown", None)
    lines, table = harness.check_lines(checks)
    line = {**result, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = table
    sys.stdout.flush()
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
