"""One run of one cell: set-up, warm-up, the measured window, the traced
segment (`--trace 1`), the check, and the result line.

Everything cell-specific is a file found by name: the cell's entry in
BENCHMARK.json names a configuration (its `file`) and a traffic mix
(traffic/<mix>.json); the mix names the program entry it drives
(entries/<entry>.py); every metric is read by metrics/<metric>.py,
whose `read(run)` returns a number or None (then the metric is left
out of the line).

The window is a closed loop: one caller, requests back to back, each
request's inputs made during set-up.  It lasts `seconds`; the request
running at its end finishes, and the window's length is the time to
the end of the last completed request.  Set-up is everything from the
start of the process to the start of the window.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import pathlib
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded once the window closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "padne_tpu")


def load_benchmark(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, cell: dict, root=ROOT) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((pathlib.Path(root) / entry["file"]).read_text())
    config["name"] = entry["name"]
    return config


def traffic_of(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def entry_module(name: str):
    return importlib.import_module(f"pdnbench.entries.{name}")


def metric_reader(name: str):
    """metrics/<name>.py (names may hold dots) as a module."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pdnbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with trace its per-layer ones:
    those that list the cell, or list no cells and (per-layer) move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


@dataclass
class Context:
    """What an entry is given: its configuration, traffic mix, seed,
    device and a scratch directory under TMPDIR."""

    config: dict
    traffic: dict
    seed: int
    device: object
    tmp_dir: str


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    setup_s: float
    window_s: float = 0.0
    latencies: list = field(default_factory=list)   # s, completed requests
    counters: list = field(default_factory=list)    # dict per request
    failed: int = 0
    trace: object = None                            # trace.Reading
    cpu_s: float = 0.0                              # process CPU, window

    def mean(self, key: str):
        """Mean over the window's requests (not the traced ones) of a
        counter, None where no request reported it."""
        vals = [c[key] for c in self.counters if key in c]
        return sum(vals) / len(vals) if vals else None


def _sync(device) -> None:
    if getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.synchronize()


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, root=ROOT):
    """(result dict, [(name, value, limit)]) of one run; the result has
    the line's keys except `device`."""
    cell = cell_of(bench, cell_name)
    config = config_of(bench, cell, root)
    traffic = traffic_of(cell["traffic"])
    tmp_dir = tempfile.mkdtemp(prefix="pdnbench-")
    try:
        ctx = Context(config, traffic, seed, device, tmp_dir)
        drv = entry_module(traffic["entry"]).Entry(ctx)
        drv.warm_up()
        _sync(device)
        kept = Sample(traffic["check_sample"], seed)
        cpu0 = _cpu_s()
        t0 = time.perf_counter()
        run = Run(cell_name, setup_s=t0 - t_start)

        def one(i, window=True):
            t = time.perf_counter()
            try:
                answer, counters = drv.request(i)
            except Exception:
                traceback.print_exc(file=sys.stderr)
                run.failed += 1
                return
            _sync(device)
            if window:
                run.latencies.append(time.perf_counter() - t)
                run.counters.append(counters)
            kept.offer(answer)

        i = 0
        while time.perf_counter() - t0 < seconds:
            one(i)
            i += 1
        run.window_s = time.perf_counter() - t0
        run.cpu_s = _cpu_s() - cpu0
        attempted = i
        if trace:
            from . import trace as trace_mod

            def segment(count):
                nonlocal attempted
                for _ in range(count):
                    one(attempted, window=False)
                    attempted += 1

            run.trace = trace_mod.profile(segment, traffic["trace_requests"],
                                          getattr(drv, "renew", None))
        peak = _memory_peak(device)
        values = {}
        for m in metrics_of(bench, cell_name, trace):
            v = metric_reader(m["name"]).read(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
        # The program's state is freed before the reference runs.
        if run.trace is not None:
            run.trace.launches.operators.clear()
        drv.close()
        gc.collect()
        _release(device)
        _summary(run)
        checks = drv.check(kept.items)
        correct = run.failed == 0 and all(
            _finite(v) is not None and v <= limit for _, v, limit in checks)
        result = {"correct": correct, "attempted": attempted,
                  "failed": run.failed, "metrics": values,
                  "memory_peak_bytes": peak}
        if trace:
            result["busy_s"] = run.trace.busy_s
            result["window_s"] = run.trace.window_s
            result["breakdown"] = run.trace.breakdown
        return result, checks
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


class Sample:
    """A uniform sample of `size` answers of all offered, drawn from the
    seed (reservoir sampling): the answers not kept are freed at once,
    so the window's memory does not grow with its length."""

    def __init__(self, size: int, seed: int):
        import numpy as np

        self.size, self.items, self.offered = size, [], 0
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, answer) -> None:
        self.offered += 1
        if len(self.items) < self.size:
            self.items.append(answer)
            return
        k = int(self.rng.integers(0, self.offered))
        if k < self.size:
            self.items[k] = answer


def _cpu_s() -> float:
    """CPU seconds this process has used (user and system)."""
    import os

    return sum(os.times()[:2])


def _max_rss_gb() -> float:
    """This process's peak resident memory so far (Linux: KiB units)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _summary(run: Run) -> None:
    """The window's latencies, host times and counters, on standard
    error."""
    lat = sorted(run.latencies)
    if lat:
        print(f"window: {len(lat)} requests in {run.window_s:.3f} s; "
              f"latency min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f} "
              f"max {lat[-1]:.4f} s; process CPU {run.cpu_s:.3f} s, "
              f"peak RSS {_max_rss_gb():.2f} GB", file=sys.stderr)
    keys = sorted({k for c in run.counters for k, v in c.items()
                   if isinstance(v, (int, float))})
    if keys:
        print("counters (mean): " + ", ".join(
            f"{k} {run.mean(k):.4g}" for k in keys), file=sys.stderr)


def _memory_peak(device) -> int:
    if getattr(device, "type", device) != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated())


def _release(device) -> None:
    if getattr(device, "type", device) == "cuda":
        import torch

        torch.cuda.empty_cache()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (whole) is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def check_lines(checks) -> tuple[list[str], dict]:
    """The compared numbers, as lines for standard error and as the
    result's last key."""
    lines, table = [], {}
    for name, value, limit in checks:
        lines.append(f"check {name}: {value!r} (limit {limit!r})")
        table[name] = {"value": _finite(value), "limit": limit}
    return lines, table
