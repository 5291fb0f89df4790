"""The control of `correct` in the rail board's cell
(entries/rail_resolve.py), as pdnbench/site_control.py makes it for the
site board: the plain reference's float64 answer (pdnbench/reference/
mna.py's direct solve) rounded to float32, read by the numbers the
cell's check compares, beside the float64 answer's own reading, for the
first request the seed draws:

    python3 pdnbench/rail_control.py --workload soc_rails_1m.rail_resolve \\
        --seeds 1 2 3

prints one JSON line a seed: {name: [reference, control, limit]} and the
seconds it took, the first seed's with the factorization.  It needs no
card and is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(bench: dict, cell_name: str, seed: int, root=ROOT,
             factors=None) -> dict:
    """{check name: (reference's reading, control's reading, limit)}; a
    dict as `factors` keeps the factorization across calls (the
    system's matrix does not change with the seed)."""
    from pdnbench import control, harness, railboard
    from pdnbench.entries import site_resolve
    from pdnbench.reference import check, mna

    cell = harness.cell_of(bench, cell_name)
    config = harness.config_of(bench, cell, root)
    traffic = harness.traffic_of(cell["traffic"])
    tmp = tempfile.mkdtemp(prefix="pdnbench-control-")
    try:
        ctx = harness.Context(config, traffic, seed, "cpu", tmp)
        inp = railboard.rail_inputs(config, tmp)
        rc, rhs = site_resolve.requests(ctx, inp)[0]
        factors = {} if factors is None else factors
        if cell_name not in factors:
            factors[cell_name] = (mna.Reference(inp),
                                  check.Bordered(inp, inp.ell()))
        ref, frozen = factors[cell_name]
        v, j = ref.solve(rc, rhs)
        v32, j32 = control._f32(v), control._f32(j)
        pads = inp.cur_f
        limits = config["check"]
        return {
            "rel_residual": (frozen.rel_residual(rc, rhs, v, j),
                             frozen.rel_residual(rc, rhs, v32, j32),
                             limits["rel_residual"]),
            "max_rail_dv": (None, check.max_abs_diff(v32[pads], v[pads]),
                            limits["max_rail_dv"])}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from pdnbench import harness

    bench = harness.load_benchmark(ROOT)
    factors = {}
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(bench, args.workload, seed, factors=factors)
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
