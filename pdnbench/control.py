"""The control of `correct`: the reference put in the program's place,
computed one precision below the configuration's.

The configurations state an answer in float64 (float32 inner solves,
float64 refinement).  The control takes the reference's float64 answer
(SciPy's direct solver on the frozen system) and rounds it to float32:
the nearest float32 answer there is, so every float32 computation reads
at least as far off.  The same number the cell's check compares is read
for the control and for the float64 reference, for the first request
the seed draws:

    python3 pdnbench/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed: {name: [reference, control, limit]}.  It
needs no card (the reference runs on the host) and is not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _f32(a):
    return np.asarray(a, np.float32).astype(np.float64)


def readings(bench: dict, cell_name: str, seed: int, root=ROOT,
             factors=None) -> dict:
    """{check name: (reference's reading, control's reading, limit)}; a
    dict as `factors` keeps the nominal system's factorization across
    calls (the resolve mix's matrix does not change with the seed)."""
    from pdnbench import harness, inputs
    from pdnbench.entries import board, project, resolve
    from pdnbench.reference import check

    cell = harness.cell_of(bench, cell_name)
    config = harness.config_of(bench, cell, root)
    traffic = harness.traffic_of(cell["traffic"])
    tmp = tempfile.mkdtemp(prefix="pdnbench-control-")
    try:
        ctx = harness.Context(config, traffic, seed, "cpu", tmp)
        kind = traffic["entry"]
        if kind == "project":
            from pdnbench.frozen import kicad

            warm, pool = project.requests(ctx)
            kw = inputs.mesher_settings(config,
                                        kicad.load_kicad_project(warm))
            ref = project.reference_potentials(pool[0], kw)
            lim = config["check"]["max_dv"]
            return {"max_dv": (None, check.max_abs_diff(_f32(ref), ref),
                               lim)}
        inp = inputs.base_inputs(config, tmp)
        if kind == "resolve":
            rc, rhs = resolve.requests(ctx, inp)[0]
            factors = {} if factors is None else factors
            if cell_name not in factors:
                factors[cell_name] = check.Bordered(inp, inp.ell())
            sys_ = factors[cell_name]
        else:
            ell, rc, rhs = board.requests(ctx, inp)[0]
            sys_ = check.Bordered(inp, ell)
        v, j = sys_.direct(rc, rhs)
        return {"rel_residual": (sys_.rel_residual(rc, rhs, v, j),
                                 sys_.rel_residual(rc, rhs, _f32(v), _f32(j)),
                                 config["check"]["rel_residual"])}
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
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(bench, args.workload, seed,
                                     factors=factors)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
