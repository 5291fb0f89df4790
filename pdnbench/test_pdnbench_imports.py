"""The import guard: nothing a run loads imports JAX or the JAX package
(padne_tpu), compared by whole top-level names, and the reference
imports nothing of the program (CPU; each check in a fresh
interpreter)."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

RUN = r"""
import json, sys, time
sys.path.insert(0, ROOT)
import torch
torch.set_num_threads(2)
sys.path.insert(0, ROOT + "/pdnbench")
import conftest
from pdnbench import arith, control, harness, inputs, trace
import pdnbench.run
bench, root, inputs.CACHE = conftest.make_tiny(TMP)
names = set()
for cell in conftest.TINY_CELLS:
    traffic = harness.traffic_of(cell.split(".")[1])
    harness.entry_module(traffic["entry"])
    for trace in (False, True):
        for m in harness.metrics_of(bench, cell, trace):
            harness.metric_reader(m["name"])
result, checks = harness.run_cell(bench, "tiny.resolve", 7, 0.01, False,
                                  "cpu", time.perf_counter(), root)
print(json.dumps({"correct": result["correct"],
                  "top": sorted({n.split(".")[0] for n in sys.modules})}))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, ROOT)
sys.path.insert(0, ROOT + "/pdnbench")
from pdnbench import inputs
from pdnbench.reference import check
from pdnbench.frozen import (assembly, boardgen, geom, kicad, mesh, native,
                             problem, sexp, system, units)
from pdnbench.frozen.utils import validation
import conftest
inputs.CACHE = __import__("pathlib").Path(TMP) / "cache"
config = {**conftest.tiny_config(), "name": "tiny"}
inp = inputs.base_inputs(config, TMP + "/board")
ref = check.Bordered(inp, inp.ell())
v, j = ref.direct(inp.r_core, inp.b_rhs)
print(json.dumps({"res": ref.rel_residual(inp.r_core, inp.b_rhs, v, j),
                  "top": sorted({n.split(".")[0] for n in sys.modules})}))
"""


def _run(code, tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code.replace("ROOT", repr(str(ROOT)))
         .replace("TMP", repr(str(tmp_path)))],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    got = _run(RUN, tmp_path)
    assert got["correct"] is True
    top = set(got["top"])
    assert {"padne_tpu_torch", "pdnbench", "torch"} <= top
    assert not top & {"jax", "jaxlib", "flax", "padne_tpu"}


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    got = _run(REFERENCE, tmp_path)
    assert got["res"] < 1e-10
    top = set(got["top"])
    assert "pdnbench" in top
    assert not top & {"padne_tpu_torch", "padne_tpu", "jax", "torch"}


def test_the_runner_refuses_to_run_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, str(ROOT / "pdnbench" / "run.py"), "--workload",
         "pdn4l_default.board", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
