"""pdnbench's runs on the card: each cell's result line as the driver
reads it.  Marked `cuda`: every test skips without a CUDA device
(decided in a fixture, never at import).  On the card's machine, from
the repo root:

    python -m pytest -m cuda pdnbench/test_pdnbench_card.py -q
"""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _run(cell, trace):
    out = subprocess.run(
        [sys.executable, str(ROOT / "pdnbench" / "run.py"), "--workload",
         cell, "--seed", str(2**31 + 1001), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    return line


def _expected(cell, trace):
    sys.path.insert(0, str(ROOT))
    from pdnbench import harness

    bench = harness.load_benchmark(ROOT)
    return {m["name"] for m in harness.metrics_of(bench, cell, trace)}


@pytest.mark.parametrize("cell", ["pdn4l_default.board",
                                  "pdn4l_1m.resolve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_the_cells_metrics_and_is_correct(card, cell, trace):
    line = _run(cell, trace)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == _expected(cell, trace)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
        for name, m in line["metrics"].items():
            if name.endswith("_roofline"):
                assert 0 < m["value"] <= 105, name
