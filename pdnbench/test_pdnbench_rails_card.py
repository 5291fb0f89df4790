"""The rail board's cell on the card at full size: the generator's board
as the configuration states it (n, m, components, regulators, layers),
and a run of the cell with and without the trace: its result line is
correct and holds the cell's metrics.  Marked `cuda`: every test skips
without a CUDA device (decided in a fixture, never at import).  On the
card's machine, from the repo root:

    python -m pytest -m cuda pdnbench/test_pdnbench_rails_card.py -q
"""

import json
import pathlib
import subprocess
import sys
import tempfile

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
CELL = "soc_rails_1m.rail_resolve"
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _config():
    sys.path.insert(0, str(ROOT))
    from pdnbench import harness

    bench = harness.load_benchmark(ROOT)
    return bench, harness.config_of(bench, harness.cell_of(bench, CELL))


def test_the_full_board_is_the_configurations(card):
    from pdnbench import railboard

    _, config = _config()
    # rail_inputs raises where n, m, components or regulators differ.
    inp = railboard.rail_inputs(config, tempfile.mkdtemp())
    assert inp.n == config["n"] and inp.m == config["m"] == 22
    assert int(inp.num_components) == config["components"] == 22
    assert int(inp.src_regulator.sum()) == config["regulators"] == 20
    assert len(inp.cur_i) == 57


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_of_the_cell_is_correct(card, trace):
    out = subprocess.run(
        [sys.executable, str(ROOT / "pdnbench" / "run.py"), "--workload",
         CELL, "--seed", str(2**31 + 2203), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, cwd=ROOT,
        timeout=1800)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert list(line["check"]) == ["rel_residual", "max_rail_dv"]
    bench, _ = _config()
    from pdnbench import harness

    assert set(line["metrics"]) == {
        m["name"] for m in harness.metrics_of(bench, CELL, bool(trace))}
    if trace:
        dev = line["device"]
        assert 0 < dev["busy_s"] <= dev["window_s"]
