"""The benchmark's site board cell (`site_resolve` on
`fragmented_1m`, pdnbench/entries/site_resolve.py) through the harness
on the CPU, at 8 x 8 sites: a sound run is correct; one site's answer
shifted by 1 mV, or a solve off the segment projector, is not; a
program that reports no widths fails at set-up; and the control
(pdnbench/site_control.py) fails the check where the reference passes
it."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from padne_tpu_torch.ops import schur
from tests.test_torch_site_board import small_config

torch.set_num_threads(2)

CELL = "sites8.site_resolve"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench, root): BENCHMARK.json with the small site board's
    configuration and its cell on the real mix and metrics added."""
    from pdnbench import harness, inputs

    monkeypatch.setattr(inputs, "CACHE", tmp_path / "cache")
    root = tmp_path / "root"
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "sites8.json").write_text(json.dumps(small_config()))
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "sites8", "file": "configs/sites8.json"})
    bench["workloads"].append({"name": CELL, "config": "sites8",
                               "traffic": "site_resolve", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fragmented_1m.site_resolve" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [CELL]
    return bench, root


def _run(tiny, trace=False):
    from pdnbench import harness

    bench, root = tiny
    return harness.run_cell(bench, CELL, 2**31 + 77, 0.01, trace, "cpu",
                            time.perf_counter(), root)


def test_a_sound_run_is_correct(tiny):
    result, checks = _run(tiny)
    assert result["correct"] is True and result["failed"] == 0
    assert [name for name, _, _ in checks] == ["rel_residual",
                                               "max_site_dv"]
    assert all(v <= limit for _, v, limit in checks)
    assert set(result["metrics"]) == {"setup_s", "solve_s"}


def test_one_site_shifted_by_a_millivolt_is_not_correct(tiny, monkeypatch):
    solve = schur.DiaBorderedSolver.solve

    def shifted(self, *args, **kwargs):
        sol = solve(self, *args, **kwargs)
        comp = self.system.comp_id
        site = comp[self.system.border.row_node[0]]
        return dataclasses.replace(sol, v=sol.v + 1e-3 * (comp == site))

    monkeypatch.setattr(schur.DiaBorderedSolver, "solve", shifted)
    result, checks = _run(tiny)
    assert result["correct"] is False
    assert all(v > limit for _, v, limit in checks)


def test_a_solve_off_the_segment_projector_fails(tiny, monkeypatch):
    counters = schur.DiaBorderedSolver.counters
    calls = []

    def onehot(self):
        calls.append(1)
        got = counters(self)
        # Set-up reads the counters once; the requests after it.
        return got if len(calls) == 1 else {**got, "projector": "onehot"}

    monkeypatch.setattr(schur.DiaBorderedSolver, "counters", onehot)
    result, _ = _run(tiny)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] >= 1


def test_a_solver_built_off_the_segment_projector_fails_at_set_up(
        tiny, monkeypatch):
    from padne_tpu_torch.ops import cg

    monkeypatch.setattr(cg, "projector_kind",
                        lambda count: "mean" if count == 1 else "onehot")
    with pytest.raises(RuntimeError, match="segment projector"):
        _run(tiny)


def test_a_program_without_widths_fails_at_set_up(tiny, monkeypatch):
    monkeypatch.delattr(schur.DiaBorderedSolver, "counters")
    with pytest.raises(RuntimeError, match="reports no widths"):
        _run(tiny)


def test_the_control_fails_and_the_reference_passes(tiny):
    from pdnbench import site_control

    bench, root = tiny
    factors = {}
    for seed in (5, 2**31 + 9):
        got = site_control.readings(bench, CELL, seed, root, factors)
        ref, ctrl, limit = got["rel_residual"]
        assert ctrl > 3 * limit and ref < limit / 100
        _, ctrl, limit = got["max_site_dv"]
        assert ctrl > 3 * limit


def test_the_cells_metrics_read_its_requests(tiny, tmp_path):
    """The cell's three per-layer metrics, read from the program's
    spans and counters over requests of the cell's entry (the device
    idle share needs a traced segment on the card: None here)."""
    from pdnbench import harness
    from pdnbench.entries import site_resolve

    bench, root = tiny
    assert {m["name"] for m in harness.metrics_of(bench, CELL, True)} == {
        "wide_s.fragmented", "passes.fragmented", "device_idle.fragmented"}
    cell = harness.cell_of(bench, CELL)
    ctx = harness.Context(harness.config_of(bench, cell, root),
                          harness.traffic_of(cell["traffic"]), 3, "cpu",
                          str(tmp_path))
    drv = site_resolve.Entry(ctx)
    drv.warm_up()
    run = harness.Run(CELL, setup_s=1.0)
    for i in range(2):
        t = time.perf_counter()
        _, counters = drv.request(i)
        run.latencies.append(time.perf_counter() - t)
        run.counters.append(counters)
    assert counters["small_width"] == 130
    assert counters["projector"] == "segment"
    wide = harness.metric_reader("wide_s.fragmented").read(run)
    assert 0 < wide < sum(run.latencies) / 2
    passes = harness.metric_reader("passes.fragmented").read(run)
    assert passes == np.mean([c["passes"] for c in run.counters]) >= 1
    assert harness.metric_reader("device_idle.fragmented").read(run) is None
