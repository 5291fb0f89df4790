"""The rail board's cell (`rail_resolve` on `soc_rails_1m`,
pdnbench/entries/rail_resolve.py) through the harness on the CPU, on a
4-regulator version of its board (two bucks, an LDO fed by one of them,
an LDO fed from 12 V; 9,839 unknowns): one regulator's rail 1 mV off is
not correct; a solve off the one-hot projector, or at other widths,
fails; a program that counts no regulators fails at set-up; and the
control (pdnbench/rail_control.py) fails the check where the reference
passes it."""

import dataclasses
import json
import pathlib
import time

import pytest

HERE = pathlib.Path(__file__).resolve().parent
CELL = "rails4.rail_resolve"
SMALL = [["VCCINT", 0.85, "buck", "12V", 2.0, 1],
         ["1V8", 1.8, "buck", "12V", 1.0, 1],
         ["MGTAVTT", 1.2, "ldo", "1V8", 0.5, 1],
         ["2V5", 2.5, "ldo", "12V", 0.3, 1]]


def small_config() -> dict:
    """soc_rails_1m's configuration with 4 regulators on a 44 x 22 mm
    board with a 12 mm site, no stitching, meshed at 3 mm: 6 copper
    components and a 6-row border."""
    config = json.loads((HERE / "configs" / "soc_rails_1m.json").read_text())
    config["board"]["args"].update(size=[44.0, 22.0], bga=12.0,
                                   stitch=None, rails=SMALL)
    config["mesher"] = {"maximum_size": 3.0}
    config.update(name="rails4", n=9839, m=6, components=6, regulators=4)
    return config


def make_small(tmp_path):
    """(bench, root): BENCHMARK.json with the small configuration and its
    cell on the real mix and metrics added, the configuration file under
    root."""
    from pdnbench import harness

    root = pathlib.Path(tmp_path) / "root"
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "rails4.json").write_text(json.dumps(small_config()))
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "rails4", "file": "configs/rails4.json"})
    bench["workloads"].append({"name": CELL, "config": "rails4",
                               "traffic": "rail_resolve", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "soc_rails_1m.rail_resolve" in m.get("workloads", []):
            m["workloads"] = m["workloads"] + [CELL]
    return bench, root


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(bench, root) of make_small, its input cache made once."""
    from pdnbench import inputs

    tmp = tmp_path_factory.mktemp("rails")
    cache, inputs.CACHE = inputs.CACHE, tmp / "cache"
    try:
        yield make_small(tmp)
    finally:
        inputs.CACHE = cache


def _run(small):
    from pdnbench import harness

    bench, root = small
    return harness.run_cell(bench, CELL, 2**31 + 77, 0.01, False, "cpu",
                            time.perf_counter(), root)


def test_one_rail_a_millivolt_off_is_not_correct(small, monkeypatch):
    from padne_tpu_torch.ops import schur

    solve = schur.DiaBorderedSolver.solve

    def shifted(self, *args, **kwargs):
        sol = solve(self, *args, **kwargs)
        comp = self.system.comp_id
        b = self.system.border
        # The first regulator's output pad: its row's +1 entry.
        k = next(k for k in range(b.m) if (b.col_idx == k).sum() == 4)
        rows = (b.row_idx == k) & (b.row_val > 0)
        rail = comp[b.row_node[rows][0]]
        return dataclasses.replace(sol, v=sol.v + 1e-3 * (comp == rail))

    monkeypatch.setattr(schur.DiaBorderedSolver, "solve", shifted)
    result, checks = _run(small)
    assert result["correct"] is False
    got = {name: (v, limit) for name, v, limit in checks}
    assert got["max_rail_dv"][0] > got["max_rail_dv"][1]


def test_a_sound_run_passes_both_checks(small):
    result, checks = _run(small)
    assert result["correct"] is True and result["failed"] == 0
    assert [name for name, _, _ in checks] == ["rel_residual",
                                               "max_rail_dv"]
    assert all(v <= limit for _, v, limit in checks)


@pytest.mark.parametrize("key, value", [("projector", "segment"),
                                        ("regulators", 3),
                                        ("border_rows", 5)])
def test_a_solve_off_the_configuration_fails(small, monkeypatch, key,
                                             value):
    from padne_tpu_torch.ops import schur

    counters = schur.DiaBorderedSolver.counters
    calls = []

    def other(self):
        calls.append(1)
        got = counters(self)
        # Set-up reads the counters once; the requests after it.
        return got if len(calls) == 1 else {**got, key: value}

    monkeypatch.setattr(schur.DiaBorderedSolver, "counters", other)
    result, _ = _run(small)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"] >= 1


def test_a_program_that_counts_no_regulators_fails_at_set_up(
        small, monkeypatch):
    from padne_tpu_torch.ops import schur

    monkeypatch.delattr(schur, "count_regulators")
    with pytest.raises(RuntimeError, match="counts no regulators"):
        _run(small)


def test_the_control_fails_and_the_reference_passes(small):
    from pdnbench import rail_control

    bench, root = small
    factors = {}
    for seed in (5, 2**31 + 9):
        got = rail_control.readings(bench, CELL, seed, root, factors)
        ref, ctrl, limit = got["rel_residual"]
        assert ctrl > 3 * limit and ref < limit / 100
        _, ctrl, limit = got["max_rail_dv"]
        assert ctrl > 3 * limit
