"""Port parity for padne_tpu_torch.spatial and padne_tpu_torch.validate
against the JAX package, on generated boards only (the measured board of
the JAX package's own measurement set is not part of the repository).

Gates: spatial picks equal (same mesh, item and distance; values within
1e-9 V); the validation report of the generated strip measurement set
equal to 1e-9 relative (scale, every measured voltage and error, the
same verdicts); `validate` through the CLI prints the same table."""

import json
import warnings

import numpy as np
import pytest
import torch

from padne_tpu import kicad as jkicad
from padne_tpu import solver as jsolver
from padne_tpu import spatial as jspatial
from padne_tpu import validate as jvalidate
from padne_tpu_torch import cli, kicad, solver, spatial, validate

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def measurement_file(boards_dir):
    """The strip set as the JAX package's tests build it: a 20 mm trace,
    2 mm wide, 1 V between the ends; expected values off on purpose to
    exercise calibration and the 0.4 relative tolerance."""
    ms = {
        "board": "gen_strip/gen_strip.kicad_pro",
        "rel_tol": 0.4,
        "calibration": [
            {"p": [121, 101], "n": [101, 101], "layer": "F.Cu",
             "expected_v": 1.0}
        ],
        "measurements": [
            {"p": [121, 101], "n": [111, 101], "layer": "F.Cu",
             "expected_v": 0.5},
            {"p": [111, 101], "n": [101, 101], "layer": "F.Cu",
             "expected_v": 0.5},
            {"p": [121, 101], "n": [101, 101], "layer": "F.Cu",
             "expected_v": 0.5},
        ],
    }
    path = boards_dir / "torch_strip_measurements.json"
    path.write_text(json.dumps(ms))
    return path


@pytest.fixture(scope="module")
def both_solutions(boards_dir):
    pro = boards_dir / "gen_via_stack_4layer" / "gen_via_stack_4layer.kicad_pro"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (solver.solve(kicad.load_kicad_project(pro), device="cpu"),
                jsolver.solve(jkicad.load_kicad_project(pro)))


@pytest.mark.parametrize("index", ["VertexSpatialIndex", "FaceSpatialIndex"])
def test_spatial_picks_equal(both_solutions, index):
    sol, jsol = both_solutions
    rng = np.random.default_rng(11)
    for ls, jls in zip(sol.layer_solutions, jsol.layer_solutions):
        got_index = getattr(spatial, index)(ls)
        want_index = getattr(jspatial, index)(jls)
        verts = np.concatenate([m.vertices for m in ls.meshes])
        lo, hi = verts.min(0) - 1.0, verts.max(0) + 1.0
        for x, y in rng.uniform(lo, hi, size=(40, 2)):
            got, want = got_index.query(x, y), want_index.query(x, y)
            assert (got.mesh_index, got.item_index) == (
                want.mesh_index, want.item_index)
            assert got.distance == want.distance
            assert abs(got.value - want.value) <= 1e-9 * max(
                1.0, abs(want.value))


def test_spatial_empty_layer():
    empty = solver.LayerSolution(meshes=[], potentials=[])
    assert spatial.VertexSpatialIndex(empty).query(0.0, 0.0) is None
    assert spatial.FaceSpatialIndex(empty).query(0.0, 0.0) is None


def test_measurement_set_loads_equal(measurement_file):
    got = validate.MeasurementSet.load(measurement_file)
    want = jvalidate.MeasurementSet.load(measurement_file)
    assert got.board == want.board and got.rel_tol == want.rel_tol
    for a, b in zip(got.calibration + got.measurements,
                    want.calibration + want.measurements):
        assert (a.p, a.n, a.layer, a.expected_v, a.p_layer, a.n_layer,
                a.width_mm, a.length_mm, a.current_a) == (
            b.p, b.n, b.layer, b.expected_v, b.p_layer, b.n_layer,
            b.width_mm, b.length_mm, b.current_a)


@pytest.mark.parametrize("do_calibrate", [True, False])
def test_run_validation_matches_jax(measurement_file, do_calibrate):
    got = validate.run_validation(
        validate.MeasurementSet.load(measurement_file),
        do_calibrate=do_calibrate, device="cpu")
    want = jvalidate.run_validation(
        jvalidate.MeasurementSet.load(measurement_file),
        do_calibrate=do_calibrate)
    assert got.scale == pytest.approx(want.scale, rel=1e-9)
    assert got.overetch == want.overetch
    assert len(got.results) == len(want.results) == 3
    for a, b in zip(got.results, want.results):
        assert (a["p"], a["n"], a["layer"], a["expected_v"], a["ok"]) == (
            b["p"], b["n"], b["layer"], b["expected_v"], b["ok"])
        assert a["measured_v"] == pytest.approx(b["measured_v"], rel=1e-9)
        assert a["rel_err"] == pytest.approx(b["rel_err"], rel=1e-9)
    assert got.num_pass == want.num_pass == 2 and not got.all_pass


def test_probe_voltage_and_overetch(boards_dir):
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    prob = kicad.load_kicad_project(pro)
    sol = validate._solve_scaled(prob, 2.0, device="cpu")
    assert [l.conductance for l in sol.problem.layers] == [
        2.0 * l.conductance for l in prob.layers]
    jsol = jvalidate._solve_scaled(jkicad.load_kicad_project(pro), 2.0)
    for point in ((121, 101), (111, 101), (101, 101)):
        assert validate.probe_voltage(sol, "F.Cu", point) == pytest.approx(
            jvalidate.probe_voltage(jsol, "F.Cu", point), abs=1e-9)
    with pytest.raises(ValueError, match="within 1 mm"):
        validate.probe_voltage(sol, "F.Cu", (300.0, 300.0))
    shrunk = validate._overetched(prob, 0.05)
    jshrunk = jvalidate._overetched(jkicad.load_kicad_project(pro), 0.05)
    assert shrunk.layers[0].shape.area == jshrunk.layers[0].shape.area
    assert shrunk.layers[0].shape.area < prob.layers[0].shape.area


def test_validate_cli_matches_jax(measurement_file, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["validate", str(measurement_file), "--device", "cpu"])
    assert e.value.code == 1            # one reading is off on purpose
    got = capsys.readouterr().out
    assert jvalidate.main([str(measurement_file)]) == 1
    assert got == capsys.readouterr().out
    assert "2/3 within tolerance" in got
    assert validate.main([str(measurement_file), "--json", "--device",
                          "cpu"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["num_pass"] == 2 and report["num_total"] == 3
