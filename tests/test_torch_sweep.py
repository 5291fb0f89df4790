"""Port parity for padne_tpu_torch.sweep against padne_tpu.sweep: the
two strip problems of the JAX package's sweep tests (Jacobi branch) and
one generated 4-layer board above 20,000 DoF (AMG branch), the same
specs through both.

Gates per spec: potentials within 1e-9 V, border currents within 1e-9 of
the largest (of 1 A where all are smaller), residual below 1e-8; the scaling laws of the JAX package's
tests hold for the port alone as well."""

import warnings

import numpy as np
import pytest
import torch

from padne_tpu import kicad as jkicad
from padne_tpu import mesh as jmesh
from padne_tpu import sweep as jsweep
from padne_tpu_torch import (device, geom, kicad, mesh, problem, solver,
                             sweep)
from padne_tpu_torch.ops import spmv

from tests import boardgen
from tests.test_sweep import make_current_problem, make_strip_problem

torch.set_num_threads(1)

SPECS = [(s, v) for s in (0.5, 1.0, 2.0) for v in (1.0, 3.3)]


def port_strip_problem(kind, value=1.0):
    """The port's twin of tests.test_sweep's strip problems."""
    rect = geom.Polygon([(0, 0), (10, 0), (10, 1), (0, 1)])
    layer = problem.Layer(shape=geom.MultiPolygon([rect]), name="L",
                          conductance=2.0)
    c_a = problem.Connection(layer=layer, point=geom.Point(0, 0))
    c_b = problem.Connection(layer=layer, point=geom.Point(10, 0))
    element = (
        problem.VoltageSource(p=c_b.node_id, n=c_a.node_id, voltage=value)
        if kind == "voltage" else
        problem.CurrentSource(f=c_b.node_id, t=c_a.node_id, current=value))
    net = problem.Network(connections=[c_a, c_b], elements=[element])
    return problem.Problem(layers=[layer], networks=[net])


def assert_sweeps_agree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.spec.conductance_scale, g.spec.source_scale) == (
            w.spec.conductance_scale, w.spec.source_scale)
        assert g.v.shape == w.v.shape and g.v.dtype == np.float64
        assert np.abs(g.v - w.v).max() <= 1e-9
        # A ground pin that carries no current is rounding noise in both.
        assert np.abs(g.j - w.j).max() <= 1e-9 * max(np.abs(w.j).max(), 1.0)
        assert g.residual_norm < 1e-8 and w.residual_norm < 1e-8


@pytest.mark.parametrize("kind", ["voltage", "current"])
def test_strip_sweep_matches_jax(kind):
    jprob = (make_strip_problem() if kind == "voltage"
             else make_current_problem())
    want = jsweep.solve_sweep(jprob, [jsweep.SweepSpec(*x) for x in SPECS])
    stats = {}
    got = sweep.solve_sweep(port_strip_problem(kind),
                            [sweep.SweepSpec(*x) for x in SPECS],
                            device="cpu", stats=stats)
    assert stats["n"] < sweep._AMG_THRESHOLD        # the Jacobi branch
    assert stats["cg_iterations"] > 0
    assert_sweeps_agree(got, want)


def test_voltage_sweep_spans():
    """A voltage-driven span equals the scaled source, whatever the
    conductance."""
    results = sweep.solve_sweep(port_strip_problem("voltage"),
                                [sweep.SweepSpec(*x) for x in SPECS],
                                device="cpu")
    for r in results:
        assert r.residual_norm < 1e-8
        assert r.v.max() - r.v.min() == pytest.approx(r.spec.source_scale,
                                                       abs=1e-6)


def test_current_sweep_scaling():
    """With a current source the drop scales with I / sigma."""
    specs = [sweep.SweepSpec(conductance_scale=1.0),
             sweep.SweepSpec(conductance_scale=2.0),
             sweep.SweepSpec(conductance_scale=1.0, source_scale=2.0)]
    r1, r2, r3 = sweep.solve_sweep(port_strip_problem("current"), specs,
                                   device="cpu")
    span1, span2, span3 = (r.v.max() - r.v.min() for r in (r1, r2, r3))
    assert span2 == pytest.approx(span1 / 2, rel=1e-9)
    assert span3 == pytest.approx(span1 * 2, rel=1e-9)


def test_sweep_matches_single_solve():
    prob = port_strip_problem("voltage", 2.5)
    [r] = sweep.solve_sweep(prob, [sweep.SweepSpec()], device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = solver.solve(prob, device="cpu")
    full = np.concatenate([p.values
                           for p in sol.layer_solutions[0].potentials])
    # Same mesher config, same mesh: the same vertex order.
    assert np.abs(full - r.v[:len(full)]).max() < 1e-8


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sweep.solve_sweep(port_strip_problem("voltage"), [sweep.SweepSpec()])


def test_bench_board_sweep_matches_jax(tmp_path, monkeypatch):
    """Above 20,000 DoF the CG runs under the ELL AMG cycle: one f64
    multi-RHS solve for all specs, every product through the one ELL
    wrapper (counted here by its CPU stand-in: the CG's product and the
    cycle's lines at R = m + 1, then one fused residual at R 1 per
    spec)."""
    pro = boardgen.gen_bench_4layer(tmp_path)
    prob = kicad.load_kicad_project(pro)
    area = sum(layer.shape.area for layer in prob.layers)
    size = (area / (0.43 * 15000)) ** 0.5
    kw = dict(maximum_size=size, variable_size_maximum_factor=1.0)
    specs = [(0.5, 1.0), (2.0, 3.3), (4.0, 2.0), (1.0, 1.0)]

    shapes = []
    real = spmv.ell_spmv_plain

    def recording(op, x, b=None, w=None, x0=None):
        shapes.append((op.n, x.shape[1], x.dtype))
        return real(op, x, b, w, x0)

    monkeypatch.setattr(spmv, "ell_spmv_plain", recording)
    stats = {}
    got = sweep.solve_sweep(prob, [sweep.SweepSpec(*x) for x in specs],
                            mesher_config=mesh.Mesher.Config(**kw),
                            device="cpu", stats=stats)
    monkeypatch.undo()
    n, m = stats["n"], stats["m"]
    assert n >= sweep._AMG_THRESHOLD and stats["p"] == 1
    assert all(dtype == torch.float64 for _, _, dtype in shapes)
    wide = [s for s in shapes if s[1] == m + 1]
    narrow = [s for s in shapes if s[1] == 1]
    assert len(wide) + len(narrow) == len(shapes)
    assert narrow == [(n, 1, torch.float64)] * len(specs)
    # One CG: a product per iteration and the true residual, and a cycle
    # per iteration and one before the first, each with three lines of n
    # rows (residual, x0 + P xc, the smoothing step).
    k = stats["cg_iterations"]
    assert sum(s[0] == n for s in wide) == (k + 1) + 3 * (k + 1)
    print(f"n={n}: {k} CG iterations, {len(wide)} products at R={m + 1}")

    want = jsweep.solve_sweep(
        jkicad.load_kicad_project(pro),
        [jsweep.SweepSpec(*x) for x in specs],
        mesher_config=jmesh.Mesher.Config(**kw))
    assert_sweeps_agree(got, want)
    # Conductance scaling of a board driven by voltage and current
    # sources alike: the spec (1, 1) against a single solve.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = solver.solve(prob, mesher_config=mesh.Mesher.Config(**kw),
                           device="cpu")
    full = np.concatenate([p.values for ls in sol.layer_solutions
                           for p in ls.potentials])
    assert np.abs(np.sort(full) - np.sort(got[3].v[:len(full)])).max() < 1e-6
