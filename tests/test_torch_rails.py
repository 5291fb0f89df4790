"""The regulated board of the benchmark's `soc_rails_1m` configuration
(pdnbench/railboard.py) in its 4-regulator version (two bucks on 12 V,
an LDO fed by one of them, an LDO on 12 V; 9,839 unknowns): the board
through the frozen pipeline, its border as the port, the frozen
assembly and the plain reference (pdnbench/reference/mna.py) stamp it,
the port's DIA solve and whole solve against the reference's dense
solve, the counters the port adds for regulators and the projector, and
the cell through the harness (CPU)."""

import json
import time

import numpy as np
import pytest
import torch

from padne_tpu_torch import kicad, mesh, solver, spans
from padne_tpu_torch.ops import cg, schur
from pdnbench.test_pdnbench_rails import CELL, make_small, small_config

torch.set_num_threads(2)

# Potentials within 1e-9 V: the solves stop at a 1e-10 absolute residual
# of currents of about an ampere on conductances of 1e2 - 1e5 S, so a
# potential is off by well under a nanovolt; float32 alone (the inner
# solve's precision, unrefined) would be off by ~1e-7 V.  Border
# currents within 1e-9 of the largest, relative: the same residual over
# currents of up to a few amperes.
DV, DJ = 1e-9, 1e-9


@pytest.fixture(scope="module")
def board(tmp_path_factory):
    """(config, inputs, the board's .kicad_pro) of the small rail board,
    made once."""
    from pdnbench import inputs, railboard

    tmp = tmp_path_factory.mktemp("rails")
    cache, inputs.CACHE = inputs.CACHE, tmp / "cache"
    try:
        config = small_config()
        inp = railboard.rail_inputs(config, tmp / "board")
        yield config, inp, tmp / "board" / "rail_board" / "rail_board.kicad_pro"
    finally:
        inputs.CACHE = cache


@pytest.fixture(scope="module")
def dense(board):
    """The reference's dense solve of the nominal excitation (its LU on
    four threads)."""
    from pdnbench.reference import mna

    _, inp, _ = board
    ref = mna.Reference(inp, dense=True)
    torch.set_num_threads(4)
    try:
        return ref.solve(inp.r_core, inp.b_rhs)
    finally:
        torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dia(board):
    """The port's DIA solver of the board, with a hierarchy."""
    return schur.DiaBorderedSolver(_system(board[1]), device="cpu",
                                   coarse_size=1000)


def _system(inp):
    from pdnbench.entries import _program

    return _program.core_system(inp, inp.ell(), inp.r_core.copy(),
                                inp.b_rhs.copy())


def test_the_board_has_a_rail_a_regulator(board):
    config, inp, _ = board
    comp = inp.comp_id
    assert inp.n == config["n"] and inp.m == 6
    assert int(inp.num_components) == 6
    assert list(inp.src_regulator) == [False, True, True, True, True]
    # The 12 V input first, the ground pin (on its negative pad) last.
    np.testing.assert_allclose(inp.b_rhs, [12.0, 0.85, 1.8, 1.2, 2.5, 0.0])
    ground = comp[inp.src_nodes[0, 1]]
    assert int(inp.ground_var) == 5
    assert comp[inp.b_row_node[inp.b_row_idx == 5]] == [ground]
    rails = {}
    for k, (name, volts, kind, source, _, _) in enumerate(
            config["board"]["args"]["rails"], start=1):
        p, n, f, t = inp.src_nodes[k]
        rails[name] = comp[p]
        # Ground at n and f; the input pad on its source's copper.
        assert comp[n] == comp[f] == ground
        assert comp[t] == (comp[inp.src_nodes[0, 0]] if source == "12V"
                           else rails[source])
        gain = volts / (12 * 0.9) if kind == "buck" else 1.0
        assert inp.src_gain[k] == pytest.approx(gain, rel=1e-15)
        cols = inp.b_col_idx == k
        assert sorted(inp.b_col_val[cols]) == sorted([1.0, -1.0, gain,
                                                      -gain])
    assert len(set(rails.values()) | {ground}) == 5
    # A load a rail, from the rail to ground.
    assert sorted(comp[inp.cur_f]) == sorted(rails.values())
    assert set(comp[inp.cur_t]) == {ground}


def _coo(idx, node, val, shape, transpose=False):
    import scipy.sparse

    rc = (node, idx) if transpose else (idx, node)
    return scipy.sparse.coo_matrix((val, rc), shape=shape).tocsr()


def test_the_border_is_stamped_alike_three_ways(board):
    """The port's build_system (its own loader and pipeline), the frozen
    assembly and the reference's own stamps give the same B, C and
    right-hand side, entry for entry."""
    from pdnbench.reference import mna

    config, inp, pro = board
    system = solver.build_system(kicad.load_kicad_project(pro),
                                 mesh.Mesher.Config(**config["mesher"]))[0]
    got, want = system.border, inp
    assert system.n == inp.n
    for key in ("row_idx", "row_node", "row_val", "col_idx", "col_node",
                "col_val", "rhs"):
        np.testing.assert_array_equal(getattr(got, key),
                                      getattr(want, f"b_{key}"))
    B, C, volts = mna.border(inp)
    n, m = inp.n, inp.m
    assert (B != _coo(inp.b_row_idx, inp.b_row_node, inp.b_row_val,
                      (m, n))).nnz == 0
    assert (C != _coo(inp.b_col_idx, inp.b_col_node, inp.b_col_val,
                      (n, m), transpose=True)).nnz == 0
    np.testing.assert_array_equal(volts, inp.b_rhs)
    assert schur.count_regulators(system.border) == 4


def test_the_dia_solver_matches_the_dense_reference(dia, dense):
    v_ref, j_ref = dense
    assert len(dia.hierarchy.levels) >= 2
    got = dia.solve()
    assert np.abs(got.v - v_ref).max() <= DV
    assert np.abs(got.j - j_ref).max() <= DJ * np.abs(j_ref).max()


def test_the_whole_solve_matches_the_dense_reference(board, dense):
    """solver.solve from the KiCad project: every mesh vertex's potential
    against the reference's, in the order of its layer solutions."""
    from pdnbench.reference import check

    config, inp, pro = board
    sol = solver.solve(kicad.load_kicad_project(pro),
                       mesher_config=mesh.Mesher.Config(**config["mesher"]),
                       device="cpu")
    pots = np.concatenate([p.values for ls in sol.layer_solutions
                           for p in ls.potentials])
    want = check.vertex_potentials(inp, dense[0])
    assert pots.shape == want.shape
    assert np.abs(pots - want).max() <= DV


def test_the_counters_count_regulators_and_projector_bytes(dia,
                                                          monkeypatch):
    """regulators: the four regulators' columns; projector_bytes: each CG
    call's applications (two an iteration, three a call) of the one-hot,
    (padded rows, p + 1) f32 read twice."""
    s = dia
    calls = []
    run = s.cg_solver

    def recorded(*args):
        res = run(*args)
        calls.append(res.iterations)
        return res

    recorded.loop, recorded.projector = run.loop, run.projector
    monkeypatch.setattr(s, "cg_solver", recorded)
    for _ in range(2):
        calls.clear()
        s.solve()
        got = s.counters()
        assert got["projector"] == "onehot" and got["regulators"] == 4
        assert got["components"] == 6 and got["border_rows"] == 6
        per_call = 2 * s.np0 * (s.p + 1) * 4
        assert got["projector_bytes"] == sum(
            (2 * k + 3) * per_call for k in calls) > 0


@pytest.mark.parametrize("count, kind", [(1, "mean"), (5, "onehot"),
                                         (70, "segment")])
def test_a_cg_call_counts_its_projector_bytes(count, kind):
    """make_pcg's and make_pcg_sharded's projector_bytes: applications
    times the projector's operand bytes (none for the means; the
    segment sums' indices and the spread's int64 index)."""
    from padne_tpu_torch.ops import segment
    from padne_tpu_torch.parallel import sharding

    n = 700
    comp = torch.arange(n) % count
    a = torch.rand(n, dtype=torch.float64) + 1.0
    op = (lambda _, x: a[:, None] * x, None)
    jacobi = (lambda _, r: r / a[:, None], None)
    solve = cg.make_pcg(None, comp, count, operator=op, precond=jacobi)
    res = solve(torch.rand(n, 2, dtype=torch.float64), 1e-8, 50)
    per = {"mean": 0, "onehot": 2 * n * count * 4,
           "segment": segment.SegmentSum(comp, count).index_bytes()
           + n * 8}[kind]
    assert solve.projector == kind
    assert res.projector_bytes == (2 * res.iterations + 3) * per
    mesh_ = sharding.Mesh(["cpu"] * 2)
    sharded = cg.make_pcg_sharded(
        mesh_, (lambda _, xs: [ai[:, None] * x for ai, x in zip(
            sharding.split(mesh_, a, 0), xs)], None), comp, count,
        (lambda _, rs: rs, None))
    res = sharded(torch.rand(n, 1, dtype=torch.float64), 1e-8, 20)
    halves = [c for c in sharding.split(mesh_, comp, 0)]
    per = {"mean": sum(2 * len(c) * 1 * 4 for c in halves),
           "onehot": 2 * n * count * 4,
           "segment": sum(segment.SegmentSum(c, count).index_bytes()
                          + len(c) * 8 for c in halves)}[kind]
    assert res.projector_bytes == (2 * res.iterations + 3) * per


def test_the_cell_runs_correct_and_its_metrics_read(board, tmp_path):
    """A sound run is correct by both checks; the cell's per-layer
    metrics read its requests (the device idle share needs a traced
    segment on the card: None here).  The board's inputs come from the
    module's cache."""
    from pdnbench import harness
    from pdnbench.entries import rail_resolve

    bench, root = make_small(tmp_path)
    result, checks = harness.run_cell(bench, CELL, 2**31 + 5, 0.01, False,
                                      "cpu", time.perf_counter(), root)
    assert result["correct"] is True and result["failed"] == 0
    assert [name for name, _, _ in checks] == ["rel_residual",
                                               "max_rail_dv"]
    assert set(result["metrics"]) == {"setup_s", "solve_s"}
    assert {m["name"] for m in harness.metrics_of(bench, CELL, True)} == {
        "passes.rails", "cg_iters.rails", "projector_gb.rails",
        "cg_s.rails", "border_s.rails", "device_idle.rails"}
    cell = harness.cell_of(bench, CELL)
    ctx = harness.Context(harness.config_of(bench, cell, root),
                          harness.traffic_of(cell["traffic"]), 3, "cpu",
                          str(tmp_path))
    drv = rail_resolve.Entry(ctx)
    drv.warm_up()
    run = harness.Run(CELL, setup_s=1.0)
    for i in range(2):
        t = time.perf_counter()
        _, counters = drv.request(i)
        run.latencies.append(time.perf_counter() - t)
        run.counters.append(counters)
    assert counters["regulators"] == 4 and counters["projector"] == "onehot"

    def read(name):
        return harness.metric_reader(name).read(run)

    assert read("passes.rails") == np.mean([c["passes"]
                                            for c in run.counters]) >= 1
    assert read("cg_iters.rails") == np.mean(
        [c["cg_iterations"] for c in run.counters]) > 0
    assert read("projector_gb.rails") == pytest.approx(np.mean(
        [c["projector_bytes"] for c in run.counters]) / 1e9)
    got = spans.recent(("schur.set_excitation", "schur.solve"), 2)
    assert read("cg_s.rails") == pytest.approx(got["cg.solve"][1] / 2)
    assert 0 < read("border_s.rails") < sum(run.latencies) / 2
    assert read("device_idle.rails") is None
    assert json.dumps(counters)
