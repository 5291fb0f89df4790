"""The site board of the benchmark's `fragmented_1m` configuration
(pdnbench/siteboard.py) at 8 x 8 sites and a few thousand DoF: the
board through the frozen pipeline, the port's DIA solve of it against
SciPy's direct solve, the cell's request pool, and the spans and
counters the port adds for a wide border (CPU)."""

import collections
import json
import pathlib

import numpy as np
import pytest
import torch

from padne_tpu_torch import spans
from padne_tpu_torch.ops import cg, schur

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SITES = 64


def small_config() -> dict:
    """fragmented_1m's configuration at 8 x 8 sites (65 components, one
    above the one-hot projector's 64) and 4,845 unknowns."""
    config = json.loads(
        (ROOT / "pdnbench" / "configs" / "fragmented_1m.json").read_text())
    config["board"]["args"]["sites"] = [8, 8]
    config["mesher"]["target_dof"] = 4000
    config.update(name="sites8", n=4845, m=SITES + 1,
                  components=SITES + 1)
    return config


@pytest.fixture(scope="module")
def board(tmp_path_factory):
    """(config, inputs) of the small site board, made once."""
    from pdnbench import inputs, siteboard

    tmp = tmp_path_factory.mktemp("sites")
    cache, inputs.CACHE = inputs.CACHE, tmp / "cache"
    try:
        config = small_config()
        yield config, siteboard.site_inputs(config, tmp / "board")
    finally:
        inputs.CACHE = cache


def _ctx(config, seed, tmp):
    from pdnbench import harness

    return harness.Context(config, harness.traffic_of("site_resolve"), seed,
                           "cpu", str(tmp))


def test_the_board_has_an_island_and_a_border_row_a_site(board):
    _, inp = board
    assert inp.n == 4845
    assert int(inp.num_components) == SITES + 1 and inp.m == SITES + 1
    comp = inp.comp_id
    ground = comp[inp.cur_t[0]]
    islands = set()
    for t in range(SITES):
        rows = inp.b_row_idx == t
        # The supply: +1 on its island's feed pad, -1 on the ground zone.
        assert sorted(inp.b_row_val[rows]) == [-1.0, 1.0]
        nodes = inp.b_row_node[rows][np.argsort(-inp.b_row_val[rows])]
        island, back = comp[nodes]
        assert back == ground and island != ground
        islands.add(int(island))
        # The load draws from the same island into the ground zone.
        assert comp[inp.cur_f[t]] == island and comp[inp.cur_t[t]] == ground
    assert len(islands) == SITES
    np.testing.assert_allclose(inp.b_rhs, np.append(
        0.5 + 0.002 * np.arange(SITES), 0.0), rtol=0, atol=1e-12)
    np.testing.assert_allclose(inp.cur_i, 0.2 + 0.002 * np.arange(SITES),
                               rtol=0, atol=1e-12)
    # The ground pin, last, on the ground zone.
    assert int(inp.ground_var) == SITES
    assert comp[inp.b_row_node[inp.b_row_idx == SITES]] == [ground]


def test_the_pipeline_refuses_a_board_other_than_stated(tmp_path,
                                                        monkeypatch):
    from pdnbench import inputs, siteboard

    monkeypatch.setattr(inputs, "CACHE", tmp_path / "cache")
    config = {**small_config(), "components": 64}
    with pytest.raises(RuntimeError, match="components = 65"):
        siteboard.site_inputs(config, tmp_path / "board")


def test_the_pool_is_one_set_in_each_seeds_order(board, tmp_path):
    from pdnbench.entries import site_resolve

    config, inp = board
    pools = [site_resolve.requests(_ctx(config, seed, tmp_path), inp)
             for seed in (5, 2**31 + 9)]
    keys = [[(rc.tobytes(), rhs.tobytes()) for rc, rhs in pool]
            for pool in pools]
    assert len(keys[0]) == 36 and len(set(keys[0])) == 36
    assert sorted(keys[0]) == sorted(keys[1]) and keys[0] != keys[1]
    # Every site's load and supply at one of the mix's levels, drawn
    # site by site.
    rc, rhs = pools[0][0]
    load = rc[inp.cur_f] / inp.cur_i
    supply = rhs[:SITES] / inp.b_rhs[:SITES]
    assert set(np.round(load, 12)) == {0.75, 1.0, 1.25}
    assert set(np.round(supply, 12)) == {0.9, 1.1}


def test_the_dia_solve_matches_the_direct_solve(board, tmp_path):
    """Every site's excitation from a seeded draw, through the solver the
    cell drives: relative residual and potentials within 1e-9 of
    SciPy's direct solve; the cell's check fails on the same answers
    rounded to float32."""
    from pdnbench import control
    from pdnbench.entries import _program, site_resolve
    from pdnbench.reference import check

    config, inp = board
    ref = check.Bordered(inp, inp.ell())
    pool = site_resolve.requests(_ctx(config, 2**31 + 77, tmp_path), inp)
    system = _program.core_system(inp, inp.ell(), inp.r_core.copy(),
                                  inp.b_rhs.copy())
    solver = schur.DiaBorderedSolver(system, device="cpu")
    for rc, rhs in pool[:2]:
        solver.set_excitation(rc, rhs)
        got = solver.solve()
        v, j = ref.direct(rc, rhs)
        assert ref.rel_residual(rc, rhs, got.v, got.j) <= 1e-9
        assert np.abs(got.v - v).max() <= 1e-9
        assert np.abs(got.j - j).max() <= 1e-9 * np.abs(j).max()
        assert ref.rel_residual(rc, rhs, control._f32(v),
                                control._f32(j)) > config["check"][
                                    "rel_residual"]
        assert check.max_abs_diff(control._f32(v[inp.cur_f]),
                                  v[inp.cur_f]) > config["check"][
                                      "max_site_dv"]


def test_projector_kind_follows_the_component_count():
    assert [cg.projector_kind(p) for p in (1, 2, 64, 65, 146)] == [
        "mean", "onehot", "onehot", "segment", "segment"]


@pytest.mark.parametrize("count, kind", [(1, "mean"), (2, "onehot"),
                                         (65, "segment")])
def test_the_cg_reports_the_projector_it_built(count, kind):
    """make_pcg's and make_pcg_sharded's `projector` is the branch their
    projector took, and DiaBorderedSolver.counters() reads it."""
    from padne_tpu_torch.parallel import sharding

    comp = torch.arange(128) % count
    jacobi = (lambda _, r: r, None)
    solve = cg.make_pcg(None, comp, count, operator=(lambda _, x: x, None),
                        precond=jacobi)
    assert solve.projector == cg.make_projector(comp, count).kind == kind
    sharded = cg.make_pcg_sharded(sharding.Mesh(["cpu"] * 2),
                                  (lambda _, xs: xs, None), comp, count,
                                  (lambda _, rs: rs, None))
    # The sharded projector sums by one-hot for one component too.
    assert sharded.projector == ("onehot" if kind == "mean" else kind)


def test_the_counters_read_the_solvers_own_projector(board, monkeypatch):
    from pdnbench.entries import _program

    _, inp = board
    monkeypatch.setattr(cg, "projector_kind",
                        lambda count: "mean" if count == 1 else "onehot")
    system = _program.core_system(inp, inp.ell(), inp.r_core.copy(),
                                  inp.b_rhs.copy())
    solver = schur.DiaBorderedSolver(system, device="cpu")
    assert solver.counters()["projector"] == "onehot"
    assert solver.cg_solver.projector == "onehot"


@pytest.fixture
def log(monkeypatch):
    fresh = collections.deque(maxlen=spans.LOG.maxlen)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def test_the_wide_border_spans_nest_and_the_counters(board, log):
    """The first solve's A^+ C is one `schur.border_solve` inside its
    pass, around the R = m + 1 CG; every pass's border products are one
    `schur.border_products` inside its `schur.download`; the counters
    give the widths, and the one SVD of the small block taken with A^+ C
    (a `schur.factor` inside the `schur.border_solve`)."""
    from pdnbench.entries import _program

    _, inp = board
    system = _program.core_system(inp, inp.ell(), inp.r_core.copy(),
                                  inp.b_rhs.copy())
    solver = schur.DiaBorderedSolver(system, device="cpu")
    assert solver.counters() == {
        "route": "dia", "components": SITES + 1, "border_rows": SITES + 1,
        "small_width": 2 * (SITES + 1), "projector": "segment",
        "small_factorizations": 0, "setup_threads": 1, "regulators": 0,
        "projector_bytes": 0, "graph_calls": 0}
    log.clear()
    for _ in range(2):
        solver.solve()
    assert solver.counters()["small_factorizations"] == 1
    records = list(log)
    first = [r for r in records if r.top == records[0].top]

    def parent(rec, recs):
        """The innermost record that encloses rec."""
        return min((r for r in recs if r.depth == rec.depth - 1
                    and r.start <= rec.start
                    and rec.start + rec.seconds <= r.start + r.seconds),
                   key=lambda r: r.seconds)

    border = [r for r in records if r.name == "schur.border_solve"]
    assert len(border) == 1 and border[0] in first
    assert parent(border[0], first).name == "schur.pass"
    inner = [r for r in first if r.name == "cg.solve"
             and border[0].start <= r.start <= border[0].start
             + border[0].seconds]
    assert len(inner) == 1 and parent(inner[0], first) is border[0]
    factor = [r for r in records if r.name == "schur.factor"]
    assert len(factor) == 1 and parent(factor[0], first) is border[0]
    products = [r for r in records if r.name == "schur.border_products"]
    passes = [r for r in records if r.name == "schur.pass"]
    assert len(products) == len(passes) >= 2
    for rec in products:
        assert parent(rec, records).name == "schur.download"


def test_the_wide_seconds_reader(log):
    """wide_s.fragmented: border products and small block, seconds a
    window request; nothing to read without border product spans."""
    from pdnbench import harness

    reader = harness.metric_reader("wide_s.fragmented")
    run = harness.Run("c", setup_s=1.0, latencies=[0.1] * 2)

    def request(with_products):
        with spans.span("schur.set_excitation"):
            pass
        with spans.span("schur.solve"):
            with spans.span("schur.download"):
                if with_products:
                    with spans.span("schur.border_products"):
                        pass
            with spans.span("schur.small"):
                pass

    request(False)
    assert reader.read(run) is None
    for _ in range(3):
        request(True)
    got = spans.recent(reader.TOP, 2)
    want = (got["schur.border_products"][1] + got["schur.small"][1]) / 2
    assert reader.read(run) == pytest.approx(want)
    assert reader.read(harness.Run("c", setup_s=1.0)) is None
