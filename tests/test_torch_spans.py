"""The port's span log (padne_tpu_torch.spans) on the CPU: nesting, self
seconds, the log's bound, `recent()`, the spans as torch.profiler user
annotations, the spans a small board's solve emits (and the `stats`
keys filled from them), and the benchmark's span readers
(pdnbench/metrics) on a known log."""

import collections
import time

import numpy as np
import pytest
import torch

from padne_tpu_torch import kicad, mesh, solver, spans
from padne_tpu_torch.ops import cg, schur, spmv

from tests import boardgen

torch.set_num_threads(2)


@pytest.fixture
def log(monkeypatch):
    """A fresh, empty span log for the test."""
    fresh = collections.deque(maxlen=spans.LOG.maxlen)
    monkeypatch.setattr(spans, "LOG", fresh)
    return fresh


def test_nesting_and_self_seconds(log):
    with spans.span("outer") as outer:
        time.sleep(0.02)
        with spans.span("inner") as inner:
            time.sleep(0.03)
            with spans.span("leaf"):
                pass
        with spans.span("inner"):
            pass
    assert [r.name for r in log] == ["leaf", "inner", "inner", "outer"]
    leaf, in1, in2, out = log
    assert [r.depth for r in log] == [2, 1, 1, 0]
    assert len({r.top for r in log}) == 1
    assert out.seconds == outer.seconds and in1.seconds == inner.seconds
    assert inner.seconds >= 0.03 and outer.seconds >= 0.05
    assert in1.self_seconds == pytest.approx(in1.seconds - leaf.seconds)
    assert out.self_seconds == pytest.approx(
        out.seconds - in1.seconds - in2.seconds)
    assert 0.02 <= out.self_seconds < out.seconds - 0.03
    assert out.start <= in1.start <= leaf.start
    assert not any(r.profiled for r in log)
    # A second top-level span starts a tree of its own; an exception
    # leaves the stack as it found it.
    with pytest.raises(ValueError):
        with spans.span("raises"):
            raise ValueError
    with spans.span("next"):
        pass
    assert log[-2].depth == log[-1].depth == 0
    assert len({log[-1].top, log[-2].top, out.top}) == 3


def test_the_log_is_bounded(log):
    assert spans.LOG.maxlen == 2**16
    for _ in range(2**16 + 50):
        with spans.span("s"):
            pass
    assert len(spans.LOG) == 2**16


def test_recent_takes_the_last_unprofiled_top_level_spans(log):
    def request(name, child_s):
        with spans.span(name):
            with spans.span("child"):
                time.sleep(child_s)

    request("a", 0.001)
    request("b", 0.001)
    request("a", 0.002)
    request("b", 0.002)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        request("a", 0.0)
        request("b", 0.0)
    with spans.span("other"):
        with spans.span("child"):
            pass
    assert [r.profiled for r in log][8:12] == [True] * 4
    got = spans.recent(("a", "b"), 1)
    assert set(got) == {"a", "b", "child"}
    assert got["a"][0] == got["b"][0] == 1 and got["child"][0] == 2
    # The last unprofiled ones: the second a and b (log[5], log[7]),
    # with their children (log[4], log[6]).
    assert [r.name for r in log][4:8] == ["child", "a", "child", "b"]
    assert got["child"][1] == pytest.approx(
        log[4].seconds + log[6].seconds)
    assert got["a"][1] == log[5].seconds
    assert got["a"][2] == pytest.approx(log[5].seconds - log[4].seconds)
    both = spans.recent(("a",), 5)
    assert both["a"][0] == 2 and both["child"][0] == 2
    assert spans.recent(("a",), 0) == {}
    assert spans.recent(("missing",), 3) == {}


def test_spans_are_profiler_annotations_around_their_ops(log):
    x = torch.ones(64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("stage.outer"):
            y = x + 1
            with spans.span("stage.inner"):
                y = y * 2
    assert float(y.sum()) == 64 * 4
    events = list(prof.events())
    ann = {e.name: e for e in events
           if getattr(e, "is_user_annotation", False)}
    assert set(ann) == {"stage.outer", "stage.inner"}
    outer = ann["stage.outer"].time_range
    inner = ann["stage.inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    add = next(e for e in events if e.name == "aten::add")
    mul = next(e for e in events if e.name == "aten::mul")
    assert outer.start <= add.time_range.start
    assert add.time_range.end <= inner.start
    assert inner.start <= mul.time_range.start
    assert mul.time_range.end <= inner.end
    assert all(r.profiled for r in log)


def test_no_span_inside_the_cg_iteration(log):
    """A CG solve is one `cg.solve` span, whatever its iterations: the
    plain loop runs the iteration with no span in it (the iteration is
    what a CUDA graph captures on the card)."""
    rng = np.random.default_rng(0)
    n = 400
    idx = np.arange(n)
    cols = np.stack([(idx - 1) % n, (idx + 1) % n], axis=1)
    vals = -np.ones((n, 2))
    diag = np.full(n, 2.0)
    a = spmv.build_operator(cols, vals, diag, n, "cpu", torch.float64)
    b = torch.from_numpy(rng.standard_normal((n, 2)))
    comp = torch.zeros(n, dtype=torch.int64)
    log.clear()
    res = cg.make_pcg(a, comp, 1)(b, 1e-10, 2000)
    assert res.iterations > 20
    assert [r.name for r in log] == ["cg.solve"]


@pytest.fixture(scope="module")
def tiny_board(tmp_path_factory):
    """The 4-layer bench board on 20 mm with a 3 x 3 via grid at 1 mm
    (3,740 unknowns): (project, mesher config, system)."""
    pro = boardgen.gen_bench_4layer(tmp_path_factory.mktemp("tiny"),
                                    side=20.0, n_vias=3)
    cfg = mesh.Mesher.Config(maximum_size=1.0)
    system = solver.build_system(kicad.load_kicad_project(pro), cfg)[0]
    return pro, cfg, system


def _by_name(log):
    return collections.Counter(r.name for r in log)


def _tops(log):
    return [r.name for r in log if r.depth == 0]


def test_a_project_solve_emits_its_spans(log, tiny_board):
    pro, cfg, _ = tiny_board
    stats = {}
    solver.solve(kicad.load_kicad_project(pro), mesher_config=cfg,
                 device="cpu", stats=stats)
    names = _by_name(log)
    assert _tops(log) == ["kicad.load", "solver.solve"]
    for name in ("kicad.load", "solver.solve", "pipeline", "pipeline.mesh",
                 "pipeline.connectivity", "pipeline.assemble",
                 "solver.bordered", "solver.postproc",
                 "schur.solve_bordered", "schur.setup", "cg.solve"):
        assert names[name] >= 1, name
    one = {r.name: r for r in log}
    assert stats["mesh_assemble_s"] == one["pipeline"].seconds
    assert stats["setup_s"] == one["schur.setup"].seconds
    assert stats["postproc_s"] == one["solver.postproc"].seconds
    assert stats["solve_s"] == pytest.approx(
        one["solver.bordered"].seconds - one["schur.setup"].seconds)
    # Stages, not iterations: a few dozen spans a request at most.
    assert len(log) <= 60
    got = spans.recent(("kicad.load", "solver.solve"), 1)
    assert got["pipeline.mesh"][1] == one["pipeline.mesh"].seconds


@pytest.mark.parametrize("precond", ["amg", "jacobi"])
def test_the_ell_route_emits_its_spans(log, tiny_board, precond):
    stats = {}
    schur.solve_bordered(tiny_board[2], device="cpu", stats=stats,
                         inner_dtype=torch.float32, precond=precond)
    assert stats["route"] == "ell"
    names = _by_name(log)
    assert _tops(log) == ["schur.solve_bordered"]
    for name in ("schur.setup", "setup.operators", "setup.upload",
                 "setup.border", "schur.pass", "schur.download",
                 "schur.small", "schur.residual", "cg.solve"):
        assert names[name] >= 1, name
    assert names["setup.hierarchy"] == (precond == "amg")
    assert names["schur.pass"] == names["cg.solve"]
    setup = next(r for r in log if r.name == "schur.setup")
    assert stats["setup_s"] == setup.seconds
    assert len(log) <= 60


def test_the_dia_solver_emits_its_spans(log, tiny_board):
    system = tiny_board[2]
    s = schur.DiaBorderedSolver(system, device="cpu", coarse_size=300)
    setup = _by_name(log)
    for name in ("setup.hierarchy", "setup.operators", "setup.upload",
                 "setup.border"):
        assert setup[name] >= 1, name
    for _ in range(2):
        log.clear()
        s.set_excitation(system.r_core, system.border.rhs)
        sol = s.solve()
        assert sol.residual_norm < 1e-10
        names = _by_name(log)
        assert _tops(log) == ["schur.set_excitation", "schur.solve"]
        for name in ("schur.pass", "schur.refine", "schur.small",
                     "schur.download", "schur.residual", "cg.solve"):
            assert names[name] >= 1, name
        assert names["cg.solve"] == names["schur.pass"] + sol.refinement_steps
    # The host work of the solve lies in its stage spans.
    top = log[-1]
    assert top.self_seconds <= 0.1 * top.seconds
    log.clear()
    stats = {}
    schur.solve_bordered(system, device="cpu", stats=stats, operator="dia",
                         inner_dtype=torch.float32)
    assert stats["route"] == "dia"
    assert _tops(log) == ["schur.solve_bordered"]
    setup = next(r for r in log if r.name == "schur.setup")
    assert stats["setup_s"] == setup.seconds
    assert {"setup.hierarchy", "schur.solve"} <= set(_by_name(log))


# -- the benchmark's readers of the span log -------------------------------

READERS = {
    # metric: (the cell's top-level spans, what it sums)
    "cg_s.resolve": (("schur.set_excitation", "schur.solve"), "cg.solve"),
    "border_s.resolve": (("schur.set_excitation", "schur.solve"), None),
    "cg_s.board": (("schur.solve_bordered",), "cg.solve"),
    "capture_s.board": (("schur.solve_bordered",), "cg.capture"),
    "hierarchy_s.board": (("schur.solve_bordered",), "setup.hierarchy"),
    "operators_s.board": (("schur.solve_bordered",), "setup.operators"),
    "mesh_s.project": (("kicad.load", "solver.solve"), "pipeline.mesh"),
}


def _request(tops, k, profiled=False):
    """One synthetic request: each top-level span with a `cg.solve`, a
    `cg.capture`, a `schur.pass`, a `setup.hierarchy`, a
    `setup.operators` and a `pipeline.mesh` child of k ms each (the
    schur spans' self seconds k ms too)."""
    recs = []
    for name in tops:
        top = next(spans._serial)
        start = 1000.0 * k
        children = ("cg.solve", "cg.capture", "schur.pass",
                    "setup.hierarchy", "setup.operators", "pipeline.mesh")
        for c in children:
            recs.append(spans.Record(c, 1, start, k * 1e-3, k * 1e-3,
                                     profiled, top))
        total = (len(children) + 1) * k * 1e-3
        recs.append(spans.Record(name, 0, start, total, k * 1e-3, profiled,
                                 top))
    return recs


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_takes_the_mean_of_the_last_n(log, metric):
    from pdnbench import harness

    tops, child = READERS[metric]
    reader = harness.metric_reader(metric)
    # Earlier requests (warm-up), the window's 3 (k = 4, 5, 6 ms) and a
    # traced segment under the profiler afterwards.
    for k in (1, 2, 3, 4, 5, 6):
        log.extend(_request(tops, k))
    log.extend(_request(tops, 50, profiled=True))
    run = harness.Run("c", setup_s=1.0, latencies=[0.1] * 3)
    got = reader.read(run)
    if child is None:
        # Self seconds of every schur.* span: the pass and the
        # top-level span where it is a schur one.
        per = sum(1 + t.startswith("schur.") for t in tops)
        want = per * (4 + 5 + 6) * 1e-3 / 3
    else:
        want = len(tops) * (4 + 5 + 6) * 1e-3 / 3
    assert got == pytest.approx(want)
    assert reader.read(harness.Run("c", setup_s=1.0)) is None
    log.clear()
    # A log without the cell's top-level spans: nothing to read.
    log.extend(_request(("elsewhere",), 1))
    assert reader.read(run) is None
