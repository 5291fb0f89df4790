"""Port parity for the viewer: padne_tpu_torch.colormaps, .raster and .ui
against padne_tpu's, on the same seeded inputs and the same solution.

Gates: the colormap tables and their lookups bit-equal (the JAX
package samples matplotlib here); rasters bit-equal on seeded meshes;
the matplotlib viewer under Agg, driven through the cases of
tests/test_ui.py, observes the same values, titles, limits and probes
and computes bit-equal rasters; its worker pool and timer are shut down
when the figure closes; the headless `ui.main` writes HTML byte-equal
to the JAX package's."""

import warnings

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.spatial  # noqa: E402

from padne_tpu import colormaps as jcolormaps  # noqa: E402
from padne_tpu import kicad as jkicad  # noqa: E402
from padne_tpu import raster as jraster  # noqa: E402
from padne_tpu import solver as jsolver  # noqa: E402
from padne_tpu import ui as jui  # noqa: E402
from padne_tpu.io import solution as jsolution_io  # noqa: E402
from padne_tpu_torch import colormaps, raster, ui  # noqa: E402
from padne_tpu_torch.io import solution as solution_io  # noqa: E402


def same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# colormaps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["VIRIDIS", "PLASMA", "INFERNO"])
def test_colormap_tables_and_lookups(name):
    got, want = getattr(colormaps, name), getattr(jcolormaps, name)
    assert got.table.shape == (256, 3)
    assert same(got.table, want.table)
    rng = np.random.default_rng(3)
    values = rng.uniform(-0.2, 1.2, 500)
    values[:3] = (0.0, 1.0, 255 / 256)
    assert same(got.map_array(values), want.map_array(values))
    assert all(got(float(v)) == want(float(v)) for v in values)


def test_colormaps_reject_bad_tables():
    with pytest.raises(ValueError):
        colormaps.UniformColorMap(np.zeros((4, 4)))


# ---------------------------------------------------------------------------
# raster
# ---------------------------------------------------------------------------
def seeded_mesh(seed, npts, box=10.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, box, (npts, 2))
    return pts, scipy.spatial.Delaunay(pts).simplices.astype(np.int32), rng


def raster_case(case):
    """(items, extent, shape, chunk) of one seeded case."""
    pts, tris, rng = seeded_mesh(7, 1500)
    if case == "vertex":
        return [(pts, tris, rng.standard_normal(len(pts)), "vertex")], \
            (0.0, 10.0, 0.0, 10.0), (90, 120), 200_000
    if case == "face":
        return [(pts, tris, rng.standard_normal(len(tris)), "face")], \
            (0.0, 10.0, 0.0, 10.0), (90, 120), 200_000
    if case == "slivers":
        # Zero-area triangles (collinear and repeated vertices) paint
        # nothing; they sit among ordinary ones.
        line = np.array([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0], [4.0, 1.0]])
        verts = np.concatenate([pts, line])
        k = len(pts)
        bad = np.array([[k, k + 1, k + 2], [k + 3, k + 3, k + 1],
                        [k, k, k]], dtype=np.int32)
        both = np.concatenate([tris, bad])
        return [(verts, both, rng.standard_normal(len(verts)), "vertex"),
                (verts, both, rng.standard_normal(len(both)), "face")], \
            (0.0, 10.0, 0.0, 10.0), (90, 120), 200_000
    if case == "large":
        # A few triangles, each much larger than the candidate grid.
        verts = np.array([[0.0, 0.0], [10.0, 0.0], [10.0, 10.0],
                          [0.0, 10.0], [5.0, 4.0]])
        big = np.array([[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]],
                       dtype=np.int32)
        return [(verts, big, rng.standard_normal(5), "vertex"),
                (verts + 20.0, big, rng.standard_normal(4), "face")], \
            (-1.0, 31.0, -2.0, 31.0), (64, 48), 200_000
    if case == "chunked_zoom":
        # A chunk smaller than the triangle count, both kinds, in a
        # zoomed window that culls most of the mesh.
        return [(pts, tris, rng.standard_normal(len(pts)), "vertex"),
                (pts + 0.5, tris, rng.standard_normal(len(tris)), "face")], \
            (2.0, 6.5, 3.0, 7.0), (70, 50), 333
    raise ValueError(case)


@pytest.mark.parametrize("case", ["vertex", "face", "slivers", "large",
                                  "chunked_zoom"])
def test_rasterize_field_is_bit_equal(case):
    items, extent, shape, chunk = raster_case(case)
    got = raster.rasterize_field(items, extent, shape, chunk=chunk)
    want = jraster.rasterize_field(items, extent, shape, chunk=chunk)
    assert got.shape == shape and np.isfinite(got).any()
    assert same(got, want)


def test_slivers_paint_nothing():
    verts = np.array([[1.0, 1.0], [2.0, 2.0], [3.0, 3.0]])
    out = raster.rasterize_field(
        [(verts, np.array([[0, 1, 2]]), np.ones(3), "vertex")],
        (0.0, 4.0, 0.0, 4.0), (16, 16))
    assert np.isnan(out).all()


# ---------------------------------------------------------------------------
# ui: the same strip solution through both packages' loaders
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def artifact(boards_dir, tmp_path_factory):
    prob = jkicad.load_kicad_project(
        boards_dir / "gen_strip" / "gen_strip.kicad_pro")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sol = jsolver.solve(prob)
    path = tmp_path_factory.mktemp("viewer") / "strip.npz"
    jsolution_io.save_solution(sol, path)
    return path


@pytest.fixture(scope="module")
def solutions(artifact):
    """(port Solution, JAX Solution) with the same arrays."""
    return (solution_io.load_solution(artifact),
            jsolution_io.load_solution(artifact))


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


class Key:
    def __init__(self, key):
        self.key = key


class Click:
    def __init__(self, x, y, button=None):
        self.xdata, self.ydata, self.button = x, y, button


def norm(v):
    n = v._cbar.mappable.norm
    return (float(n.vmin), float(n.vmax), v._cbar.mappable.get_cmap().name)


def scenario_initial(v):
    return [v.mode.name, v.value_range(), norm(v), v.ax.get_title(),
            v._box_lo.text, v._box_hi.text]


def scenario_mode_switch(v):
    out = [v.value_range()]
    v.on_key(Key("m"))
    out += [v.mode.name, v.value_range(), norm(v), v.ax.get_title()]
    v.on_key(Key("m"))
    return out + [v.mode.name, norm(v)]


def scenario_probe_and_scale(v):
    vx, vy = v.layer_solution.meshes[0].vertices[0]
    v.on_click(Click(float(vx), float(-vy)))
    out = [v.last_probe, v.ax.get_xlabel()]
    v.on_key(Key("n"))
    out += [v.scale_override, norm(v)]
    v.on_key(Key("r"))
    return out + [v.scale_override, norm(v)]


def scenario_mode_clears_override(v):
    vx, vy = v.layer_solution.meshes[0].vertices[0]
    v.on_click(Click(float(vx), float(-vy)))
    v.on_key(Key("x"))
    out = [v.scale_override]
    v.on_key(Key("m"))
    return out + [v.scale_override, v.last_probe, norm(v)]


def scenario_toggles_and_ignored_input(v):
    out = [len(v.ax.lines)]
    v.on_key(Key("e"))
    v.on_key(Key("c"))
    out += [v.show_edges, v.show_connections, len(v.ax.lines),
            len(v.ax.collections)]
    v.on_key(Key("e"))
    v.on_key(Key("c"))
    v.on_key(Key("9"))
    v.on_click(Click(None, None))
    return out + [v.show_edges, v.show_connections, v.layer_idx,
                  v.last_probe]


def scenario_probes(v):
    ls = v.layer_solution
    m = ls.meshes[0]
    k = m.num_vertices // 3
    out = [v.probe_value(*map(float, m.vertices[k])),
           v.probe_value(-100.0, -100.0)]
    v.on_key(Key("m"))
    cx, cy = m.face_centroids[m.num_faces // 2]
    out.append(v.probe_value(float(cx), float(cy)))
    v.on_click(Click(float(cx), float(-cy)))
    return out + [v.last_probe, v.ax.get_xlabel()]


def scenario_scroll(v):
    x0, x1 = v.ax.get_xlim()
    y0, y1 = v.ax.get_ylim()
    cx, cy = (x0 + x1) / 3, (y0 + y1) / 3
    v.on_scroll(Click(cx, cy, "up"))
    out = [v.ax.get_xlim(), v.ax.get_ylim()]
    v.on_scroll(Click(cx, cy, "down"))
    v.on_scroll(Click(None, None, "up"))
    return out + [v.ax.get_xlim(), v.ax.get_ylim()]


def scenario_scale_boxes(v):
    v._scale_edited(1, "5V")
    out = [v.scale_override, norm(v), v._box_hi.text]
    v._scale_edited(0, "250m")
    out += [v.scale_override, v._box_lo.text]
    v._scale_edited(1, "garbage")
    out += [v.scale_override, v._box_hi.text]
    v._scale_edited(1, "-3")
    v.redraw()
    return out + [v.scale_override, v.ax.get_title()]


def scenario_raster(v):
    v.DECIMATE_FACES = 1
    extent = v._data_extent()
    field, gmask = v._compute_raster(extent)
    v.redraw()
    v._pending_raster[1].result(timeout=60)
    v._poll_raster()
    out = [extent, field, gmask, v._pending_raster,
           len(v._raster_artists), v.ax.get_title()]
    gen0 = v._raster_gen
    x0, x1 = v.ax.get_xlim()
    y0, y1 = v.ax.get_ylim()
    v.on_scroll(Click((x0 + x1) / 2, (y0 + y1) / 2, "up"))
    out.append(v._raster_gen - gen0)
    _, fut, ext2, vmin, vmax = v._pending_raster
    zoomed = fut.result(timeout=60)
    v._poll_raster()
    vx, vy = v.layer_solution.meshes[0].vertices[0]
    return out + [ext2, vmin, vmax, zoomed[0], len(v._raster_artists),
                  v.probe_value(float(vx), float(vy))]


SCENARIOS = {f.__name__.removeprefix("scenario_"): f for f in (
    scenario_initial, scenario_mode_switch, scenario_probe_and_scale,
    scenario_mode_clears_override, scenario_toggles_and_ignored_input,
    scenario_probes, scenario_scroll, scenario_scale_boxes,
    scenario_raster)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_viewer_matches_the_jax_viewer(solutions, name):
    sol, jsol = solutions
    got = SCENARIOS[name](ui.SolutionViewer(sol))
    want = SCENARIOS[name](jui.SolutionViewer(jsol))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert same(a, b), (name, i, a, b)


def test_viewer_initial_render(solutions):
    v = ui.SolutionViewer(solutions[0])
    lo, hi = v.value_range()
    assert v.mode.name == "Potential"
    assert hi - lo == pytest.approx(1.0, abs=1e-6)
    assert v._cbar.mappable.norm.vmax == pytest.approx(hi)


def test_closing_the_figure_stops_the_raster_workers(solutions):
    v = ui.SolutionViewer(solutions[0])
    v.DECIMATE_FACES = 1
    v.redraw()
    v._pending_raster[1].result(timeout=60)
    stopped = []
    timer_stop = v._raster_timer.stop
    v._raster_timer.stop = lambda: (stopped.append(True), timer_stop())
    executor = v._executor
    plt.close(v.fig)
    assert stopped and executor._shutdown
    assert v._pending_raster is None
    with pytest.raises(RuntimeError):
        executor.submit(int)
    # A late request (e.g. a queued scroll) starts nothing.
    gen = v._raster_gen
    v._raster_async(v._data_extent(), 0.0, 1.0)
    assert v._executor is executor and v._raster_gen == gen


def test_headless_main_writes_the_jax_packages_html(solutions, tmp_path,
                                                    monkeypatch, capsys):
    sol, jsol = solutions
    for sub, module, s in (("port", ui, sol), ("jax", jui, jsol)):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert module.main(s) == 0
    assert "No interactive display available" in capsys.readouterr().out
    got = (tmp_path / "port" / "padne_tpu_view.html").read_bytes()
    assert got == (tmp_path / "jax" / "padne_tpu_view.html").read_bytes()
    assert b"webgl" in got
