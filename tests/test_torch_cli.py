"""Port parity for padne_tpu_torch.cli: the subcommands a user runs, on
two generated boards, with `--device cpu` as the tests must ask for it.

Gates: the saved per-layer potentials lie within 1e-6 V of what
`padne_tpu.cli solve` saves for the same project, and the port's
artifact loads through padne_tpu.io.solution; `info`, `paraview` and
`html` work on it; `gui` and `show` write the HTML viewer without a
display; `--tp 4 --device cpu` solves sharded as `padne_tpu.cli solve
--tp 4` does; `--tp` beyond the cards, a missing project and a missing
card end in exit code 1 through handle_errors."""

import pathlib
import subprocess
import sys
import warnings
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from padne_tpu import cli as jcli
from padne_tpu.io import solution as jsolution_io
from padne_tpu_torch import cli, device
from padne_tpu_torch.io import solution as solution_io

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BOARDS = ("gen_two_layer_via", "gen_regulator")


@pytest.fixture(scope="module", params=BOARDS)
def solved(request, boards_dir, tmp_path_factory):
    """(project, the port's artifact) after `solve --device cpu`."""
    pro = boards_dir / request.param / f"{request.param}.kicad_pro"
    out = tmp_path_factory.mktemp(request.param) / "out.npz"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(["solve", str(pro), str(out), "--device", "cpu"])
    assert out.exists()
    return pro, out


def test_solve_matches_the_jax_cli(solved, tmp_path):
    pro, out = solved
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcli.main(["solve", str(pro), str(tmp_path / "jax.npz")])
    want = jsolution_io.load_solution(tmp_path / "jax.npz")
    # The port's artifact through the JAX package's loader.
    got = jsolution_io.load_solution(out)
    assert got.solver_info.residual_norm < 1e-9
    assert got.solver_info.system_size == want.solver_info.system_size
    assert len(got.layer_solutions) == len(want.layer_solutions)
    for lg, lw in zip(got.layer_solutions, want.layer_solutions):
        assert len(lg.potentials) == len(lw.potentials)
        for pg, pw in zip(lg.potentials, lw.potentials):
            assert np.array_equal(pg.mesh.vertices, pw.mesh.vertices)
            assert np.abs(pg.values - pw.values).max() <= 1e-6


def test_info(solved, capsys):
    _, out = solved
    cli.main(["info", str(out)])
    text = capsys.readouterr().out
    sol = solution_io.load_solution(out)
    assert f"project: {sol.problem.project_name}" in text
    assert f"system size: {sol.solver_info.system_size}" in text
    assert "residual" in text
    for layer in sol.problem.layers:
        assert f"  {layer.name}: " in text
    # Line for line what the JAX package's `info` prints.
    jcli.main(["info", str(out)])
    assert capsys.readouterr().out == text


def test_paraview_and_html(solved, tmp_path):
    _, out = solved
    cli.main(["paraview", str(out), str(tmp_path / "pv")])
    files = sorted((tmp_path / "pv").glob("*.vtu"))
    sol = solution_io.load_solution(out)
    assert len(files) == sum(bool(ls.meshes) for ls in sol.layer_solutions)
    for f in files:
        root = ET.parse(f).getroot()
        assert root.tag == "VTKFile" and root.findall(".//Piece")
    cli.main(["html", str(out), str(tmp_path / "v.html")])
    text = (tmp_path / "v.html").read_text()
    assert "webgl" in text and sol.problem.project_name in text


def test_mesher_flags_reach_the_solve(boards_dir, tmp_path):
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    sizes = []
    for mesh_size in ("0.6", "0.3"):
        out = tmp_path / f"s{mesh_size}.npz"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            cli.main(["solve", str(pro), str(out), "--device", "cpu",
                      "--mesh-size", mesh_size, "--mesh-angle", "25"])
        sizes.append(solution_io.load_solution(out).solver_info.system_size)
    assert sizes[1] > sizes[0]
    args = cli.parse_args(["solve", "a.kicad_pro", "b.npz", "--mesh-size",
                           "0.3", "--mesh-angle", "25"])
    cfg = cli.mesher_config_from_args(args)
    assert cfg.maximum_size == 0.3 and cfg.minimum_angle == 25
    assert args.device is None and args.tp == 1


def test_tp_solve_matches_the_jax_cli(boards_dir, tmp_path, monkeypatch):
    """`solve --device cpu --tp 4` shards the solve over four CPU shards
    and saves what `padne_tpu.cli solve --tp 4` saves, within 1e-6 V."""
    from padne_tpu_torch.ops import schur

    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    seen = []
    real = schur.solve_bordered

    def recording(system, **kw):
        stats = kw.setdefault("stats", {})
        sol = real(system, **kw)
        seen.append(stats)
        return sol

    monkeypatch.setattr(schur, "solve_bordered", recording)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(["solve", str(pro), str(tmp_path / "tp4.npz"), "--device",
                  "cpu", "--tp", "4"])
        jcli.main(["solve", str(pro), str(tmp_path / "jax.npz"), "--tp",
                   "4"])
    assert [(st["tp"], st["sharded"]) for st in seen] == [(4, True)]
    got = solution_io.load_solution(tmp_path / "tp4.npz")
    want = jsolution_io.load_solution(tmp_path / "jax.npz")
    assert got.solver_info.residual_norm < 1e-9
    for lg, lw in zip(got.layer_solutions, want.layer_solutions, strict=True):
        for pg, pw in zip(lg.potentials, lw.potentials, strict=True):
            assert np.abs(pg.values - pw.values).max() <= 1e-6


def test_tp_above_the_card_count_raises(boards_dir, tmp_path, capsys):
    """Without --device, --tp N takes cuda:0 .. cuda:N-1 and ends in the
    JAX package's error when fewer cards exist."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    tp = str(max(2, avail + 1))
    with pytest.raises(SystemExit) as e:
        cli.main(["solve", str(pro), str(tmp_path / "o.npz"), "--tp", tp])
    assert e.value.code == 1
    assert (f"--tp {tp} exceeds the {avail} available device(s)"
            in capsys.readouterr().out)
    assert not (tmp_path / "o.npz").exists()
    assert cli.device_mesh_from_args(cli.parse_args(
        ["solve", "a.kicad_pro", "b.npz", "--tp", "1"])) is None
    mesh = cli.device_mesh_from_args(cli.parse_args(
        ["solve", "a.kicad_pro", "b.npz", "--device", "cpu", "--tp", "3"]))
    assert mesh.size == 3 and {d.type for d in mesh.devices} == {"cpu"}


def test_default_device_is_the_card(boards_dir, tmp_path, capsys):
    """Without --device the solve wants the CUDA card: with none it
    exits 1 with the device error, and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert device.resolve(None).type == "cuda"
        return
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    with pytest.raises(SystemExit) as e:
        cli.main(["solve", str(pro), str(tmp_path / "o.npz")])
    assert e.value.code == 1
    assert "needs a CUDA device" in capsys.readouterr().out
    assert not (tmp_path / "o.npz").exists()


def test_bad_input_exits_nonzero(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["solve", str(tmp_path / "missing.kicad_pro"),
                  str(tmp_path / "o.npz"), "--device", "cpu"])
    assert e.value.code == 1


def test_gui_show_and_serve_parse_the_jax_packages_flags():
    """gui, show and serve take the JAX package's arguments; gui and
    serve also --device, as solve does."""
    flags = ["--mesh-size", "0.3", "--mesh-angle", "25", "--tp", "1"]
    for argv in (["gui", "b.kicad_pro", *flags],
                 ["show", "s.npz"],
                 ["serve", "--socket", "/tmp/x.sock", "--max-requests", "3"]):
        want = jcli.parse_args(argv)
        got = cli.parse_args(argv)
        assert {k: v for k, v in vars(got).items() if k != "device"} \
            == vars(want)
    args = cli.parse_args(["gui", "b.kicad_pro", "--device", "cpu"])
    assert args.device == "cpu" and args.tp == 1
    assert cli.parse_args(["serve", "--device", "cpu"]).device == "cpu"
    assert cli.parse_args(["serve"]).socket is None
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["show", "s.npz", "--device", "cpu"])
    assert e.value.code == 2


def test_gui_and_show_write_the_html_viewer(boards_dir, tmp_path,
                                            monkeypatch, capsys):
    """Without a display `gui` solves and `show` loads, and both write
    padne_tpu_view.html where they run."""
    import matplotlib

    matplotlib.use("Agg")
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    (tmp_path / "gui").mkdir()
    monkeypatch.chdir(tmp_path / "gui")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(SystemExit) as e:
            cli.main(["gui", str(pro), "--device", "cpu"])
    assert e.value.code == 0
    page = (tmp_path / "gui" / "padne_tpu_view.html").read_text()
    assert "webgl" in page and "gen_strip" in page
    out = tmp_path / "strip.npz"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cli.main(["solve", str(pro), str(out), "--device", "cpu"])
    (tmp_path / "show").mkdir()
    monkeypatch.chdir(tmp_path / "show")
    with pytest.raises(SystemExit) as e:
        cli.main(["show", str(out)])
    assert e.value.code == 0
    # The artifact keeps no connection points, so `show` writes the page
    # `html` writes for it, not gui's.
    cli.main(["html", str(out), str(tmp_path / "html.html")])
    assert (tmp_path / "show" / "padne_tpu_view.html").read_bytes() \
        == (tmp_path / "html.html").read_bytes()
    assert "No interactive display available" in capsys.readouterr().out


def test_python_dash_m(boards_dir, tmp_path):
    """`python -m padne_tpu_torch` is the CLI."""
    pro = boards_dir / "gen_strip" / "gen_strip.kicad_pro"
    out = tmp_path / "m.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "padne_tpu_torch", "solve", str(pro),
         str(out), "--device", "cpu"],
        cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert solution_io.load_solution(out).solver_info.residual_norm < 1e-9
    proc = subprocess.run(
        [sys.executable, "-m", "padne_tpu_torch", "--version"],
        cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("padne-torch ")


def test_collect_warnings_records_and_shows():
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        with cli.collect_warnings() as warns:
            warnings.warn("ground current", UserWarning)
    assert len(warns) == 1 and "ground current" in str(warns[0].message)
