"""The port never imports jax (the CUDA machine has none), lxml or
matplotlib (neither is installed there), or any module of the JAX
package padne_tpu (it keeps its own copies of the jax-free host
modules)."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


# Exact names: padne_tpu_torch shares the prefix of padne_tpu.
# A None entry is a module blocked from import, not an imported one.
_FORBIDDEN = (
    "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
    "             and m.split('.')[0] in ('jax', 'jaxlib', 'lxml',\n"
    "                                     'matplotlib', 'padne_tpu'))\n"
    "assert not bad, bad\n"
)


def _port_modules():
    pkg = REPO / "padne_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "padne_tpu_torch.ops.dia" in mods and len(mods) >= 33
    for name in ("cli", "__main__", "io", "io.solution", "io.paraview",
                 "io.htmlview", "spatial", "validate", "sweep", "serve",
                 "colormaps", "raster", "ui"):
        assert f"padne_tpu_torch.{name}" in mods
    assert "padne_tpu_torch.kicad" in mods and "padne_tpu_torch.native" in mods
    for name in ("parallel", "parallel.sharding", "ops.dia_sharded"):
        assert f"padne_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"{_FORBIDDEN}"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_user_path_runs_without_jax(tmp_path):
    """solve, info, paraview, html, a sweep, the sharded solves (the
    CLI's `--tp 4` on the ELL route, a DIA solve over a four-shard mesh),
    the scipy form of the system and the dp x tp standalone solvers in
    one process: nothing on the user path pulls in a forbidden module
    at run time either."""
    code = (
        "import pathlib, sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from tests import boardgen\n"
        "from padne_tpu_torch import cli, kicad, sweep\n"
        f"tmp = pathlib.Path({str(tmp_path)!r})\n"
        "boardgen.gen_strip(tmp)\n"
        "pro = tmp / 'gen_strip' / 'gen_strip.kicad_pro'\n"
        "out = str(tmp / 'o.npz')\n"
        "cli.main(['solve', str(pro), out, '--device', 'cpu'])\n"
        "cli.main(['info', out])\n"
        "cli.main(['paraview', out, str(tmp / 'pv')])\n"
        "cli.main(['html', out, str(tmp / 'v.html')])\n"
        "r = sweep.solve_sweep(kicad.load_kicad_project(pro),\n"
        "                      [sweep.SweepSpec(2.0, 3.3)], device='cpu')\n"
        "assert r[0].residual_norm < 1e-8\n"
        "cli.main(['solve', str(pro), str(tmp / 't.npz'), '--device', 'cpu',\n"
        "          '--tp', '4'])\n"
        "import numpy as np\n"
        "from padne_tpu_torch.ops import assembly, schur\n"
        "from padne_tpu_torch.parallel import sharding\n"
        "g = 96\n"
        "idx = np.arange(g * g).reshape(g, g)\n"
        "e = np.concatenate([np.stack([idx[:-1].ravel(), idx[1:].ravel()], 1),\n"
        "                    np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)])\n"
        "ell = assembly.build_ell(g * g, e, np.ones(len(e)))\n"
        "ij = np.stack(np.meshgrid(np.arange(g), np.arange(g), indexing='ij'), -1)\n"
        "one = lambda *v: np.array(v)\n"
        "border = schur.BorderSpec(1, one(0, 0), one(0, g * g - 1), one(1., -1.),\n"
        "                          one(0, 0), one(0, g * g - 1), one(1., -1.), one(1.))\n"
        "system = schur.CoreSystem(g * g, ell, np.zeros(g * g, np.int64), 1, border,\n"
        "                          np.zeros(g * g), 0, ij.reshape(-1, 2) * 1.0)\n"
        "s = schur.DiaBorderedSolver(system, mesh=sharding.Mesh(['cpu'] * 4),\n"
        "                            shard_min=4096, coarse_size=200)\n"
        "assert s.sharded and s.solve().residual_norm < 1e-9\n"
        "from padne_tpu_torch import solver\n"
        "assert solver.system_to_scipy(system)[0].shape == (g * g + 1,) * 2\n"
        "m8 = sharding.Mesh(['cpu'] * 8, dp=2)\n"
        "b = np.zeros((2, g * g, 1))\n"
        "b[:, 0], b[:, -1] = 1.0, -1.0\n"
        "two = assembly.EllMatrix(ell.cols, np.stack([ell.vals, 2 * ell.vals]),\n"
        "                         np.stack([ell.diag, 2 * ell.diag]))\n"
        "x = sharding.batched_sharded_cg(\n"
        "    m8, *sharding.prepare_sharded_system(two, b, m8), iters=5)\n"
        "x1 = sharding.sharded_cg(\n"
        "    m8, *sharding.prepare_sharded_system(ell, b[0], m8), iters=5)\n"
        "assert x.shape == (2, g * g, 1) and x1.shape == (g * g, 1)\n"
        f"{_FORBIDDEN}"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_viewer_path_runs_without_matplotlib(tmp_path):
    """`gui --device cpu` and `show` where matplotlib cannot be imported,
    as on the GPU machine: both write the HTML viewer, and nothing
    forbidden is imported on the way."""
    code = (
        "import os, pathlib, sys, warnings\n"
        "sys.modules['matplotlib'] = None\n"
        "warnings.simplefilter('ignore')\n"
        "from tests import boardgen\n"
        "from padne_tpu_torch import cli\n"
        f"tmp = pathlib.Path({str(tmp_path)!r})\n"
        "boardgen.gen_strip(tmp)\n"
        "pro = str(tmp / 'gen_strip' / 'gen_strip.kicad_pro')\n"
        "out = str(tmp / 'o.npz')\n"
        "cli.main(['solve', pro, out, '--device', 'cpu'])\n"
        "for sub, argv in (('gui', ['gui', pro, '--device', 'cpu']),\n"
        "                  ('show', ['show', out])):\n"
        "    (tmp / sub).mkdir()\n"
        "    os.chdir(tmp / sub)\n"
        "    try:\n"
        "        cli.main(argv)\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, e.code\n"
        "    assert (tmp / sub / 'padne_tpu_view.html').stat().st_size\n"
        f"{_FORBIDDEN}"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cli_and_io_import_lightly():
    """The parser and the io package come up without torch, scipy or the
    exporters: `--help` and `info` stay quick."""
    code = (
        "import sys\n"
        "import padne_tpu_torch.io, padne_tpu_torch.cli\n"
        "padne_tpu_torch.cli.parse_args(['info', 'x.npz'])\n"
        "heavy = sorted(m for m in sys.modules\n"
        "               if m.split('.')[0] in ('torch', 'scipy')\n"
        "               or m.startswith('padne_tpu_torch.io.'))\n"
        "assert not heavy, heavy\n"
        f"{_FORBIDDEN}"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_without_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['chip_smoke.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        f"{_FORBIDDEN}"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke run fails and prints no result line."""
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
