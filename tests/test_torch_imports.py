"""The port never imports jax (the CUDA machine has none) nor lxml."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


def _port_modules():
    pkg = REPO / "padne_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in pkg.rglob("*.py"))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "padne_tpu_torch.ops.dia" in mods and len(mods) >= 14
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in ('jax', 'jaxlib', 'lxml') if m in sys.modules)\n"
        "assert not bad, bad\n"
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
        "assert 'jax' not in sys.modules\n"
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
