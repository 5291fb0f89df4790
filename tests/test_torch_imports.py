"""The port never imports jax (the CUDA machine has none), lxml, or any
module of the JAX package padne_tpu (it keeps its own copies of the
jax-free host modules)."""

import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent


# Exact names: padne_tpu_torch shares the prefix of padne_tpu.
_FORBIDDEN = (
    "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'lxml')\n"
    "             or m == 'padne_tpu' or m.startswith('padne_tpu.'))\n"
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
    assert "padne_tpu_torch.ops.dia" in mods and len(mods) >= 24
    assert "padne_tpu_torch.kicad" in mods and "padne_tpu_torch.native" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
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
