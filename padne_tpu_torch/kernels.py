"""Build and load the hand-written CUDA kernels (padne_tpu_torch/csrc).

The sources are compiled at first use with nvcc into one shared library
with a plain C interface, bound with ctypes — no PyTorch headers, so the
build takes seconds.  The library lands in padne_tpu_torch/_build/,
keyed by a hash of the sources and flags (stale builds are replaced),
as padne_tpu_torch/native does for its C++ core.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_SRC_DIR = pathlib.Path(__file__).parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).parent / "_build"
_SOURCES = ("dia_sell.cu", "ell_spmv.cu")
_HEADERS = ("device_info.cuh",)
# --threads: the sources compile side by side.
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "--threads", str(len(_SOURCES)))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = pathlib.Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update((_SRC_DIR / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(lib_path: pathlib.Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    for old in _BUILD_DIR.glob("libpadne_cuda_*.so"):
        if old != lib_path:
            old.unlink(missing_ok=True)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp),
           *(str(_SRC_DIR / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, lib_path)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first call (raises if it cannot be)."""
    lib_path = _BUILD_DIR / f"libpadne_cuda_{_source_hash()}.so"
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sell = [vp] * 5          # perm, a_ptr, a_idx, b_ptr, b_col
    lib.pg_dia_sell.restype = i32
    # a_val, a_bf16, b_val, diag, x, np, nx, x0, r, y, stream
    lib.pg_dia_sell.argtypes = sell + [vp, i32, vp, vp, vp, i64, i64, i64,
                                       i32, vp, vp]
    lib.pg_comp_sell.restype = i32
    # a_hi, a_lo, b_hi, b_lo, diag64, x, np, nx, x0, y, stream
    lib.pg_comp_sell.argtypes = sell + [vp, vp, vp, vp, vp, vp, i64, i64, i64,
                                        vp, vp]
    lib.pg_ell_spmv.restype = i32
    # f64, perm, ptr, col, val, diag, lanes, n, x, r, b, w, x0, y, stream
    lib.pg_ell_spmv.argtypes = ([i32] + [vp] * 5 + [i32, i64, vp, i32]
                                + [vp] * 5)
    return lib


def check_launch(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")
