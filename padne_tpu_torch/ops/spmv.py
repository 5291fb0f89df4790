"""ELL sparse products of the generic solve route: kernel K3 and its plain
version.

Port of padne_tpu.ops.spmv `ell_matvec` (the XLA gather the JAX package
runs on its production path) and of the two Pallas experiments in
padne_tpu.ops.spmv_pallas, which compute the same function.  On CUDA
tensors both wrappers launch K3 (csrc/ell_spmv.cu); on CPU tensors they
run the plain PyTorch version.  There is no fallback between the two.

Device layout: cols (int32) and vals are K-major, shape (K, N) — the
transposed ELL arrays, laid out once at upload by `to_kmajor` (the one
owner of that layout) so the kernel's slot loads are coalesced.  x and
y are (rows, R) in f32 or f64.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def to_kmajor(cols: np.ndarray, vals: np.ndarray, device, dtype):
    """(N, K) host ELL arrays -> (cols, vals) in K3's device layout:
    K-major (K, N), cols int32 and vals in `dtype`."""
    c = torch.from_numpy(np.ascontiguousarray(cols.T, dtype=np.int32))
    v = torch.from_numpy(np.ascontiguousarray(vals.T))
    return c.to(device), v.to(device=device, dtype=dtype)


def ell_spmv_plain(cols, vals, diag, x) -> torch.Tensor:
    """y = diag * x + sum_k vals[k] * x[cols[k]] for x of shape (N, R)."""
    return diag[:, None] * x + ell_rect_spmv_plain(cols, vals, x)


def ell_rect_spmv_plain(cols, vals, x) -> torch.Tensor:
    """y[i] = sum_k vals[k, i] * x[cols[k, i]] (rectangular ELL: x may
    have another row count than y)."""
    return torch.einsum("kn,knr->nr", vals, x[cols])


def _launch(cols, vals, diag, x) -> torch.Tensor:
    """K3 on the card: checks operands, launches, returns y."""
    k, n = cols.shape
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (rows, R), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ell_spmv supports f32 and f64, got {x.dtype}")
    if cols.dtype != torch.int32 or vals.shape != (k, n) or vals.dtype != x.dtype:
        raise ValueError("cols must be int32 (K, N) and vals (K, N) in x's "
                         "dtype")
    tensors = [cols, vals, x]
    if diag is not None:
        if diag.shape != (n,) or diag.dtype != x.dtype or x.shape[0] != n:
            raise ValueError("square form needs diag (N,) and x (N, R) in "
                             "one dtype")
        tensors.append(diag)
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ell_spmv operands must be contiguous and on the "
                             "same device")
    y = torch.empty(n, x.shape[1], dtype=x.dtype, device=x.device)
    rc = kernels.load().pg_ell_spmv(
        int(x.dtype == torch.float64), cols.data_ptr(), vals.data_ptr(),
        diag.data_ptr() if diag is not None else None, x.data_ptr(), n, k,
        x.shape[1], y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(rc, "ell_spmv")
    return y


def ell_spmv(cols, vals, diag, x) -> torch.Tensor:
    """Square ELL SpMV (kernel K3 on CUDA tensors): cols/vals (K, N),
    diag (N,), x (N, R)."""
    if x.device.type == "cpu":
        return ell_spmv_plain(cols, vals, diag, x)
    y = _launch(cols, vals, diag, x.contiguous())
    ell_spmv.launches += 1
    return y


def ell_rect_spmv(cols, vals, x) -> torch.Tensor:
    """Rectangular ELL product (kernel K3 on CUDA tensors): the AMG
    prolongation and restriction, cols/vals (K, N), x (Nx, R).  Every
    column must be < Nx; the kernel does not check it (make_vcycle does,
    once, at upload)."""
    if x.device.type == "cpu":
        return ell_rect_spmv_plain(cols, vals, x)
    y = _launch(cols, vals, None, x.contiguous())
    ell_rect_spmv.launches += 1
    return y


ell_spmv.launches = 0
ell_rect_spmv.launches = 0
