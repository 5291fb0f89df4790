"""Compensated exact operator: f64-accurate residuals from the f32 slab.

Port of padne_tpu.ops.comp's slab mode.  The refinement ladder needs the
true f64 full-system residual after every pass; the resident CG operator
is f32.  The f64 level-0 operator is represented as the resident f32 hi
slab W plus a second f32 slab W_lo holding the exact lo-halves
(A64 = W + W_lo entrywise, ~2^-48 relative representation error), the
f64 diagonal and the f64 remainder.

`matvec_slab` evaluates y = A64 @ x for f32 x as float64 to ~1e-13
relative: the slab part through kernel K2 (csrc/comp_slab.cu, f64
accumulation of exact f32 x f32 products), then the remainder, the
diagonal and the tail in f64 in torch.  The TPU version builds the same
from f32 error-free transforms because the TPU has no f64; Hopper does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from . import dia


@dataclass
class CompOperator:
    """Device-resident compensated exact operator (see module doc)."""

    meta: tuple
    params: dict   # w, w_lo (f32 slabs), diag64, rem_rows/cols, rem_vals64


def _f32_lo(a64) -> np.ndarray:
    """Exact f32 lo-half of an f64 stream: a64 ~= f32(a64) + lo."""
    a64 = np.asarray(a64, np.float64)
    return (a64 - a64.astype(np.float32).astype(np.float64)
            ).astype(np.float32)


def build_slab_mode(meta, op_params, pack: dia.DiaPack) -> CompOperator:
    """Compensated operator sharing the resident f32 hi slab of the CG
    operator (op_params["w"]); the lo-half slab is scattered on the
    device from the host pack, the remainder and diagonal upload in
    f64 (the raw remainder: slot packing does not apply here)."""
    w = op_params["w"]
    if w.dtype != torch.float32:
        raise ValueError("slab comp needs the f32 exact slab")
    dev = w.device
    params = {
        "w": w,
        "w_lo": dia.build_slab(pack, torch.float32, dev,
                               values=_f32_lo(pack.wval)),
        "diag64": torch.from_numpy(np.asarray(pack.diag, np.float64)).to(dev),
        "rem_rows": torch.from_numpy(pack.rem_rows.astype(np.int64)).to(dev),
        "rem_cols": torch.from_numpy(pack.rem_cols.astype(np.int64)).to(dev),
        "rem_vals64": torch.from_numpy(
            np.asarray(pack.rem_vals, np.float64)).to(dev),
    }
    return CompOperator(meta=meta, params=params)


def comp_slab_plain(meta, w, w_lo, x32) -> torch.Tensor:
    """Plain PyTorch version of K2: the main-slab part of A64 @ x as
    float64, from the same two f32 slabs (exact f32 products in f64)."""
    np_, b, g, ng, offs = meta
    nb = np_ // b
    wb = w.reshape(nb, len(offs), b, b)
    wlb = w_lo.reshape(nb, len(offs), b, b)
    xb = x32.reshape(nb, 1, b).double()
    acc = torch.zeros(nb, 1, b, dtype=torch.float64, device=x32.device)
    for di, o in enumerate(offs):
        lo, hi = max(0, -o), min(nb, nb - o)
        if lo < hi:
            xs = xb[lo + o:hi + o]
            acc[lo:hi] += torch.bmm(xs, wb[lo:hi, di].double())
            acc[lo:hi] += torch.bmm(xs, wlb[lo:hi, di].double())
    return acc.reshape(np_)


def comp_slab(meta, w, w_lo, x32) -> torch.Tensor:
    """Kernel K2 on CUDA tensors (csrc/comp_slab.cu); the plain version
    for CPU tensors."""
    if x32.device.type == "cpu":
        return comp_slab_plain(meta, w, w_lo, x32)
    np_, b, g, ng, offs = meta
    if b != 128:
        raise ValueError(f"comp_slab kernel needs b=128, got {b}")
    if x32.dtype != torch.float32 or x32.shape != (np_,):
        raise ValueError(f"x must be f32 ({np_},), got "
                         f"{x32.dtype} {tuple(x32.shape)}")
    for t in (x32, w, w_lo):
        if t.device != x32.device or not t.is_contiguous():
            raise ValueError("comp_slab operands must be contiguous and on "
                             "the same device")
    if (w.dtype != torch.float32 or w_lo.dtype != torch.float32
            or w.numel() != np_ * len(offs) * b or w_lo.shape != w.shape):
        raise ValueError("comp_slab needs two f32 slabs matching meta")
    y = torch.empty(np_, dtype=torch.float64, device=x32.device)
    rc = kernels.load().pg_comp_slab(
        x32.data_ptr(), np_, w.data_ptr(), w_lo.data_ptr(), len(offs),
        kernels.offsets_arg(offs), y.data_ptr(),
        torch.cuda.current_stream(x32.device).cuda_stream)
    kernels.check_launch(rc, "comp_slab")
    comp_slab.launches += 1
    return y


comp_slab.launches = 0


def matvec_slab(op: CompOperator, x32) -> torch.Tensor:
    """y = A64 @ x (float64) for f32 x of shape (np0,), ~1e-13 relative."""
    prm = op.params
    x32 = x32.contiguous()
    x64 = x32.double()
    y = comp_slab(op.meta, prm["w"], prm["w_lo"], x32)
    y.addcmul_(prm["diag64"], x64)
    if prm["rem_rows"].numel():
        y.index_add_(0, prm["rem_rows"],
                     prm["rem_vals64"] * x64[prm["rem_cols"]])
    return y
