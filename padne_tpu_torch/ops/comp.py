"""Compensated exact operator: f64-accurate residuals from f32 values.

Port of padne_tpu.ops.comp's slab mode (`matvec_slab` there).  The
refinement ladder needs the true f64 full-system residual after every
pass; the resident CG operator is f32.  The f64 level-0 operator is
represented as the CG operator's sliced-ELL format (ops.dia.build_sell)
with its f32 hi values, a second f32 value array in the same layout
holding the exact lo-halves (A64 = hi + lo entrywise, ~2^-48 relative
representation error) and the f64 diagonal.

`comp_sell` evaluates y = A64 @ x for f32 x as float64 to ~1e-13
relative in one launch of kernel K2' (csrc/dia_sell.cu): f64
accumulation of exact f32 x f32 products over every off-diagonal entry,
then the f64 diagonal.  The TPU version builds the same from f32
error-free transforms because the TPU has no f64; Hopper does.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import dia

_COMP_KEYS = ("a_lo", "b_lo", "diag64")


def comp_sell_plain(params, x32) -> torch.Tensor:
    """Plain PyTorch version of K2': A64 @ x as float64 from the f32 hi
    and lo values (exact f32 products in f64) and the f64 diagonal, for
    x of the operator's window (nx,); y is (np_,)."""
    (pos_a, col_a), (pos_b, col_b) = dia.sell_entries(params)
    np_, x0 = params["perm"].numel(), params["x0"]
    x64 = x32.double()
    acc = x64.new_zeros(np_)
    acc.index_add_(0, pos_a, params["a_val"].double() * x64[col_a]
                   + params["a_lo"].double() * x64[col_a])
    acc.index_add_(0, pos_b, params["b_val"].double() * x64[col_b]
                   + params["b_lo"].double() * x64[col_b])
    y = torch.empty_like(acc)
    y[params["perm"].long()] = acc
    return y.addcmul_(params["diag64"], x64[x0:x0 + np_])


def _launch(params, x32) -> torch.Tensor:
    """K2' on the card: checks operands, launches, returns y (f64)."""
    if x32.dtype != torch.float32 or x32.dim() != 1:
        raise ValueError(f"x must be an f32 vector, got {x32.dtype} "
                         f"{tuple(x32.shape)}")
    if not x32.is_contiguous():
        raise ValueError("x must be contiguous")
    f32 = (torch.float32,)
    ptrs = dia.sell_args(params, x32, {
        "a_val": f32, "a_lo": f32, "b_val": f32, "b_lo": f32,
        "diag64": (torch.float64,)})
    np_ = params["perm"].numel()
    y = torch.empty(np_, dtype=torch.float64, device=x32.device)
    rc = kernels.load().pg_comp_sell(
        *ptrs, params["a_val"].data_ptr(), params["a_lo"].data_ptr(),
        params["b_val"].data_ptr(), params["b_lo"].data_ptr(),
        params["diag64"].data_ptr(), x32.data_ptr(), np_, params["nx"],
        params["x0"], y.data_ptr(),
        torch.cuda.current_stream(x32.device).cuda_stream)
    kernels.check_launch(rc, "comp_sell")
    return y


def comp_sell(params, x32) -> torch.Tensor:
    """Kernel K2' (csrc/dia_sell.cu) on CUDA tensors; the plain version
    for CPU tensors.  params: the CG operator's sliced-ELL dict built
    with `DiaPack.to_device(..., compensated=True)` (its index arrays and
    f32 hi values, plus the lo-halves and the f64 diagonal), or one
    shard's (ops.dia_sharded); x32 spans its window (nx,)."""
    for key in _COMP_KEYS:
        if key not in params:
            raise ValueError(f"the operator carries no {key}: build it "
                             "with compensated=True")
    if x32.device.type == "cpu":
        return comp_sell_plain(params, x32)
    y = _launch(params, x32)
    kernels.count(comp_sell, params, x32)
    return y


comp_sell.launches = 0
