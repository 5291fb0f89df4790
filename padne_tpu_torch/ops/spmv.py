"""ELL sparse products of the generic solve route: kernel K3' and its
plain version.

Port of padne_tpu.ops.spmv `ell_matvec` (the XLA gather the JAX package
runs on its production path), of the einsums of padne_tpu.ops.amg
`make_vcycle` and of the two Pallas experiments in
padne_tpu.ops.spmv_pallas, which compute the same function:

    square:       s[i] = diag[i] * x[i] + sum_k vals[i, k] * x[cols[i, k]]
    rectangular:  s[i] =                  sum_k vals[i, k] * x[cols[i, k]]

for x of shape (nx, R) and s of shape (n, R), f32 or f64.  Optional
operands fuse the lines of the V-cycle into the product:

    y = x0 + w * (b - s)        each of x0 (n, R), w (n,), b (n, R) optional

so `b` alone gives the residual b - A x, `b, w, x0` the damped-Jacobi
step x0 + w * (b - A x) and `x0` alone the prolongation x0 + P xc.

Device format (`build_operators`, the one owner of the layout, and
`build_operator` for one operator): nonzeros only, in a sliced ELL.
Rows are sorted by length, longest first, inside windows of WINDOW rows;
`lanes` (a power of two up to 32, chosen per operator by
`choose_lanes`) neighbouring lanes of a warp share a row, lane t taking
the row's entries t, t + lanes, ...; a slice is the 32 lanes of
one warp (32 / lanes rows), padded to its longest lane and stored
step-major, so that at every step the warp reads 32 neighbouring column
indices (int32) and values.  The index arrays are shared by the f32 and
f64 values of one operator (`EllOperator.to`) and by the operators of a
batch of one structure (`build_operators`).

On CUDA tensors `ell_spmv` launches K3' (csrc/ell_spmv.cu); on CPU
tensors it runs the plain PyTorch version, which reads the same format.
There is no fallback between the two.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import kernels
from . import dia

SLICE = dia.SLICE        # lanes of a warp: entries per step of a slice
WINDOW = 1024            # rows are sorted by length within such windows
# choose_lanes: entries a lane walks per row, and the warps below which a
# launch leaves most of the card's schedulers without work.
_CHAIN = 4
_MIN_WARPS = 2048


def choose_lanes(mean_len: float, n: int) -> int:
    """Lanes per row for an operator of `n` rows holding `mean_len`
    nonzeros a row on average.  Two rules, both from what bounds the
    product on the card (its operands sit in L2, so dependent loads in
    flight, not bytes): a lane's serial chain of (index, gather) pairs
    stays at about _CHAIN steps, and a small operator spreads over at
    least _MIN_WARPS warps as long as lanes do not outnumber a row's
    entries."""
    lanes = 1
    while lanes < SLICE and (
            mean_len > _CHAIN * lanes
            or (n * lanes < SLICE * _MIN_WARPS and mean_len > lanes)):
        lanes *= 2
    return lanes


def _check_lanes(lanes: int) -> None:
    if lanes < 1 or lanes > SLICE or lanes & (lanes - 1):
        raise ValueError(f"lanes must be a power of two <= {SLICE}")


@dataclasses.dataclass(frozen=True)
class EllOperator:
    """An (n, nx) sparse operator in the sliced-ELL device format."""

    perm: torch.Tensor            # (n,) int32: the row at each sorted position
    ptr: torch.Tensor             # (slices + 1,) int64 entry offsets
    col: torch.Tensor             # (stored,) int32
    val: torch.Tensor             # (stored,) f32 or f64; padding is 0 at col 0
    diag: Optional[torch.Tensor]  # (n,) in val's dtype; None: rectangular
    lanes: int
    nx: int

    def __post_init__(self):
        """The format's invariants, held once here so that a launch only
        has its vectors left to check."""
        _check_lanes(self.lanes)
        if (self.perm.dtype != torch.int32 or self.col.dtype != torch.int32
                or self.ptr.dtype != torch.int64):
            raise ValueError("perm and col must be int32, ptr int64")
        if self.val.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"values must be f32 or f64, got {self.val.dtype}")
        if (self.ptr.numel() != -(-self.n * self.lanes // SLICE) + 1
                or self.val.shape != self.col.shape):
            raise ValueError("slice offsets, columns and values do not "
                             "match the rows and lanes")
        if self.diag is not None and (
                self.nx != self.n or self.diag.shape != (self.n,)
                or self.diag.dtype != self.val.dtype):
            raise ValueError("a diagonal needs a square operator and the "
                             "values' dtype")
        for t in (self.perm, self.ptr, self.col, self.val, self.diag):
            if t is not None and (t.device != self.val.device
                                  or not t.is_contiguous()):
                raise ValueError("the operator's arrays must be contiguous "
                                 "and on one device")

    @property
    def n(self) -> int:
        return self.perm.numel()

    def to(self, dtype) -> "EllOperator":
        """The same operator with values in `dtype`, over the same index
        arrays: self when the dtype already matches, as Tensor.to."""
        if dtype == self.val.dtype:
            return self
        return dataclasses.replace(
            self, val=self.val.to(dtype),
            diag=None if self.diag is None else self.diag.to(dtype))

    @functools.cached_property
    def entry_pos(self) -> torch.Tensor:
        """Sorted row position of every stored entry, padding included
        (positions >= n belong to the last slice's spare lanes)."""
        return dia.entries(self.ptr) // self.lanes


def build_operator(cols: np.ndarray, vals: np.ndarray, diag, nx: int, device,
                   dtype, lanes: Optional[int] = None) -> EllOperator:
    """Host ELL arrays cols/vals (n, K) (padding: value 0) and the
    diagonal (n,) or None -> the operator on `device` with values in
    `dtype`, laid out with torch ops there.  Every column must index a
    row of x (0 <= col < nx): checked here, once, because the kernel
    gathers unchecked.  lanes: lanes per row, default `choose_lanes`."""
    op, _ = build_operators(cols, np.asarray(vals)[None], nx, device, dtype,
                            lanes)
    if diag is None:
        return op
    return dataclasses.replace(op, diag=torch.from_numpy(
        np.asarray(diag, np.float64)).to(device=op.val.device, dtype=dtype))


def build_operators(cols: np.ndarray, vals: np.ndarray, nx: int, device,
                    dtype, lanes: Optional[int] = None):
    """`build_operator` (without a diagonal) for B operators of one
    structure: vals (B, n, K) over the one cols (n, K).  The layout is
    built once, from the entries nonzero in any of the B.  Returns (op,
    val): val (B, stored), row b the values of operator b in the
    layout's slots (0 where its entry is 0), and op the layout holding
    operator 0's values (op.val is val[0]); operator b is
    `dataclasses.replace(op, val=val[b])`, over the same index arrays."""
    n = cols.shape[0]
    if cols.size and (cols.min() < 0 or cols.max() >= nx):
        raise ValueError(f"ELL columns out of range for x of {nx} rows")
    dev = torch.device(device)
    cols_d = torch.from_numpy(np.ascontiguousarray(cols, np.int32)).to(dev)
    vals_d = torch.from_numpy(np.ascontiguousarray(vals, np.float64)).to(dev)
    nz = (vals_d != 0).any(0)
    lengths = nz.sum(1)
    if lanes is None:
        lanes = choose_lanes(float(lengths.double().mean()), n)
    _check_lanes(lanes)
    longest = int(lengths.max()) + 1
    window = torch.arange(n, device=dev) // WINDOW
    perm = torch.argsort(window * longest + (longest - 1 - lengths),
                         stable=True)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(n, device=dev)
    # Lane t of a row of `len` entries holds ceil((len - t) / lanes) of
    # them; spare lanes of the last slice hold none.
    rows_per_slice = SLICE // lanes
    slices = -(-n // rows_per_slice)
    sorted_len = torch.zeros(slices * rows_per_slice, dtype=torch.int64,
                             device=dev)
    sorted_len[:n] = lengths[perm]
    t = torch.arange(lanes, device=dev)
    lane_len = ((sorted_len[:, None] - t + lanes - 1) // lanes).clamp_min(
        0).reshape(-1)
    lane_id = torch.arange(lane_len.numel(), device=dev)
    ptr = dia.slice_ptr(lane_len, lane_id)
    row_e = nz.nonzero(as_tuple=True)[0]
    rank = torch.arange(len(row_e), device=dev) - (
        torch.cumsum(lengths, 0) - lengths)[row_e]
    dest = dia.slots_of(pos[row_e] * lanes + rank % lanes, lane_len,
                         lane_id, ptr)
    col = torch.zeros(int(ptr[-1]), dtype=torch.int32, device=dev)
    col[dest] = cols_d[nz]
    val = torch.zeros(len(vals_d), len(col), dtype=dtype, device=dev)
    for b, v in enumerate(vals_d):
        val[b, dest] = v[nz].to(dtype)
    op = EllOperator(perm=perm.int(), ptr=ptr, col=col, val=val[0],
                     diag=None, lanes=lanes, nx=nx)
    return op, val


def _check(op: EllOperator, x, b, w, x0) -> None:
    """Raise on vectors the product does not take."""
    val = op.val
    if (x.dim() != 2 or x.shape[0] != op.nx or x.shape[1] < 1
            or x.dtype != val.dtype or x.device != val.device):
        raise ValueError(f"x must be ({op.nx}, R) {val.dtype} on "
                         f"{val.device}, got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if w is not None and b is None:
        raise ValueError("w scales b - A x: pass b with it")
    full = (op.n, x.shape[1])
    for name, t, shape in (("b", b, full), ("w", w, full[:1]),
                           ("x0", x0, full)):
        if t is not None and (t.shape != shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {shape} {x.dtype} "
                             f"on {x.device}")


def ell_spmv_plain(op: EllOperator, x, b=None, w=None, x0=None):
    """Plain PyTorch version of K3' over the same device format: a
    gather, a sum per sorted row position, the rows put back in order,
    then the diagonal and the optional epilogue (module doc)."""
    _check(op, x, b, w, x0)
    acc = torch.zeros((op.ptr.numel() - 1) * SLICE // op.lanes, x.shape[1],
                      dtype=x.dtype, device=x.device)
    acc.index_add_(0, op.entry_pos, op.val[:, None] * x[op.col.long()])
    s = torch.empty(op.n, x.shape[1], dtype=x.dtype, device=x.device)
    s[op.perm.long()] = acc[:op.n]
    if op.diag is not None:
        s.addcmul_(op.diag[:, None], x)
    if b is not None:
        s = b - s
    if w is not None:
        s = w[:, None] * s
    return s if x0 is None else x0 + s


def _launch(op: EllOperator, x, b, w, x0) -> torch.Tensor:
    """K3' on the card: checks operands, launches, returns y."""
    _check(op, x, b, w, x0)
    y = torch.empty(op.n, x.shape[1], dtype=x.dtype, device=x.device)

    diag, b, w, x0 = (None if t is None else t.data_ptr()
                      for t in (op.diag, b, w, x0))
    rc = kernels.load().pg_ell_spmv(
        int(x.dtype == torch.float64), op.perm.data_ptr(), op.ptr.data_ptr(),
        op.col.data_ptr(), op.val.data_ptr(), diag, op.lanes, op.n,
        x.data_ptr(), x.shape[1], b, w, x0, y.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check_launch(rc, "ell_spmv")
    return y


def ell_spmv(op: EllOperator, x, b=None, w=None, x0=None) -> torch.Tensor:
    """y = x0 + w * (b - A x) with each of x0, w, b optional (plain A x
    without them): kernel K3' on CUDA tensors, the plain version on CPU
    tensors.  x is (nx, R); b, w and x0 must be contiguous."""
    if x.device.type == "cpu":
        return ell_spmv_plain(op, x, b, w, x0)
    y = _launch(op, x.contiguous(), b, w, x0)
    ell_spmv.launches += 1
    return y


ell_spmv.launches = 0
