"""Block-offset-diagonal (DIA) operators: host packing + sliced-ELL SpMV.

Port of padne_tpu.ops.dia.  Host side: rows/columns are blocked at B=128
after a locality ordering (ops.bell.hilbert_order) and the nonzeros on a
few block offsets d = col_block - row_block are split from a row-sorted
COO remainder (choose_offsets, DiaPack, pack_dia and the pack_*_as_dia
helpers, carried as numpy; their arrays equal the JAX package's on the
same input).

Device side: the TPU streams the offset nonzeros as dense (B, B) weight
slabs because its matrix unit wants dense tiles and Mosaic cannot
gather; on the GPU nearly every slab entry would be a zero.  Here every
operator is stored as its nonzeros only, in a sliced ELL (SELL-C-sigma)
format built by `build_sell`:

* rows are sorted by length within each 128-row block and cut into
  slices of 32 rows (one warp); a slice is as wide as its longest row,
  entries stored K-major (slot k of the 32 rows is contiguous);
* part A: an entry whose column lies within int16 reach of the first row
  of its 128-row block stores that distance as an int16 and a value of
  the operator's dtype (f32, or bf16 for the cycle); the Hilbert order
  keeps nearly every entry there;
* part B of the same slices: int32 columns and f32 values, for the
  entries farther away and, in a bf16 operator, those the JAX package
  keeps in f32 (slots and remainder);
* the diagonal is a dense (np,) vector.

Columns index a window of x: `nx` columns, row i's own at `x0 + i`.  An
operator of its own has nx = np and x0 = 0; one shard of a row-sharded
operator (ops.dia_sharded) reads its rows with a halo of its neighbours'
on each side (x0 = the halo) and the gathered far exchange after them,
and part A's distance then counts from the block's first row in that
window.

`sell_matvec` is kernel K1' (csrc/dia_sell.cu) over that format, with
its plain PyTorch version `sell_matvec_plain`; `dia_matvec_t` is one
launch of it, in the transposed (R, np) layout the DIA route uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import kernels, spans

DEFAULT_B = 128   # row/column block size
DEFAULT_G = 8     # row-blocks per group (the JAX grid step)
SLICE = 32        # rows per slice of the sliced-ELL format: one warp
ROW_BLOCK = 128   # rows sorted by length within; part A's column base


def choose_offsets(rows: np.ndarray, cols: np.ndarray, b: int = DEFAULT_B,
                   coverage: float = 0.95,
                   max_offsets: int = 8) -> tuple[int, ...]:
    """Pick the block offsets to densify: greedily by nnz count until
    `coverage` of the nonzeros are covered (or max_offsets reached).
    Offset 0 (the block diagonal) is always included."""
    if len(rows) == 0:
        return (0,)
    return _offsets_from_bd(cols // b - rows // b, coverage, max_offsets)


def _offsets_from_bd(bd: np.ndarray, coverage: float,
                     max_offsets: int) -> tuple[int, ...]:
    """Offset selection from precomputed block deltas (col_b - row_b)."""
    bdmin = int(bd.min())
    cnts = np.bincount(bd - bdmin)
    u = np.nonzero(cnts)[0]
    c = cnts[u]
    u = u + bdmin
    order = np.argsort(-c)
    total = len(bd)
    picked = []
    covered = 0
    for i in order:
        if len(picked) >= max_offsets:
            break
        picked.append(int(u[i]))
        covered += int(c[i])
        if covered >= coverage * total:
            break
    if 0 not in picked:
        picked.append(0)
    return tuple(sorted(picked))


@dataclass
class DiaPack:
    """Host-side packing of a square operator in block-offset form.

    All arrays are nnz-sized or O(n); `to_device` turns them into the
    sliced-ELL device format (`build_sell`)."""

    n: int                 # logical rows (before padding)
    np_: int               # padded rows = ng * G * B
    b: int
    g: int
    ng: int
    offs: tuple[int, ...]
    # Split index of an offset entry: widx_hi * b + widx_lo would be its
    # position in the JAX package's dense slab (kept split: the flat
    # index exceeds int32 at 1M-row packs).
    widx_hi: np.ndarray    # (nnz_main,) int32: (rb * d + slot) * b + col_local
    widx_lo: np.ndarray    # (nnz_main,) uint8/16: row_local
    wval: np.ndarray       # (nnz_main,) float
    rem_rows: np.ndarray   # (nnz_rem,) int32, sorted
    rem_cols: np.ndarray   # (nnz_rem,) int32
    rem_vals: np.ndarray   # (nnz_rem,) float
    diag: np.ndarray       # (np_,) float64, zero on padding rows

    @property
    def meta(self) -> tuple:
        """Static description consumed by the matvec."""
        return (self.np_, self.b, self.g, self.ng, self.offs)

    def coo(self, device):
        """(rows, cols, vals, n_main) on `device`: the off-diagonal
        entries as int64 rows/cols and f64 values, the n_main offset
        entries (decoded from the split index, as the JAX package's
        coo_from_widx does) first, then the remainder."""
        b, d = self.b, len(self.offs)
        with spans.span("setup.upload"):
            hi, lo, rem_rows, rem_cols = (
                torch.from_numpy(a.astype(np.int64)).to(device)
                for a in (self.widx_hi, self.widx_lo, self.rem_rows,
                          self.rem_cols))
            vals = torch.from_numpy(np.concatenate([
                np.asarray(self.wval, np.float64),
                np.asarray(self.rem_vals, np.float64)])).to(device)
        blk, col_local = hi // b, hi % b
        rb = blk // d
        offs = torch.tensor(self.offs, dtype=torch.int64, device=device)
        rows = torch.cat([rb * b + lo, rem_rows])
        cols = torch.cat([(rb + offs[blk % d]) * b + col_local, rem_cols])
        return rows, cols, vals, len(self.widx_hi)

    def to_device(self, device, dtype=torch.float32,
                  compensated: bool = False) -> dict:
        """The operator in the sliced-ELL device format (`build_sell`):
        offset entries in `dtype`, remainder entries and the diagonal in
        f32 (as the JAX package keeps them next to a bf16 slab);
        compensated adds the lo-halves and f64 diagonal of ops.comp."""
        rows, cols, vals, n_main = self.coo(device)
        keep_f32 = torch.arange(len(rows), device=device) >= n_main
        return build_sell(self.np_, rows, cols, vals, self.diag, device,
                          dtype=dtype, keep_f32=keep_f32,
                          compensated=compensated)


def pack_dia(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    diag: Optional[np.ndarray] = None,
    offs: Optional[tuple] = None,
    b: int = DEFAULT_B,
    g: Optional[int] = None,
    coverage: float = 0.95,
    max_offsets: int = 8,
    np_override: Optional[int] = None,
) -> DiaPack:
    """Pack COO triplets (off-diagonal, duplicate-free) + diagonal.

    The caller permutes indices into a locality-preserving order first
    (bell.hilbert_order); offset coverage depends on it.

    np_override: force the padded length (a multiple of b, >= n); `g` is
    then the largest of (8, 4, 2, 1) dividing np_override / b."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    nat = None
    if len(rows) >= 200_000:
        # Native single-pass packer (offset histogram + split W index +
        # row-sorted remainder), shared with the JAX package.
        from .. import native

        nat = native.pack_dia(b, rows, cols, vals, coverage, max_offsets,
                              offs=offs)
        offs = nat[0]
        rb = cb = bd0 = None
    elif offs is None and len(rows):
        rb, cb = rows // b, cols // b
        bd0 = cb - rb
        offs = _offsets_from_bd(bd0, coverage, max_offsets)
    elif offs is None:
        offs = (0,)
        rb = cb = bd0 = None
    else:
        rb = cb = bd0 = None
    # Slot assignment below requires sorted offsets.
    offs = tuple(sorted(offs))
    d = len(offs)
    if np_override is not None:
        if np_override % b or np_override < n:
            raise ValueError("np_override must be a multiple of b and >= n")
        nb = np_override // b
        if g is None:
            g = next(gg for gg in (8, 4, 2, 1) if nb % gg == 0)
        elif nb % g:
            raise ValueError("np_override not divisible by g*b")
        ng = nb // g
        np_ = np_override
    else:
        g = g or DEFAULT_G
        nb = max((n + b - 1) // b, 1)
        ng = (nb + g - 1) // g
        np_ = ng * g * b

    diag_pad = np.zeros(np_, dtype=np.float64)
    if diag is not None:
        diag_pad[:n] = diag

    lo_t = np.uint8 if b <= 256 else np.uint16
    if nat is not None:
        _, hi, lo16, wv, rr, rcc, rv = nat
        return DiaPack(
            n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
            widx_hi=hi, widx_lo=lo16 if lo_t == np.uint16
            else lo16.astype(np.uint8),
            wval=wv, rem_rows=rr, rem_cols=rcc, rem_vals=rv,
            diag=diag_pad,
        )
    if len(rows) == 0:
        return DiaPack(
            n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
            widx_hi=np.zeros(0, np.int32), widx_lo=np.zeros(0, lo_t),
            wval=np.zeros(0),
            rem_rows=np.zeros(0, np.int32), rem_cols=np.zeros(0, np.int32),
            rem_vals=np.zeros(0), diag=diag_pad,
        )

    # Membership and slot assignment from one signed-slot table over the
    # offset span; the widx composition reuses gathered arrays as
    # scratch (allocation-lean: page faults dominate at millions of nnz).
    if rb is None:
        rb, cb = rows // b, cols // b
        bd0 = cb - rb
    bd = bd0
    off_arr = np.asarray(offs)
    dmin, dspan = int(off_arr[0]), int(off_arr[-1] - off_arr[0])
    lut_slot = np.full(dspan + 1, -1, dtype=np.int64)
    lut_slot[off_arr - dmin] = np.arange(d)
    np.subtract(bd, dmin, out=bd)
    # Unsigned trick: negatives wrap to huge values, so one comparison
    # covers both range ends.
    valid = bd.view(np.uint64) <= np.uint64(dspan)
    np.multiply(bd, valid, out=bd)          # clamp invalid to index 0
    slots = lut_slot[bd]
    sel = valid
    np.bitwise_and(sel, slots >= 0, out=sel)

    ds = slots[sel]
    r_s, c_s = rows[sel], cols[sel]
    rb_s, cb_s = rb[sel], cb[sel]
    # W[gi, gg, ds, col_local, row_local] with gi*g + gg == row_block:
    # widx_hi = (rb*d + ds)*b + c_loc, widx_lo = row_local.
    np.multiply(cb_s, b, out=cb_s)
    np.subtract(c_s, cb_s, out=cb_s)        # cb_s = col_local; c_s free
    np.multiply(rb_s, b, out=c_s)
    np.subtract(r_s, c_s, out=r_s)          # r_s = row_local
    np.multiply(rb_s, d, out=rb_s)
    np.add(rb_s, ds, out=rb_s)
    np.multiply(rb_s, b, out=rb_s)
    np.add(rb_s, cb_s, out=rb_s)            # rb_s = widx_hi

    np.logical_not(sel, out=sel)
    rr, rc, rv = rows[sel], cols[sel], vals[sel]
    order = np.argsort(rr, kind="stable")
    np.logical_not(sel, out=sel)
    return DiaPack(
        n=n, np_=np_, b=b, g=g, ng=ng, offs=offs,
        widx_hi=rb_s.astype(np.int32), widx_lo=r_s.astype(lo_t),
        wval=vals[sel],
        rem_rows=rr[order].astype(np.int32),
        rem_cols=rc[order].astype(np.int32),
        rem_vals=rv[order], diag=diag_pad,
    )


def pack_ell_as_dia(ell, perm: Optional[np.ndarray] = None, **kw) -> DiaPack:
    """assembly.EllMatrix (optionally permuted by `perm`: new->old)
    -> DiaPack."""
    n, k = ell.cols.shape
    nz = ell.vals != 0
    rows = np.repeat(np.arange(n, dtype=np.int64), k)[nz.ravel()]
    cols = ell.cols.astype(np.int64).ravel()[nz.ravel()]
    vals = ell.vals.ravel()[nz.ravel()]
    diag = ell.diag
    if perm is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        rows, cols = inv[rows], inv[cols]
        diag = diag[perm]
    return pack_dia(n, rows, cols, vals, diag=diag, **kw)


def pack_csr_as_dia(a, **kw) -> DiaPack:
    """Square scipy CSR/COO (diagonal included in the matrix) -> DiaPack."""
    coo = a.tocoo()
    diag = np.asarray(a.diagonal(), dtype=np.float64)
    mask = coo.row != coo.col
    return pack_dia(
        a.shape[0], coo.row[mask].astype(np.int64),
        coo.col[mask].astype(np.int64), coo.data[mask], diag=diag, **kw,
    )


def pack_csr_pos_as_dia(a, pos, diag, np_override, b: int = DEFAULT_B,
                        coverage: float = 0.95,
                        max_offsets: int = 8) -> DiaPack:
    """Scipy CSR + padded-position map -> DiaPack (the AMG per-level
    shape: entry (i, j) lands at (pos[i], pos[j]); the diagonal is
    skipped and supplied pre-padded as `diag`)."""
    a = a.tocsr()
    if a.nnz >= 200_000:
        from .. import native

        nat = native.pack_dia_csr(a, pos, b, coverage, max_offsets)
        offs, hi, lo16, wv, rr, rcc, rv = nat
        nb = np_override // b
        g = next(gg for gg in (8, 4, 2, 1) if nb % gg == 0)
        ng = nb // g
        lo_t = np.uint8 if b <= 256 else np.uint16
        return DiaPack(
            n=np_override, np_=np_override, b=b, g=g, ng=ng, offs=offs,
            widx_hi=hi, widx_lo=lo16 if lo_t == np.uint16
            else lo16.astype(np.uint8),
            wval=wv, rem_rows=rr, rem_cols=rcc, rem_vals=rv, diag=diag,
        )
    coo = a.tocoo()
    mask = coo.row != coo.col
    pos = np.asarray(pos, dtype=np.int64)
    return pack_dia(
        np_override, pos[coo.row[mask]], pos[coo.col[mask]],
        coo.data[mask], diag=diag, b=b, coverage=coverage,
        max_offsets=max_offsets, np_override=np_override,
    )




# ---------------------------------------------------------------------------
# Device side: the sliced-ELL format and kernel K1'


def slice_ptr(lengths, perm) -> torch.Tensor:
    """(nslices + 1,) int64 entry offsets of the slices: a slice holds
    SLICE * (its longest row) entries."""
    width = lengths[perm].view(-1, SLICE).amax(1)
    ptr = torch.zeros(width.numel() + 1, dtype=torch.int64,
                      device=lengths.device)
    ptr[1:] = torch.cumsum(width * SLICE, 0)
    return ptr


def slots_of(rows, lengths, pos, ptr) -> torch.Tensor:
    """Storage index of each entry: entry k of the row at slice-lane
    position p sits at ptr[p // SLICE] + k * SLICE + p % SLICE."""
    order = torch.argsort(rows, stable=True)
    rs = rows[order]
    start = torch.cumsum(lengths, 0) - lengths
    k = torch.arange(len(rs), device=rows.device) - start[rs]
    p = pos[rs]
    dest = torch.empty_like(order)
    dest[order] = ptr[p // SLICE] + k * SLICE + p % SLICE
    return dest


def _lo_half(v64) -> torch.Tensor:
    """Exact f32 lo-half of f64 values: v64 ~= f32(v64) + lo (~2^-48)."""
    return (v64 - v64.float().double()).float()


def build_sell(np_, rows, cols, vals, diag, device, dtype=torch.float32,
               keep_f32=None, compensated: bool = False,
               nx: Optional[int] = None, x0: int = 0) -> dict:
    """An (np_, nx) operator, diagonal + off-diagonal COO (rows, cols,
    vals), in the sliced-ELL device format (module doc), built on
    `device` with torch ops.  cols index the window of x (module doc):
    nx columns (default np_), row i's own at x0 + i.

    keep_f32: bool mask of entries whose values stay f32 when `dtype` is
    narrower (they take the int32-column part).  compensated (f32 only):
    also the exact f32 lo-halves of every value in the same layout and
    the f64 diagonal, for ops.comp.

    Keys: perm (np_,) int32, the row at each slice-lane position;
    a_ptr/b_ptr (np_/32 + 1,) int64 slice offsets of part A and part B;
    a_idx int16 (column less the row block's first row), a_val (dtype);
    b_col int32, b_val f32; diag f32; with compensated a_lo, b_lo f32 and
    diag64 f64; nx and x0 as ints.  Padding entries carry value 0 and
    index 0 (a column the slice's rows read anyway)."""
    nx = np_ if nx is None else nx
    if np_ % ROW_BLOCK:
        raise ValueError(f"np_ must be a multiple of {ROW_BLOCK}, got {np_}")
    if x0 < 0 or x0 + np_ > nx:
        raise ValueError(f"rows {x0}..{x0 + np_} lie outside the window "
                         f"of {nx} columns")
    if compensated and dtype != torch.float32:
        raise ValueError("the compensated operator shares f32 values")
    dev = torch.device(device)
    rows = torch.as_tensor(rows, device=dev).long()
    cols = torch.as_tensor(cols, device=dev).long()
    v64 = torch.as_tensor(vals, dtype=torch.float64, device=dev)
    if len(cols) and (int(cols.min()) < 0 or int(cols.max()) >= nx):
        raise ValueError(f"columns out of range for a window of {nx}")
    delta = cols - (x0 + rows // ROW_BLOCK * ROW_BLOCK)
    in_a = (delta >= -2**15) & (delta < 2**15)
    if keep_f32 is not None and dtype != torch.float32:
        in_a &= ~torch.as_tensor(keep_f32, device=dev)

    # Rows sorted by length within each row block, longest first
    # (SELL-C-sigma, C = 32, sigma = 128), then cut into slices.  Part
    # B's length sorts first: its 8-byte entries are sparse per row (far
    # entries, a bf16 operator's remainder), and this order pads them
    # least for a small cost in part A.
    rows_a, rows_b = rows[in_a], rows[~in_a]
    len_a = torch.bincount(rows_a, minlength=np_)
    len_b = torch.bincount(rows_b, minlength=np_)
    ma, mb = int(len_a.max()) + 1, int(len_b.max()) + 1
    blk = torch.arange(np_, device=dev) // ROW_BLOCK
    perm = torch.argsort((blk * mb + (mb - 1 - len_b)) * ma
                         + (ma - 1 - len_a), stable=True)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(np_, device=dev)
    a_ptr, b_ptr = slice_ptr(len_a, perm), slice_ptr(len_b, perm)
    dest_a = slots_of(rows_a, len_a, pos, a_ptr)
    dest_b = slots_of(rows_b, len_b, pos, b_ptr)

    a_idx = torch.zeros(int(a_ptr[-1]), dtype=torch.int16, device=dev)
    a_idx[dest_a] = delta[in_a].to(torch.int16)
    a_val = torch.zeros(len(a_idx), dtype=dtype, device=dev)
    a_val[dest_a] = v64[in_a].float().to(dtype)
    b_col = torch.zeros(int(b_ptr[-1]), dtype=torch.int32, device=dev)
    b_col[dest_b] = cols[~in_a].int()
    b_val = torch.zeros(len(b_col), dtype=torch.float32, device=dev)
    b_val[dest_b] = v64[~in_a].float()
    diag64 = torch.as_tensor(np.asarray(diag, np.float64), device=dev)
    params = {"perm": perm.int(), "a_ptr": a_ptr, "a_idx": a_idx,
              "a_val": a_val, "b_ptr": b_ptr, "b_col": b_col, "b_val": b_val,
              "diag": diag64.float(), "nx": nx, "x0": x0}
    if compensated:
        params["a_lo"] = torch.zeros_like(a_val)
        params["a_lo"][dest_a] = _lo_half(v64[in_a])
        params["b_lo"] = torch.zeros_like(b_val)
        params["b_lo"][dest_b] = _lo_half(v64[~in_a])
        params["diag64"] = diag64
    return params


def entries(ptr) -> torch.Tensor:
    """Slice-lane position of every stored entry of one part."""
    width = ptr[1:] - ptr[:-1]
    s = torch.repeat_interleave(
        torch.arange(len(width), device=ptr.device), width)
    e = torch.arange(len(s), device=ptr.device)
    return s * SLICE + (e - ptr[s]) % SLICE


def sell_entries(params) -> tuple:
    """((pos_a, col_a), (pos_b, col_b)): slice-lane position and window
    column of every stored entry of part A and part B,
    padding included (row = perm[pos])."""
    pos_a = entries(params["a_ptr"])
    col_a = (params["x0"] + pos_a // ROW_BLOCK * ROW_BLOCK
             + params["a_idx"].long())
    return ((pos_a, col_a),
            (entries(params["b_ptr"]), params["b_col"].long()))


def sell_matvec_plain(params, xt) -> torch.Tensor:
    """Plain PyTorch version of K1': y^T = A x^T for f32 xt (R, nx), a
    gather and a sum over each slice's width in f32 (bf16 values widened),
    then the diagonal.  y^T is (R, np_)."""
    (pos_a, col_a), (pos_b, col_b) = sell_entries(params)
    np_, x0 = params["perm"].numel(), params["x0"]
    acc = xt.new_zeros(xt.shape[0], np_)
    acc.index_add_(1, pos_a, params["a_val"].float() * xt[:, col_a])
    acc.index_add_(1, pos_b, params["b_val"] * xt[:, col_b])
    y = torch.empty_like(acc)
    y[:, params["perm"].long()] = acc
    return y.addcmul_(params["diag"], xt[:, x0:x0 + np_])


_SELL_INDEX = {"perm": torch.int32, "a_ptr": torch.int64,
               "a_idx": torch.int16, "b_ptr": torch.int64,
               "b_col": torch.int32}


def sell_args(params, x, values: dict) -> list:
    """The format's index pointers for a kernel entry point, after
    checking device, type, contiguity and sizes of those arrays, of the
    value arrays `values` names ({key: allowed dtypes}) and of x against
    the window (nx, x0); shared by K1' and K2'."""
    np_, nx, x0 = params["perm"].numel(), params["nx"], params["x0"]
    if np_ % ROW_BLOCK or x.shape[-1] != nx:
        raise ValueError(f"x has {x.shape[-1]} columns, the operator's "
                         f"window {nx} ({np_} rows, a multiple of "
                         f"{ROW_BLOCK})")
    if x0 < 0 or x0 + np_ > nx:
        raise ValueError(f"rows {x0}..{x0 + np_} lie outside the window")
    for key, dts in {**{k: (dt,) for k, dt in _SELL_INDEX.items()},
                     **values}.items():
        t = params[key]
        if t.dtype not in dts or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{key} must be contiguous {dts} on {x.device}")
    if (params["a_ptr"].numel() != np_ // SLICE + 1
            or params["b_ptr"].numel() != np_ // SLICE + 1):
        raise ValueError("slice offsets do not match the rows")
    return [params[k].data_ptr() for k in _SELL_INDEX]


def _launch(params, xt) -> torch.Tensor:
    """K1' on the card: checks operands, launches, returns y^T."""
    if xt.dtype != torch.float32 or xt.dim() != 2 or xt.shape[0] < 1:
        raise ValueError(f"x^T must be f32 (R, nx), got {xt.dtype} "
                         f"{tuple(xt.shape)}")
    if not xt.is_contiguous():
        raise ValueError("x^T must be contiguous")
    f32 = (torch.float32,)
    ptrs = sell_args(params, xt, {"a_val": (torch.float32, torch.bfloat16),
                                  "b_val": f32, "diag": f32})
    np_ = params["perm"].numel()
    y = xt.new_empty(xt.shape[0], np_)
    rc = kernels.load().pg_dia_sell(
        *ptrs, params["a_val"].data_ptr(),
        int(params["a_val"].dtype == torch.bfloat16),
        params["b_val"].data_ptr(), params["diag"].data_ptr(),
        xt.data_ptr(), np_, params["nx"], params["x0"], xt.shape[0],
        y.data_ptr(), torch.cuda.current_stream(xt.device).cuda_stream)
    kernels.check_launch(rc, "dia_sell")
    return y


def sell_matvec(params, xt) -> torch.Tensor:
    """Kernel K1' (csrc/dia_sell.cu) on CUDA tensors: y^T = A x^T for f32
    xt of shape (R, nx), y^T (R, np_); the plain version for CPU
    tensors."""
    if xt.device.type == "cpu":
        return sell_matvec_plain(params, xt)
    y = _launch(params, xt)
    kernels.count(sell_matvec, params, xt)
    return y


sell_matvec.launches = 0


def dia_matvec_t(meta, params, xt) -> torch.Tensor:
    """yt = ((Diag + OffDiag) @ xt.T).T for f32 xt of shape (R, np_):
    one launch of K1' over the operator's sliced-ELL params."""
    if xt.shape[-1] != meta[0]:
        raise ValueError(f"x^T has {xt.shape[-1]} columns, meta {meta[0]}")
    return sell_matvec(params, xt.contiguous())
