"""Block-offset-diagonal (DIA) sparse operators: host packing + device SpMV.

Port of padne_tpu.ops.dia.  Rows/columns are blocked at B=128 after a
locality ordering (ops.bell.hilbert_order); the nonzeros on a few block
offsets d = col_block - row_block are stored as dense weight slabs
W (ng, G, D, B, B), built on the device by one scatter from nnz-sized
host arrays.  The off-offset stragglers form a row-sorted COO remainder;
optionally the remainder's most popular column blocks per row block are
packed as E "slots" (ExtraSlots) that the slab kernel applies directly.

Device side: `slab_matvec` is kernel K1 (csrc/dia_slab.cu) with its plain
PyTorch version `slab_matvec_plain`; `dia_matvec_t` adds the diagonal and
the remainder in torch.  Everything runs in the transposed (R, np)
layout, the one the JAX path uses on its hot loop.

Host packing (choose_offsets, DiaPack, pack_extra_slots, pack_dia and
the pack_*_as_dia helpers) is carried from padne_tpu.ops.dia as numpy;
its arrays equal the JAX package's on the same input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import kernels

DEFAULT_B = 128   # row/column block size
DEFAULT_G = 8     # row-blocks per slab group (the JAX grid step)


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

    All arrays are nnz-sized or O(n); the dense weight slab is built on
    the device by `build_slab` (one scatter)."""

    n: int                 # logical rows (before padding)
    np_: int               # padded rows = ng * G * B
    b: int
    g: int
    ng: int
    offs: tuple[int, ...]
    # Flat index into W = widx_hi * b + widx_lo (kept split: the flat
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

    def to_device(self, device, slab_dtype=torch.float32, w=None,
                  slots: int = 0) -> dict:
        """Device parameter dict: the W slab (scattered here unless an
        existing slab is passed as `w`), the f32 diagonal, the remainder
        as COO, and with `slots` > 0 the ExtraSlots tables (the
        remainder then holds only the unplaced tail).

        Keys: w (ng, g, D, b, b); diag (np_,); rem_rows/rem_cols (int64)
        and rem_vals (f32); with slots also xs_tgt (nb*E,) int32,
        xs_ci (nb, E, b) int32 and xs_w (nb, E, b) f32."""
        if w is None:
            w = build_slab(self, slab_dtype, device)
        rows, cols, vals = self.rem_rows, self.rem_cols, self.rem_vals
        params = {"w": w, "diag": _f32(self.diag, device)}
        if slots and len(rows):
            ex = pack_extra_slots(self, e_max=slots)
            rows, cols, vals = ex.tail_rows, ex.tail_cols, ex.tail_vals
            wslot, cslot = _build_slot_tables(ex)
            params["xs_tgt"] = torch.from_numpy(
                ex.tgt.reshape(-1).astype(np.int32)).to(device)
            params["xs_ci"] = torch.from_numpy(cslot).to(device)
            params["xs_w"] = _f32(wslot, device)
        params["rem_rows"] = torch.from_numpy(
            np.asarray(rows, np.int64)).to(device)
        params["rem_cols"] = torch.from_numpy(
            np.asarray(cols, np.int64)).to(device)
        params["rem_vals"] = _f32(vals, device)
        return params


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


@dataclass
class ExtraSlots:
    """Per-row-block extra-offset packing of a DiaPack remainder.

    The remainder of a Hilbert-ordered FEM operator is long-tailed in
    block offset but concentrated per row block, so its entries are
    packed as E slots per row block: slot e of block rb targets one
    column block tgt[rb, e] and holds at most one entry per local row.
    Entries that don't fit stay in the COO tail."""

    e: int                  # slots per row block
    nb: int                 # row blocks
    b: int
    tgt: np.ndarray         # (nb, e) int32 absolute target block;
    #                         unused slots self-target (weights are 0)
    idx: np.ndarray         # (n_placed,) int32 flat (rb*e + slot)*b + rl
    cls: np.ndarray         # (n_placed,) uint8/16 column-local index
    vals: np.ndarray        # (n_placed,) float64 weights
    tail_rows: np.ndarray   # row-sorted COO leftovers
    tail_cols: np.ndarray
    tail_vals: np.ndarray


def _build_slot_tables(ex: ExtraSlots):
    """Dense (nb, E, b) slot weight and column-index tables (host)."""
    flat = ex.nb * ex.e * ex.b
    wslot = np.zeros(flat)
    cslot = np.zeros(flat, np.int32)
    wslot[ex.idx] = ex.vals
    cslot[ex.idx] = ex.cls
    shape = (ex.nb, ex.e, ex.b)
    return wslot.reshape(shape), cslot.reshape(shape)


def pack_extra_slots(pack: DiaPack, e_max: int = 4) -> ExtraSlots:
    """Assign remainder entries of `pack` to per-row-block extra slots.

    Greedy by block popularity: each row block's candidate (column
    block, duplicate-rank) groups are ranked by entry count and the top
    e_max become slots.  The duplicate rank splits multiple entries of
    the same (row, column block) and guarantees at most one entry per
    (slot, local row), so the flat scatter indices are unique."""
    b = pack.b
    nb = pack.np_ // b
    rr = pack.rem_rows.astype(np.int64)
    rc = pack.rem_cols.astype(np.int64)
    rv = pack.rem_vals
    lo_t = np.uint8 if b <= 256 else np.uint16
    tgt = np.broadcast_to(
        np.arange(nb, dtype=np.int32)[:, None], (nb, e_max)).copy()
    if len(rr) == 0 or e_max == 0:
        z = np.zeros(0, np.int32)
        return ExtraSlots(
            e=e_max, nb=nb, b=b, tgt=tgt, idx=z,
            cls=np.zeros(0, lo_t), vals=np.zeros(0),
            tail_rows=pack.rem_rows, tail_cols=pack.rem_cols,
            tail_vals=pack.rem_vals)
    rb, rl = rr // b, rr % b
    cb, cl = rc // b, rc % b
    # Duplicate rank within (rb, cb, rl): the k-th entry of a row into
    # the same column block must go to a k-th slot with that target.
    key = (rb * nb + cb) * b + rl
    order = np.argsort(key, kind="stable")
    ks = key[order]
    grp_start = np.r_[True, ks[1:] != ks[:-1]]
    gid = np.cumsum(grp_start) - 1
    pos = np.arange(len(ks))
    rank = pos - pos[grp_start][gid]
    rank = np.minimum(rank, 15)
    # Candidate identity (rb, cb, rank) -> count; per-rb top-e_max win.
    ckey = (rb[order] * nb + cb[order]) * 16 + rank
    uc, inv_c, cnt = np.unique(ckey, return_inverse=True,
                               return_counts=True)
    crb = uc // (nb * 16)
    co = np.lexsort((-cnt, crb))
    crb_s = crb[co]
    cstart = np.r_[True, crb_s[1:] != crb_s[:-1]]
    cgid = np.cumsum(cstart) - 1
    cpos = np.arange(len(co))
    crank = cpos - cpos[cstart][cgid]
    slot_of = np.full(len(uc), -1, np.int64)
    slot_of[co] = np.where(crank < e_max, crank, -1)
    entry_slot = slot_of[inv_c]          # in `order` space
    placed = entry_slot >= 0

    rb_o, rl_o = rb[order], rl[order]
    cb_o, cl_o = cb[order], cl[order]
    rv_o = rv[order]
    tgt[rb_o[placed], entry_slot[placed]] = cb_o[placed]
    idx = ((rb_o[placed] * e_max + entry_slot[placed]) * b
           + rl_o[placed]).astype(np.int32)
    t_r, t_c, t_v = rr[order][~placed], rc[order][~placed], rv_o[~placed]
    t_order = np.argsort(t_r, kind="stable")
    return ExtraSlots(
        e=e_max, nb=nb, b=b, tgt=tgt, idx=idx,
        cls=cl_o[placed].astype(lo_t), vals=rv_o[placed],
        tail_rows=t_r[t_order].astype(np.int32),
        tail_cols=t_c[t_order].astype(np.int32),
        tail_vals=t_v[t_order])


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
# Device side


def build_slab(pack: DiaPack, dtype, device, values=None) -> torch.Tensor:
    """The dense (ng, g, D, b, b) weight slab, scattered on the device
    from the nnz-sized split index (values: override pack.wval, e.g. the
    f32 lo-halves of the compensated operator)."""
    d, b = len(pack.offs), pack.b
    vals = pack.wval if values is None else values
    idx = torch.from_numpy(pack.widx_hi.astype(np.int64)).to(device)
    idx.mul_(b).add_(torch.from_numpy(pack.widx_lo).to(device))
    w = torch.zeros(pack.ng * pack.g * d * b * b, dtype=dtype, device=device)
    w[idx] = _f32(vals, device).to(dtype)
    return w.reshape(pack.ng, pack.g, d, b, b)


def slab_matvec_plain(meta, w, xt, slots=None) -> torch.Tensor:
    """Plain PyTorch version of K1 (the counterpart of the JAX package's
    `_xla_main`): the slab part plus the slot entries of y^T = A x^T for
    xt of shape (R, np_), f32 accumulation, bf16 slabs widened to f32.
    Column blocks outside [0, nb) contribute nothing."""
    np_, b, g, ng, offs = meta
    r = xt.shape[0]
    nb = np_ // b
    wb = w.reshape(nb, len(offs), b, b)
    xb = xt.reshape(r, nb, b).transpose(0, 1)            # (nb, r, b)
    acc = torch.zeros(nb, r, b, dtype=torch.float32, device=xt.device)
    for di, o in enumerate(offs):
        lo, hi = max(0, -o), min(nb, nb - o)
        if lo < hi:
            acc[lo:hi] += torch.bmm(xb[lo + o:hi + o],
                                    wb[lo:hi, di].to(torch.float32))
    y = acc.transpose(0, 1).reshape(r, np_)
    if slots is not None:
        tgt, ci, we = slots
        e = we.shape[1]
        xe = xt.reshape(r, nb, b)[:, tgt.long().reshape(nb, e)]
        sel = torch.gather(xe, 3, ci.long().expand(r, nb, e, b))
        y = y + (we.to(torch.float32) * sel).sum(2).reshape(r, np_)
    return y


def slab_matvec(meta, w, xt, slots=None) -> torch.Tensor:
    """Kernel K1 on CUDA tensors (csrc/dia_slab.cu); the plain version
    for CPU tensors.  slots: optional (xs_tgt, xs_ci, xs_w)."""
    if xt.device.type == "cpu":
        return slab_matvec_plain(meta, w, xt, slots)
    np_, b, g, ng, offs = meta
    r = xt.shape[0]
    if b != 128:
        raise ValueError(f"dia_slab kernel needs b=128, got {b}")
    if xt.dtype != torch.float32 or xt.shape != (r, np_) or r < 1:
        raise ValueError(f"x^T must be f32 (R, {np_}), got "
                         f"{xt.dtype} {tuple(xt.shape)}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"slab dtype {w.dtype} not supported")
    if w.numel() != np_ * len(offs) * b:
        raise ValueError("slab size does not match meta")
    tensors = [xt, w]
    e = 0
    tgt = ci = we = None
    if slots is not None:
        tgt, ci, we = slots
        e = we.shape[1]
        if (tgt.dtype != torch.int32 or ci.dtype != torch.int32
                or we.dtype != torch.float32
                or tgt.numel() != (np_ // b) * e
                or ci.shape != (np_ // b, e, b) or we.shape != ci.shape):
            raise ValueError("malformed slot tables")
        tensors += [tgt, ci, we]
    for t in tensors:
        if t.device != xt.device or not t.is_contiguous():
            raise ValueError("dia_slab operands must be contiguous and on "
                             "the same device")
    y = torch.empty_like(xt)
    rc = kernels.load().pg_dia_slab(
        xt.data_ptr(), np_, w.data_ptr(), int(w.dtype == torch.bfloat16),
        len(offs), kernels.offsets_arg(offs), r,
        tgt.data_ptr() if e else None, ci.data_ptr() if e else None,
        we.data_ptr() if e else None, e, y.data_ptr(),
        torch.cuda.current_stream(xt.device).cuda_stream)
    kernels.check_launch(rc, "dia_slab")
    slab_matvec.launches += 1
    return y


slab_matvec.launches = 0


def _slots(params):
    """The (tgt, ci, we) slot triple of a params dict, or None."""
    if "xs_tgt" not in params:
        return None
    return (params["xs_tgt"], params["xs_ci"], params["xs_w"])


def dia_matvec_t(meta, params, xt) -> torch.Tensor:
    """yt = ((Diag + OffDiag) @ xt.T).T for f32 xt of shape (R, np_):
    slab + slots through K1, then the diagonal and the COO remainder."""
    xt = xt.contiguous()
    yt = slab_matvec(meta, params["w"], xt, _slots(params))
    yt.addcmul_(params["diag"][None, :], xt)
    if params["rem_rows"].numel():
        yt.index_add_(1, params["rem_rows"],
                      xt[:, params["rem_cols"]] * params["rem_vals"])
    return yt
