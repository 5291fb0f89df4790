"""Row-sharded block-offset-DIA operators: the sharded SpMV.

Port of padne_tpu.ops.dia_sharded.  The format shards over a 1-D `tp`
list of devices (parallel.sharding.Mesh): shard s owns the rows
[s * np_local, (s + 1) * np_local) in whole grid steps, so an offset
entry's column lies within one halo of `dmax * B` columns on either side
of the shard's rows.  The host plan (`ShardPlan`, `shardable`,
`plan_shards`, numpy; its arrays equal the JAX package's) splits the
remainder per shard into

* near entries, whose column lies in the shard's halo-extended window;
* far entries, whose source values travel in a compressed exchange:
  each shard gathers only the x entries some other shard needs
  (`src_idx`, padded to the largest per-shard count Ms), and every shard
  reads the (R, tp * Ms) concatenation of them.

On the device (`upload_sharded`) each shard's operator is one sliced ELL
(ops.dia.build_sell), built on the shard's device, over the window

    [ left halo | the shard's rows | right halo | far exchange ]

of nx = np_local + 2 * halo + tp * Ms columns, row i's own at x0 = halo:
the offset entries and the near remainder with their columns in window
coordinates, the far entries at column window + far_pos, and the
diagonal.  `dia_matvec_t_sharded` exchanges the halos, gathers the far
block and launches kernel K1' once per shard: near, far and diagonal in
one pass, where the JAX package scatter-adds the remainder after its
slab kernel.  `comp_sharded` is the same for kernel K2' (compensated
f64 residuals) over an operator built with compensated=True.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..parallel import sharding
from . import comp, dia


@dataclass
class ShardPlan:
    """Host-side sharding of one DiaPack's remainder + geometry.

    All (tp, M) arrays are padded with inert entries (row 0 / index 0 /
    value 0) so every shard sees the same static shapes.
    """

    tp: int
    np_local: int
    halo: int                 # halo width in elements (= dmax * B)
    near_row: np.ndarray      # (tp, Mn) int32 local row
    near_win: np.ndarray      # (tp, Mn) int32 index into local padded window
    near_val: np.ndarray      # (tp, Mn) float
    far_row: np.ndarray       # (tp, Mf) int32 local row
    far_pos: np.ndarray       # (tp, Mf) int32 index into gathered exchange
    far_val: np.ndarray       # (tp, Mf) float
    src_idx: np.ndarray       # (tp, Ms) int32 local col feeding the exchange

    @property
    def meta_local(self):
        return (self.tp, self.np_local, self.halo,
                self.near_row.shape[1], self.far_row.shape[1],
                self.src_idx.shape[1])


def _dmax(offs) -> int:
    return max(max(abs(o) for o in offs), 1)


def shardable(pack: dia.DiaPack, tp: int) -> bool:
    """A pack shards iff whole grid steps divide evenly and the slab
    window never reaches past the immediate neighbor."""
    if tp <= 1 or pack.ng % tp:
        return False
    np_local = pack.np_ // tp
    return _dmax(pack.offs) * pack.b <= np_local


def _pad_rows_2d(parts: list[np.ndarray], dtype) -> np.ndarray:
    m = max((len(p) for p in parts), default=0)
    out = np.zeros((len(parts), m), dtype=dtype)
    for i, p in enumerate(parts):
        out[i, : len(p)] = p
    return out


def plan_shards(pack: dia.DiaPack, tp: int) -> ShardPlan:
    """Split the remainder into per-shard near/far lists and build the
    compressed far exchange."""
    if not shardable(pack, tp):
        raise ValueError("pack is not shardable over this tp")
    np_local = pack.np_ // tp
    halo = _dmax(pack.offs) * pack.b
    rows = pack.rem_rows.astype(np.int64)
    cols = pack.rem_cols.astype(np.int64)
    vals = pack.rem_vals

    shard = rows // np_local
    win_lo = shard * np_local - halo
    near = (cols >= win_lo) & (cols < win_lo + np_local + 2 * halo)

    near_row, near_win, near_val = [], [], []
    for s in range(tp):
        sel = near & (shard == s)
        near_row.append((rows[sel] - s * np_local).astype(np.int32))
        near_win.append((cols[sel] - (s * np_local - halo)).astype(np.int32))
        near_val.append(vals[sel])

    # Compressed exchange for far entries: unique source columns, laid
    # out grouped by their owning shard, each group padded to Ms.
    f_rows, f_cols, f_vals = rows[~near], cols[~near], vals[~near]
    fc = np.unique(f_cols)
    src_shard = fc // np_local
    counts = np.bincount(src_shard, minlength=tp)
    ms = int(counts.max(initial=0))
    # Gathered position of each fc entry: owner * Ms + rank.
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(len(fc)) - starts[src_shard]
    gathered_pos = (src_shard * ms + rank).astype(np.int64)
    src_idx_parts = [(fc[src_shard == s] - s * np_local).astype(np.int32)
                     for s in range(tp)]

    far_row, far_pos, far_val = [], [], []
    f_shard = f_rows // np_local
    for s in range(tp):
        sel = f_shard == s
        far_row.append((f_rows[sel] - s * np_local).astype(np.int32))
        # fc is sorted and unique: a searchsorted finds each column's slot.
        far_pos.append(gathered_pos[np.searchsorted(fc, f_cols[sel])]
                       .astype(np.int32))
        far_val.append(f_vals[sel])

    return ShardPlan(
        tp=tp, np_local=np_local, halo=halo,
        near_row=_pad_rows_2d(near_row, np.int32),
        near_win=_pad_rows_2d(near_win, np.int32),
        near_val=_pad_rows_2d(near_val, np.float64),
        far_row=_pad_rows_2d(far_row, np.int32),
        far_pos=_pad_rows_2d(far_pos, np.int32),
        far_val=_pad_rows_2d(far_val, np.float64),
        src_idx=_pad_rows_2d(src_idx_parts, np.int32),
    )


@dataclass
class ShardedOperator:
    """A pack's operator row-sharded over `mesh`: params[s] is shard s's
    sliced-ELL operator over its window (module doc) and src_idx[s] the
    local columns it contributes to the far exchange, both on
    mesh.devices[s]."""

    mesh: sharding.Mesh
    params: list
    src_idx: list
    np_local: int
    halo: int
    ms: int

    @property
    def nx(self) -> int:
        return self.np_local + 2 * self.halo + self.mesh.size * self.ms

    def exchange_bytes(self, r: int, itemsize: int = 4) -> int:
        """Bytes one product moves between shards at width r: two halos
        into every shard but the edge ones, and the far exchange into
        every shard."""
        tp = self.mesh.size
        return r * itemsize * (2 * (tp - 1) * self.halo
                               + tp * tp * self.ms)


def upload_sharded(pack: dia.DiaPack, plan: ShardPlan, mesh: sharding.Mesh,
                   dtype=torch.float32,
                   compensated: bool = False) -> ShardedOperator:
    """The pack's operator as one sliced-ELL operator per shard, each
    built on its shard's device from that shard's entries only: offset
    entries in `dtype`, remainder (near and far) entries and the diagonal
    in f32 as ops.dia.DiaPack.to_device keeps them; compensated adds the
    lo-halves and the f64 diagonal of ops.comp."""
    tp = plan.tp
    if mesh.size != tp:
        raise ValueError(f"the plan has {tp} shards, the mesh {mesh.size}")
    b, d, nl, halo = pack.b, len(pack.offs), plan.np_local, plan.halo
    window = nl + 2 * halo
    ms = plan.src_idx.shape[1]
    nx = window + tp * ms
    offs = np.asarray(pack.offs, np.int64)
    hi = pack.widx_hi.astype(np.int64)
    blk = hi // b
    rb = blk // d
    rows_main = rb * b + pack.widx_lo.astype(np.int64)
    cols_main = (rb + offs[blk % d]) * b + hi % b
    shard_main = rows_main // nl
    params, src_idx = [], []
    for s, dev in enumerate(mesh.devices):
        lo = s * nl
        sel = shard_main == s
        # The plan's padding slots carry value 0: they are not entries.
        near = plan.near_val[s] != 0
        far = plan.far_val[s] != 0
        rows = np.concatenate([rows_main[sel] - lo,
                               plan.near_row[s][near], plan.far_row[s][far]])
        cols = np.concatenate([cols_main[sel] - (lo - halo),
                               plan.near_win[s][near],
                               window + plan.far_pos[s][far].astype(np.int64)])
        vals = np.concatenate([np.asarray(pack.wval[sel], np.float64),
                               plan.near_val[s][near], plan.far_val[s][far]])
        keep_f32 = np.arange(len(rows)) >= int(sel.sum())
        params.append(dia.build_sell(
            nl, rows.astype(np.int64), cols.astype(np.int64), vals,
            pack.diag[lo:lo + nl], dev, dtype=dtype, keep_f32=keep_f32,
            compensated=compensated, nx=nx, x0=halo))
        src_idx.append(torch.from_numpy(
            plan.src_idx[s].astype(np.int64)).to(dev))
    return ShardedOperator(mesh=mesh, params=params, src_idx=src_idx,
                           np_local=nl, halo=halo, ms=ms)


def windows(op: ShardedOperator, xs: list) -> list:
    """Each shard's window [left halo | rows | right halo | far exchange]
    of the per-shard (R, np_local) or (np_local,) tensors xs, on its
    device: the halo exchange, then the all-gather of the far sources
    (padded src_idx slots gather a real value that no entry reads)."""
    mesh = op.mesh
    left, right = sharding.halo_exchange(mesh, xs, op.halo)
    parts = [left, xs, right]
    if op.ms:
        parts.append(sharding.all_gather(
            mesh, [x[..., i] for x, i in zip(xs, op.src_idx)], dim=-1))
    return [torch.cat(p, dim=-1) for p in zip(*parts)]


def dia_matvec_t_sharded(op: ShardedOperator, xts: list) -> list:
    """y^T = A x^T shard by shard: xts[s] is shard s's (R, np_local) f32
    block on its device; one launch of K1' per shard over its window."""
    return [dia.sell_matvec(p, w)
            for p, w in zip(op.params, windows(op, xts))]


def comp_sharded(op: ShardedOperator, xs: list) -> list:
    """A64 @ x as float64 shard by shard (kernel K2' per shard over its
    window) for per-shard f32 (np_local,) vectors; the operator must be
    built with compensated=True."""
    return [comp.comp_sell(p, w) for p, w in zip(op.params, windows(op, xs))]
