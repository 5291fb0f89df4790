"""Carry state across from the JAX package, by duck typing (no import of
padne_tpu.ops, so no jax).

* `core_system_from_numpy(obj)` takes any object with the CoreSystem
  fields — a padne_tpu.ops.schur.CoreSystem included — and returns the
  port's CoreSystem.
* `dia_params_from_numpy(meta, d, device)` takes a padne_tpu
  DiaPack.to_device parameter dict whose arrays were pulled through
  np.asarray (dense weight slab, ExtraSlots tables, degree-bucketed
  remainder) and the pack's meta, and returns the same operator in the
  port's sliced-ELL format (ops.dia.build_sell): the slab's and the slot
  tables' nonzeros and the remainder become one COO; slab values keep
  the slab's dtype, slot and remainder values stay f32.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import assembly, dia, schur

_BUCKETS = (1, 2, 3)   # padne_tpu DiaPack.REM_BUCKETS


def core_system_from_numpy(obj) -> schur.CoreSystem:
    b = obj.border
    border = schur.BorderSpec(
        m=int(b.m), row_idx=np.asarray(b.row_idx),
        row_node=np.asarray(b.row_node), row_val=np.asarray(b.row_val),
        col_idx=np.asarray(b.col_idx), col_node=np.asarray(b.col_node),
        col_val=np.asarray(b.col_val), rhs=np.asarray(b.rhs))
    ell = assembly.EllMatrix(cols=np.asarray(obj.ell.cols),
                             vals=np.asarray(obj.ell.vals),
                             diag=np.asarray(obj.ell.diag))
    return schur.CoreSystem(
        n=int(obj.n), ell=ell, comp_id=np.asarray(obj.comp_id),
        num_components=int(obj.num_components), border=border,
        r_core=np.asarray(obj.r_core), ground_var=int(obj.ground_var),
        coords=None if obj.coords is None else np.asarray(obj.coords),
        group=None if obj.group is None else np.asarray(obj.group))


def dia_params_from_numpy(meta, d: dict, device) -> dict:
    np_, b, _, _, offs = meta
    d = {k: np.asarray(v) for k, v in d.items()}
    nb = np_ // b
    w = d["w"].reshape(nb, len(offs), b, b)
    # Offset entries: W[rb, o, k, c] couples row rb*b + c to column
    # (rb + offs[o])*b + k (the JAX slab layout).
    rb, o, k, c = np.nonzero(w != 0)
    rows = [rb * b + c]
    cols = [(rb + np.asarray(offs)[o]) * b + k]
    vals = [w[rb, o, k, c].astype(np.float64)]
    n_main = len(rows[0])
    if "xs_tgt" in d:
        # Slot e of row block rb targets column block tgt[rb, e]; lane c
        # holds row rb*b + c's entry at column-local index ci.
        xs_w = d["xs_w"]
        rb, e, c = np.nonzero(xs_w != 0)
        tgt = d["xs_tgt"].astype(np.int64).reshape(nb, -1)
        rows.append(rb * b + c)
        cols.append(tgt[rb, e] * b + d["xs_ci"][rb, e, c])
        vals.append(xs_w[rb, e, c].astype(np.float64))
    rows.append(d["sp_rows"])
    cols.append(d["sp_cols"])
    vals.append(d["sp_vals"].astype(np.float64))
    for deg in _BUCKETS:
        r = d.get(f"r{deg}_rows")
        if r is None or not len(r):
            continue
        rows.append(np.repeat(r, deg))
        cols.append(d[f"r{deg}_cols"].reshape(-1))
        vals.append(d[f"r{deg}_vals"].astype(np.float64).reshape(-1))
    rows = np.concatenate([a.astype(np.int64) for a in rows])
    cols = np.concatenate([a.astype(np.int64) for a in cols])
    dtype = (torch.bfloat16 if w.dtype.name == "bfloat16"
             else torch.float32)
    return dia.build_sell(np_, rows, cols, np.concatenate(vals),
                          d["diag"].astype(np.float64), device, dtype=dtype,
                          keep_f32=np.arange(len(rows)) >= n_main)
