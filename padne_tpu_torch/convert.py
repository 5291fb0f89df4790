"""Carry state across from the JAX package, by duck typing (no import of
padne_tpu.ops, so no jax).

* `core_system_from_numpy(obj)` takes any object with the CoreSystem
  fields — a padne_tpu.ops.schur.CoreSystem included — and returns the
  port's CoreSystem.
* `dia_params_from_numpy(d, device)` takes a padne_tpu DiaPack.to_device
  parameter dict whose arrays were pulled through np.asarray and returns
  the port's device parameter dict (ops.dia.DiaPack.to_device layout):
  the degree-bucketed remainder and its spill flatten into one COO.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import assembly, schur

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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # No numpy bfloat16 in torch.from_numpy: move the raw bits.
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def dia_params_from_numpy(d: dict, device) -> dict:
    d = {k: np.asarray(v) for k, v in d.items()}
    rows = [d["sp_rows"].astype(np.int64)]
    cols = [d["sp_cols"].astype(np.int64)]
    vals = [d["sp_vals"].astype(np.float32)]
    for k in _BUCKETS:
        r = d.get(f"r{k}_rows")
        if r is None or not len(r):
            continue
        rows.append(np.repeat(r.astype(np.int64), k))
        cols.append(d[f"r{k}_cols"].astype(np.int64).reshape(-1))
        vals.append(d[f"r{k}_vals"].astype(np.float32).reshape(-1))
    out = {
        "w": _tensor(d["w"], device),
        "diag": _tensor(d["diag"].astype(np.float32), device),
        "rem_rows": _tensor(np.concatenate(rows), device),
        "rem_cols": _tensor(np.concatenate(cols), device),
        "rem_vals": _tensor(np.concatenate(vals), device),
    }
    if "xs_tgt" in d:
        out["xs_tgt"] = _tensor(d["xs_tgt"].astype(np.int32), device)
        out["xs_ci"] = _tensor(d["xs_ci"].astype(np.int32), device)
        out["xs_w"] = _tensor(d["xs_w"].astype(np.float32), device)
    return out
