"""Locality ordering for the DIA slab format (host).

Only `hilbert_order` of padne_tpu.ops.bell is on the solve path; the
block-ELL matvec of that module has no production caller and is not
carried.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def hilbert_order(coords: np.ndarray, bits: int = 16,
                  group: Optional[np.ndarray] = None) -> np.ndarray:
    """Hilbert-curve ordering of 2-D points: perm (new index -> old).

    group: optional (n,) int labels sorted as the PRIMARY key, so
    stacked PCB layers (same (x, y) footprint) each stay one contiguous
    Hilbert-ordered block instead of interleaving — which would scatter
    the nonzeros off the few block offsets the slab format relies on.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n >= 100_000 and bits <= 16 and (
        group is None or (np.asarray(group) >= 0).all()
    ):
        # Native single pass + pair sort (packs (group << 32) | distance,
        # so it needs non-negative groups and bits <= 16).
        import ctypes

        from .. import native

        xy = np.ascontiguousarray(coords)
        perm = np.empty(n, dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        gp = (np.ascontiguousarray(group, dtype=np.int64)
              if group is not None else None)
        err = ctypes.create_string_buffer(256)
        rc = native.lib.pg_hilbert_order(
            xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            int(bits), gp.ctypes.data_as(i64p) if gp is not None else None,
            perm.ctypes.data_as(i64p), err, 256)
        if rc != 0:
            raise RuntimeError(err.value.decode())
        return perm
    lo = coords.min(axis=0)
    span = max(float((coords.max(axis=0) - lo).max()), 1e-30)
    scale = (2**bits - 1) / span
    x = ((coords[:, 0] - lo[0]) * scale).astype(np.int64)
    y = ((coords[:, 1] - lo[1]) * scale).astype(np.int64)

    d = np.zeros(n, dtype=np.int64)
    s = 1 << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * np.int64(s) * ((3 * rx) ^ ry)
        # Rotate quadrant so the curve connects.
        swap = ry == 0
        flip = swap & (rx == 1)
        x2 = np.where(flip, s - 1 - x, x)
        y2 = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y2, x2), np.where(swap, x2, y2)
        s >>= 1
    if group is not None:
        return np.lexsort((d, np.asarray(group))).astype(np.int64)
    return np.argsort(d, kind="stable").astype(np.int64)
