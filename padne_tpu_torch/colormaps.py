"""Colormaps for field visualization.

Port of padne_tpu.colormaps: the reference's 256-entry viridis / plasma
/ inferno tables (colormaps.py:25-803) as a UniformColorMap with
nearest-sample lookup.  The JAX package samples matplotlib when its
module loads and falls back to polynomial fits (other colours) without
it; the port holds the tables as data instead, in colormaps.npz beside
this module (sampled once from matplotlib 3.10.8 as
`cmap(i / 255.0)[:3]` for i in 0..255, float64), so it reads the same
colours on every machine and never imports matplotlib.
"""

from __future__ import annotations

import pathlib

import numpy as np


class UniformColorMap:
    """Nearest-sample lookup into a (N, 3) float RGB table in [0, 1]."""

    def __init__(self, table: np.ndarray):
        self.table = np.asarray(table, dtype=np.float64)
        if self.table.ndim != 2 or self.table.shape[1] != 3:
            raise ValueError("Colormap table must have shape (N, 3)")

    def __call__(self, value: float) -> tuple[float, float, float]:
        v = min(max(float(value), 0.0), 1.0)
        idx = min(int(v * len(self.table)), len(self.table) - 1)
        return tuple(self.table[idx])

    def map_array(self, values: np.ndarray) -> np.ndarray:
        v = np.clip(np.asarray(values, dtype=np.float64), 0.0, 1.0)
        idx = np.minimum((v * len(self.table)).astype(int), len(self.table) - 1)
        return self.table[idx]


with np.load(pathlib.Path(__file__).with_name("colormaps.npz")) as _tables:
    VIRIDIS = UniformColorMap(_tables["viridis"])
    PLASMA = UniformColorMap(_tables["plasma"])
    INFERNO = UniformColorMap(_tables["inferno"])
