"""Spatial picking indices for viewers and probes.

Role parity with the reference UI's VertexSpatialIndex /
FaceSpatialIndex (ui.py:191-267): KD-tree accelerated nearest-vertex
and nearest-face queries across all meshes of a LayerSolution, used by
the interactive viewers' probing and min/max color-scale pickers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import solver as solver_mod


@dataclass
class PickResult:
    mesh_index: int
    item_index: int   # vertex or face index within that mesh
    distance: float
    value: float


class VertexSpatialIndex:
    """Nearest mesh vertex across all meshes of one layer solution."""

    def __init__(self, layer_solution: solver_mod.LayerSolution):
        import scipy.spatial

        self._ls = layer_solution
        pts = []
        owners = []
        for mi, m in enumerate(layer_solution.meshes):
            pts.append(m.vertices)
            owners.append(
                np.stack(
                    [np.full(m.num_vertices, mi), np.arange(m.num_vertices)],
                    axis=1,
                )
            )
        if pts:
            self._tree = scipy.spatial.cKDTree(np.concatenate(pts))
            self._owners = np.concatenate(owners)
        else:
            self._tree = None
            self._owners = np.zeros((0, 2), dtype=np.int64)

    def query(self, x: float, y: float) -> Optional[PickResult]:
        if self._tree is None:
            return None
        dist, k = self._tree.query([x, y])
        mi, vi = (int(v) for v in self._owners[k])
        value = float(self._ls.potentials[mi].values[vi])
        return PickResult(mesh_index=mi, item_index=vi, distance=float(dist),
                          value=value)


class FaceSpatialIndex:
    """Nearest face centroid across all meshes of one layer solution."""

    def __init__(self, layer_solution: solver_mod.LayerSolution):
        import scipy.spatial

        self._ls = layer_solution
        pts = []
        owners = []
        for mi, m in enumerate(layer_solution.meshes):
            pts.append(m.face_centroids)
            owners.append(
                np.stack(
                    [np.full(m.num_faces, mi), np.arange(m.num_faces)], axis=1
                )
            )
        if pts:
            self._tree = scipy.spatial.cKDTree(np.concatenate(pts))
            self._owners = np.concatenate(owners)
        else:
            self._tree = None
            self._owners = np.zeros((0, 2), dtype=np.int64)

    def query(self, x: float, y: float) -> Optional[PickResult]:
        if self._tree is None:
            return None
        dist, k = self._tree.query([x, y])
        mi, fi = (int(v) for v in self._owners[k])
        value = (
            float(self._ls.power_densities[mi].values[fi])
            if mi < len(self._ls.power_densities)
            else 0.0
        )
        return PickResult(mesh_index=mi, item_index=fi, distance=float(dist),
                          value=value)
