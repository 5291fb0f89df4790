"""Triangle meshes as flat arrays, DEC forms, and the mesher front-end.

Architectural departure from the reference: where padne builds an object
half-edge graph in Python (mesh.py:72-378) and walks it in hot loops, this
framework keeps meshes as flat numpy arrays (vertices (V,2), triangles
(F,3)) so that cotangent weights, stiffness assembly and field
post-processing are single vectorized expressions that move straight onto
the device.  Adjacency (unique edges, boundary masks)
is derived once with numpy and cached.

Discrete-exterior-calculus forms (ZeroForm on vertices / OneForm on edges
/ TwoForm on faces, reference mesh.py:381-639) are thin array wrappers
with the same arithmetic semantics.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

import numpy as np

from . import geom, native
from .utils.validation import checked


class MeshingException(RuntimeError):
    """Raised when mesh generation fails due to invalid geometry
    (self-intersecting rings, degenerate edges, ...).  Parity with the
    reference's MeshingException (mesh.py:646-659)."""


@dataclass(frozen=True, eq=False)
class TriMesh:
    """An immutable triangle mesh in flat-array form.

    vertices: (V, 2) float64, mm.
    triangles: (F, 3) int32, CCW.

    eq=False: identity semantics (the generated field-wise __eq__ would
    raise on ndarray fields, and form cross-mesh checks already compare
    by identity).
    """

    vertices: np.ndarray
    triangles: np.ndarray

    def __post_init__(self):
        v = np.ascontiguousarray(np.asarray(self.vertices, dtype=np.float64))
        t = np.ascontiguousarray(np.asarray(self.triangles, dtype=np.int32))
        if v.ndim != 2 or v.shape[1] != 2:
            raise ValueError("vertices must have shape (V, 2)")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError("triangles must have shape (F, 3)")
        object.__setattr__(self, "vertices", v)
        object.__setattr__(self, "triangles", t)

    # -- basic counts -------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_faces(self) -> int:
        return len(self.triangles)

    # -- derived topology ---------------------------------------------------
    @cached_property
    def _edge_data(self) -> tuple:
        """(edges (E, 2) int32 with e[0] < e[1], inverse (3F,)).

        Unique undirected edges via a packed lo<<32|hi int64 key — a
        1-D sort, ~7x faster than np.unique(axis=0)'s void-dtype path
        at millions of faces.  `inverse` maps the raw directed-edge
        slot (block-major: [v0v1 | v1v2 | v2v0]) to its unique edge id
        and is reused by edge_face_count / cotan_edge_weights so the
        sort happens once."""
        if self.num_faces >= 50_000:
            # Native twin (one C++ sort; ~4x the numpy np.unique path
            # at millions of faces).
            from . import native

            return native.unique_edges(self.triangles)
        t = self.triangles.astype(np.int64)
        a = np.concatenate([t[:, 0], t[:, 1], t[:, 2]])
        b = np.concatenate([t[:, 1], t[:, 2], t[:, 0]])
        lo = np.minimum(a, b)
        hi = np.maximum(a, b)
        uniq, inverse = np.unique(lo << 32 | hi, return_inverse=True)
        edges = np.stack(
            [uniq >> 32, uniq & 0xFFFFFFFF], axis=1).astype(np.int32)
        return edges, inverse.reshape(-1)

    @cached_property
    def edges(self) -> np.ndarray:
        """Unique undirected edges as (E, 2) int32 with e[0] < e[1]."""
        return self._edge_data[0]

    @cached_property
    def _edge_index(self) -> dict:
        return {(int(a), int(b)): i for i, (a, b) in enumerate(self.edges)}

    @cached_property
    def edge_face_count(self) -> np.ndarray:
        """Number of incident faces per unique edge (1 = boundary edge)."""
        edges, inverse = self._edge_data
        return np.bincount(inverse, minlength=len(edges))

    @cached_property
    def boundary_edge_mask(self) -> np.ndarray:
        return self.edge_face_count == 1

    @cached_property
    def boundary_vertex_mask(self) -> np.ndarray:
        mask = np.zeros(self.num_vertices, dtype=bool)
        be = self.edges[self.boundary_edge_mask]
        mask[be.reshape(-1)] = True
        return mask

    @cached_property
    def face_areas(self) -> np.ndarray:
        p = self.vertices[self.triangles]  # (F, 3, 2)
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        return 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    @cached_property
    def face_centroids(self) -> np.ndarray:
        return self.vertices[self.triangles].mean(axis=1)

    @cached_property
    def total_area(self) -> float:
        return float(self.face_areas.sum())

    # -- cotangent weights ---------------------------------------------------
    @cached_property
    def cotan_edge_weights(self) -> np.ndarray:
        """Per-unique-edge weight w_ij = sum over adjacent faces of
        cot(angle opposite the edge) / 2 — the standard P1 FEM stiffness
        weights.

        Deliberate improvement over the reference, whose HalfEdge.cotan()
        takes |cot| per face (mesh.py:124-139): the absolute value
        introduces an O(1) consistency error on obtuse triangles (measured
        ~2x worse field error on the coaxial analytic benchmark).  The
        signed stiffness matrix is positive semidefinite for ANY
        triangulation (it is the Galerkin matrix of the Dirichlet energy),
        so the CG solve is unaffected; on (constrained) Delaunay meshes
        almost all edge weights are nonnegative anyway.
        """
        t = self.triangles
        p = self.vertices[t]  # (F, 3, 2)
        edges, inverse = self._edge_data
        nf = len(t)
        w = np.zeros(len(edges), dtype=np.float64)
        # For corner k of each face, the opposite edge is (k+1, k+2);
        # its slot in the raw block-major edge list ([v0v1|v1v2|v2v0])
        # is block (k+1)%3 — bincount over the cached inverse replaces
        # the per-corner sorted lookup + np.add.at (7 s -> ~0.3 s at 2M
        # faces).
        for k in range(3):
            a = p[:, k]
            b = p[:, (k + 1) % 3]
            c = p[:, (k + 2) % 3]
            u = b - a
            v = c - a
            cross = u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]
            dot = (u * v).sum(axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                cot = np.where(cross != 0.0, dot / np.where(cross != 0.0, cross, 1.0), 0.0)
            eid = inverse[((k + 1) % 3) * nf:((k + 1) % 3 + 1) * nf]
            w += np.bincount(eid, weights=cot / 2.0, minlength=len(edges))
        return w

    def laplacian_coo(self, scale: float = 1.0):
        """Reference-convention cotan Laplacian as scipy COO:
        L[i,j] += w_ij, L[i,i] -= sum_j w_ij (negative semidefinite),
        matching solver.py:171-213.  Used for host-side verification."""
        import scipy.sparse

        e = self.edges
        w = self.cotan_edge_weights * scale
        n = self.num_vertices
        diag = np.zeros(n)
        np.add.at(diag, e[:, 0], -w)
        np.add.at(diag, e[:, 1], -w)
        rows = np.concatenate([e[:, 0], e[:, 1], np.arange(n)])
        cols = np.concatenate([e[:, 1], e[:, 0], np.arange(n)])
        vals = np.concatenate([w, w, diag])
        return scipy.sparse.coo_matrix((vals, (rows, cols)), shape=(n, n))

    def euler_characteristic(self) -> int:
        return self.num_vertices - len(self.edges) + self.num_faces

    def validate(self, min_angle_deg: float = 0.0,
                 max_edge_length: float = 0.0) -> None:
        """Assert the structural invariants every solver stage relies on;
        raise MeshingException naming the first violation.

        Always checked: finite coordinates, in-range triangle indices,
        no degenerate or duplicate faces, consistent CCW orientation,
        manifoldness (<= 2 faces per edge), no isolated vertices, and
        boundary loops that close (every boundary vertex touches an even
        number of boundary edges).  `min_angle_deg` / `max_edge_length`
        additionally gate mesh *quality* — pass the mesher's refinement
        targets to verify its output honors them (the reference runs the
        analogous gate over every mesher output, tests/test_mesh.py:423+).
        """
        v, t = self.vertices, self.triangles

        def fail(msg):
            raise MeshingException(f"mesh validation failed: {msg}")

        if not np.isfinite(v).all():
            fail("non-finite vertex coordinates")
        if len(t):
            if t.min() < 0 or t.max() >= len(v):
                fail("triangle index out of range")
            if (np.sort(t, axis=1)[:, :-1] == np.sort(t, axis=1)[:, 1:]).any():
                fail("degenerate face (repeated vertex)")
            if len(np.unique(np.sort(t, axis=1), axis=0)) != len(t):
                fail("duplicate face")
            p = v[t]
            cross = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
                     - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
            if (cross <= 0).any():
                fail(f"{int((cross <= 0).sum())} non-CCW (or zero-area) "
                     "face(s)")
        if (self.edge_face_count > 2).any():
            fail("non-manifold edge (more than 2 incident faces)")
        used = np.zeros(len(v), dtype=bool)
        used[t.reshape(-1)] = True
        if not used.all():
            fail(f"{int((~used).sum())} isolated vertex/vertices")
        be = self.edges[self.boundary_edge_mask]
        deg = np.bincount(be.reshape(-1), minlength=len(v))
        bad = deg % 2 != 0
        if bad.any():
            fail("boundary does not close (odd boundary degree at "
                 f"{int(bad.sum())} vertex/vertices)")

        if min_angle_deg > 0.0 and len(t):
            p = v[t]
            angles = np.empty((len(t), 3))
            for k in range(3):
                u = p[:, (k + 1) % 3] - p[:, k]
                w = p[:, (k + 2) % 3] - p[:, k]
                cosang = (u * w).sum(1) / np.maximum(
                    np.linalg.norm(u, axis=1) * np.linalg.norm(w, axis=1),
                    1e-300)
                angles[:, k] = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
            amin = float(angles.min())
            if amin < min_angle_deg:
                fail(f"minimum angle {amin:.2f} deg < {min_angle_deg} deg")
        if max_edge_length > 0.0 and len(self.edges):
            el = np.linalg.norm(
                v[self.edges[:, 0]] - v[self.edges[:, 1]], axis=1)
            emax = float(el.max())
            if emax > max_edge_length:
                fail(f"edge length {emax:.3g} > {max_edge_length:.3g}")

    # -- serialization -------------------------------------------------------
    def to_arrays(self) -> dict:
        return {"vertices": self.vertices, "triangles": self.triangles}

    @classmethod
    def from_arrays(cls, data) -> "TriMesh":
        return cls(vertices=data["vertices"], triangles=data["triangles"])


# ---------------------------------------------------------------------------
# DEC forms
# ---------------------------------------------------------------------------
class _FormBase:
    mesh: TriMesh
    values: np.ndarray

    def _check(self, other):
        if self.mesh is not other.mesh:
            raise ValueError(
                f"Cannot combine {type(self).__name__}s on different meshes"
            )

    def _new(self, values):
        obj = type(self)(self.mesh)
        obj.values = values
        return obj

    def __add__(self, other):
        self._check(other)
        return self._new(self.values + other.values)

    def __sub__(self, other):
        self._check(other)
        return self._new(self.values - other.values)

    def __mul__(self, scalar: float):
        return self._new(self.values * scalar)

    __rmul__ = __mul__

    def __truediv__(self, scalar: float):
        if scalar == 0:
            raise ZeroDivisionError(f"Cannot divide {type(self).__name__} by zero")
        return self._new(self.values / scalar)

    def __neg__(self):
        return self._new(-self.values)


class ZeroForm(_FormBase):
    """Scalar field on vertices."""

    def __init__(self, mesh: TriMesh, values: Optional[np.ndarray] = None):
        self.mesh = mesh
        if values is None:
            values = np.zeros(mesh.num_vertices, dtype=np.float64)
        else:
            values = np.asarray(values, dtype=np.float64)
            if values.shape != (mesh.num_vertices,):
                raise ValueError("ZeroForm values must have shape (V,)")
        self.values = values

    def _new(self, values):
        return ZeroForm(self.mesh, values)

    def __getitem__(self, vertex: int) -> float:
        return float(self.values[vertex])

    def __setitem__(self, vertex: int, value: float) -> None:
        self.values[vertex] = value

    def d(self) -> "OneForm":
        """Exterior derivative: (df)[(u, v)] = f[v] - f[u] for each unique
        edge in canonical (u < v) orientation."""
        e = self.mesh.edges
        return OneForm(self.mesh, self.values[e[:, 1]] - self.values[e[:, 0]])


class OneForm(_FormBase):
    """Field on unique edges, stored for the canonical (min, max) direction;
    the opposite direction is implied by antisymmetry."""

    def __init__(self, mesh: TriMesh, values: Optional[np.ndarray] = None):
        self.mesh = mesh
        if values is None:
            values = np.zeros(len(mesh.edges), dtype=np.float64)
        else:
            values = np.asarray(values, dtype=np.float64)
            if values.shape != (len(mesh.edges),):
                raise ValueError("OneForm values must have shape (E,)")
        self.values = values

    def _new(self, values):
        return OneForm(self.mesh, values)

    def on_edge(self, u: int, v: int) -> float:
        """Value for the directed edge u -> v (antisymmetric lookup)."""
        key = (min(u, v), max(u, v))
        idx = self.mesh._edge_index[key]
        val = float(self.values[idx])
        return val if u < v else -val


class TwoForm(_FormBase):
    """Field on faces."""

    def __init__(self, mesh: TriMesh, values: Optional[np.ndarray] = None):
        self.mesh = mesh
        if values is None:
            values = np.zeros(mesh.num_faces, dtype=np.float64)
        else:
            values = np.asarray(values, dtype=np.float64)
            if values.shape != (mesh.num_faces,):
                raise ValueError("TwoForm values must have shape (F,)")
        self.values = values

    def _new(self, values):
        return TwoForm(self.mesh, values)

    def __getitem__(self, face: int) -> float:
        return float(self.values[face])

    def __setitem__(self, face: int, value: float) -> None:
        self.values[face] = value


# ---------------------------------------------------------------------------
# Mesher
# ---------------------------------------------------------------------------
class Mesher:
    """Polygon -> TriMesh via the native CDT/refinement core.

    Config semantics match the reference Mesher.Config (mesh.py:668-705):
    minimum triangle angle, maximum edge length, and variable-density
    grading driven by a quantized boundary-distance map.
    """

    @dataclass(frozen=True)
    class Config:
        minimum_angle: float = 20.0
        maximum_size: float = 0.6
        variable_density_min_distance: float = 0.5
        variable_density_max_distance: float = 3.0
        variable_size_maximum_factor: float = 3.0
        distance_map_quantization: float = 1.0

        RELAXED = None  # set below

        @property
        def is_variable_density(self) -> bool:
            return self.variable_size_maximum_factor != 1.0

        def __post_init__(self):
            if not (0 <= self.minimum_angle <= 60):
                raise ValueError(
                    f"minimum_angle must be between 0 and 60 degrees, got {self.minimum_angle}"
                )
            if self.maximum_size < 0:
                raise ValueError(
                    f"maximum_size must be non-negative, got {self.maximum_size}"
                )
            if self.variable_density_min_distance < 0:
                raise ValueError(
                    "variable_density_min_distance must be non-negative, "
                    f"got {self.variable_density_min_distance}"
                )
            if self.variable_density_max_distance <= self.variable_density_min_distance:
                raise ValueError(
                    f"variable_density_max_distance ({self.variable_density_max_distance}) "
                    "must be greater than variable_density_min_distance "
                    f"({self.variable_density_min_distance})"
                )
            if self.variable_size_maximum_factor < 1.0:
                raise ValueError(
                    f"variable_size_maximum_factor must be >= 1.0, got {self.variable_size_maximum_factor}"
                )
            if self.distance_map_quantization <= 0:
                raise ValueError(
                    f"distance_map_quantization must be positive, got {self.distance_map_quantization}"
                )

    def __init__(self, config: Optional["Mesher.Config"] = None):
        self.config = config if config is not None else Mesher.Config()

    @checked
    def poly_to_mesh(
        self,
        poly: geom.Polygon,
        seed_points: Optional[list[geom.Point]] = None,
        strict: bool = True,
    ) -> TriMesh:
        """Triangulate a polygon (with holes).  Interior ``seed_points``
        are forced to become mesh vertices (connection points)."""
        seed_points = seed_points or []
        cfg = self.config

        rings = list(poly.rings)
        xy, sizes = geom._pack_rings(rings)
        seeds = np.ascontiguousarray(
            np.array([[p.x, p.y] for p in seed_points], dtype=np.float64).reshape(-1)
        )

        handle = ctypes.c_void_p()
        err = ctypes.create_string_buffer(512)
        rc = native.lib.pg_triangulate(
            geom._dptr(xy),
            geom._i32ptr(sizes),
            len(sizes),
            geom._dptr(seeds),
            len(seed_points),
            float(cfg.minimum_angle),
            float(cfg.maximum_size),
            float(cfg.variable_density_min_distance),
            float(cfg.variable_density_max_distance),
            float(cfg.variable_size_maximum_factor),
            float(cfg.distance_map_quantization),
            1 if cfg.is_variable_density else 0,
            1 if strict else 0,
            ctypes.byref(handle),
            err,
            512,
        )
        if rc:
            raise MeshingException(err.value.decode())
        try:
            nv = native.lib.pg_mesh_nverts(handle)
            nt = native.lib.pg_mesh_ntris(handle)
            verts = np.zeros((nv, 2), dtype=np.float64)
            tris = np.zeros((nt, 3), dtype=np.int32)
            if nv:
                native.lib.pg_mesh_coords(handle, geom._dptr(verts))
            if nt:
                native.lib.pg_mesh_tris(handle, geom._i32ptr(tris))
        finally:
            native.lib.pg_mesh_free(handle)
        if nt == 0:
            raise MeshingException("Meshing produced no triangles")
        return TriMesh(vertices=verts, triangles=tris)


Mesher.Config.RELAXED = Mesher.Config(
    minimum_angle=5.0, maximum_size=0, variable_size_maximum_factor=1.0
)

# Re-exports for API parity with the reference mesh module.
Point = geom.Point
DistanceMap = geom.DistanceMap
