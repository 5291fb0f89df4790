"""2D polygon geometry on an exact nanometer grid.

This module is the framework's replacement for shapely/GEOS (which the
reference uses throughout, e.g. kicad.py:1374-1391, solver.py:55-70): a
small, immutable Polygon/MultiPolygon API backed by the native core in
:mod:`native`.  All boolean operations are exact on an int64
nanometer grid (coordinates in mm at the API surface), implemented by
constrained-Delaunay overlay with winding-number classification.

Only the operations the PDN pipeline needs are provided: union /
difference / intersection, point classification, boundary distances, a
bbox query index, and ring access for meshing/export.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import cached_property
from typing import Iterable, Sequence, Union

import numpy as np

from . import native

_ERRLEN = 512


@dataclass(frozen=True)
class Point:
    x: float
    y: float

    def distance(self, other: "Point") -> float:
        return float(np.hypot(self.x - other.x, self.y - other.y))

    def __iter__(self):
        yield self.x
        yield self.y


def _as_ring_array(coords) -> np.ndarray:
    arr = np.asarray(coords, dtype=np.float64)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError("Ring coordinates must have shape (n, 2)")
    # Drop an explicitly repeated closing point.
    if len(arr) > 1 and np.array_equal(arr[0], arr[-1]):
        arr = arr[:-1]
    return arr


def _ring_signed_area(arr: np.ndarray) -> float:
    # Shoelace via two dots on views — the np.roll form allocates two
    # full copies per call and this runs once per ring on load (~6x).
    x, y = arr[:, 0], arr[:, 1]
    s = float(x[-1] * y[0] - x[0] * y[-1])
    s += float(x[:-1] @ y[1:] - x[1:] @ y[:-1])
    return 0.5 * s


def _pack_rings(rings: Sequence[np.ndarray]):
    """Flatten rings to (xy, sizes) ctypes-compatible buffers."""
    if not rings:
        empty = np.zeros((0,), dtype=np.float64)
        sizes = np.zeros((0,), dtype=np.int32)
        return empty, sizes
    xy = np.concatenate([r.reshape(-1) for r in rings]).astype(np.float64)
    sizes = np.array([len(r) for r in rings], dtype=np.int32)
    return np.ascontiguousarray(xy), np.ascontiguousarray(sizes)


class _RingClassifier:
    """Owns a parsed native point-classification handle: the rings are
    snapped to the nm grid and bounding-boxed ONCE at construction, so
    repeated point queries skip the per-call ring parsing that dominated
    seed placement on via-dense boards (thousands of hole rings x tens
    of thousands of single-point queries)."""

    __slots__ = ("_h",)

    def __init__(self, rings: Sequence[np.ndarray]):
        xy, sizes = _pack_rings(list(rings))
        out = ctypes.c_void_p()
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = native.lib.pg_classify_build(
            _dptr(xy), _i32ptr(sizes), len(sizes), ctypes.byref(out),
            err, _ERRLEN)
        if rc:
            raise GeometryError(err.value.decode())
        self._h = out

    def query(self, pts: np.ndarray) -> np.ndarray:
        """0 = outside, 1 = boundary, 2 = inside for each query point."""
        q = np.ascontiguousarray(np.asarray(pts, dtype=np.float64).reshape(-1))
        n = len(q) // 2
        result = np.zeros(n, dtype=np.int8)
        if n == 0:
            return result
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = native.lib.pg_classify_query(
            self._h, _dptr(q), n,
            result.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            err, _ERRLEN)
        if rc:
            raise GeometryError(err.value.decode())
        return result

    def __del__(self, _free=native.lib.pg_classify_handle_free):
        # _free bound at class-definition time: the `native` module may
        # already be torn down during interpreter shutdown.
        h = getattr(self, "_h", None)
        if h:
            _free(h)


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class GeometryError(RuntimeError):
    pass


class Polygon:
    """Immutable polygon with holes.  Ring 0 is the exterior (any
    orientation is accepted and normalized to CCW; holes to CW)."""

    __slots__ = ("_rings", "__dict__")

    def __init__(self, exterior, holes: Iterable = ()):  # coords in mm
        ext = _as_ring_array(exterior)
        if _ring_signed_area(ext) < 0:
            ext = ext[::-1].copy()
        rings = [ext]
        for h in holes:
            hr = _as_ring_array(h)
            if _ring_signed_area(hr) > 0:
                hr = hr[::-1].copy()
            rings.append(hr)
        self._rings = tuple(np.ascontiguousarray(r) for r in rings)

    @property
    def exterior(self) -> np.ndarray:
        return self._rings[0]

    @property
    def interiors(self) -> tuple[np.ndarray, ...]:
        return self._rings[1:]

    @property
    def rings(self) -> tuple[np.ndarray, ...]:
        return self._rings

    @cached_property
    def area(self) -> float:
        return float(sum(_ring_signed_area(r) for r in self._rings))

    @cached_property
    def bounds(self) -> tuple[float, float, float, float]:
        ext = self._rings[0]
        return (
            float(ext[:, 0].min()),
            float(ext[:, 1].min()),
            float(ext[:, 0].max()),
            float(ext[:, 1].max()),
        )

    @cached_property
    def _classifier(self) -> _RingClassifier:
        return _RingClassifier(self._rings)

    def _classify(self, pts: np.ndarray) -> np.ndarray:
        """0 = outside, 1 = boundary, 2 = inside for each query point."""
        return self._classifier.query(pts)

    def __getstate__(self):
        # Cached derived state (including the native classifier handle,
        # which cannot pickle) rebuilds lazily on demand.
        return self._rings

    def __setstate__(self, state):
        self._rings = state

    def contains(self, point: Point) -> bool:
        """Strict interior containment (boundary excluded)."""
        return int(self._classify(np.array([[point.x, point.y]]))[0]) == 2

    def intersects(self, point: Point) -> bool:
        """Closed containment (boundary included)."""
        return int(self._classify(np.array([[point.x, point.y]]))[0]) >= 1

    def classify_points(self, pts: np.ndarray) -> np.ndarray:
        return self._classify(pts)

    def distance_to_boundary(self, pts: np.ndarray) -> np.ndarray:
        xy, sizes = _pack_rings(list(self._rings))
        q = np.ascontiguousarray(np.asarray(pts, dtype=np.float64).reshape(-1))
        n = len(q) // 2
        out = np.zeros(n, dtype=np.float64)
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = native.lib.pg_distance_to_boundary(
            _dptr(xy), _i32ptr(sizes), len(sizes), _dptr(q), n, _dptr(out),
            err, _ERRLEN)
        if rc:
            raise GeometryError(err.value.decode())
        return out

    def representative_point(self) -> Point:
        """A point guaranteed strictly inside the polygon.

        Found by scanning horizontal lines through the interior: take the
        midpoint of the widest inside span on a line through the bbox
        middle (falling back to other heights if degenerate).
        """
        x0, y0, x1, y1 = self.bounds
        for frac in (0.5, 0.37, 0.63, 0.21, 0.79, 0.45, 0.55, 0.11, 0.89):
            yc = y0 + (y1 - y0) * frac
            xs = []
            for ring in self._rings:
                a = ring
                b = np.roll(ring, -1, axis=0)
                # edges crossing the horizontal line (half-open rule)
                crosses = (a[:, 1] <= yc) != (b[:, 1] <= yc)
                if not np.any(crosses):
                    continue
                aa, bb = a[crosses], b[crosses]
                t = (yc - aa[:, 1]) / (bb[:, 1] - aa[:, 1])
                xs.extend(aa[:, 0] + t * (bb[:, 0] - aa[:, 0]))
            if len(xs) < 2:
                continue
            xs = np.sort(np.asarray(xs))
            spans = xs[1::2] - xs[0::2]
            if len(spans) == 0:
                continue
            k = int(np.argmax(spans))
            if spans[k] <= 0:
                continue
            cand = Point(float((xs[2 * k] + xs[2 * k + 1]) / 2), float(yc))
            if self.contains(cand):
                return cand
        # Last resort: centroid of the largest-area triangle fan corner.
        raise GeometryError("Could not find a representative interior point")

    def __repr__(self) -> str:
        return f"Polygon({len(self.exterior)} pts, {len(self.interiors)} holes)"


class MultiPolygon:
    __slots__ = ("_geoms", "__dict__")

    def __init__(self, polygons: Iterable[Polygon]):
        self._geoms = tuple(polygons)

    @property
    def geoms(self) -> tuple[Polygon, ...]:
        return self._geoms

    @cached_property
    def area(self) -> float:
        return float(sum(p.area for p in self._geoms))

    @cached_property
    def bounds(self) -> tuple[float, float, float, float]:
        if not self._geoms:
            return (0.0, 0.0, 0.0, 0.0)
        bs = np.array([p.bounds for p in self._geoms])
        return (
            float(bs[:, 0].min()),
            float(bs[:, 1].min()),
            float(bs[:, 2].max()),
            float(bs[:, 3].max()),
        )

    @property
    def is_empty(self) -> bool:
        return len(self._geoms) == 0

    @cached_property
    def _classifier(self) -> _RingClassifier:
        return _RingClassifier(self.all_rings())

    def classify_points(self, pts: np.ndarray) -> np.ndarray:
        """Batched classification against the whole polygon set (native
        handle, parsed once): 0 outside, 1 on boundary, 2 inside."""
        return self._classifier.query(pts)

    def __getstate__(self):
        return self._geoms

    def __setstate__(self, state):
        self._geoms = state

    def intersects(self, point: Point) -> bool:
        return int(self.classify_points(np.array([[point.x, point.y]]))[0]) >= 1

    def contains(self, point: Point) -> bool:
        return int(self.classify_points(np.array([[point.x, point.y]]))[0]) == 2

    def all_rings(self) -> list[np.ndarray]:
        rings: list[np.ndarray] = []
        for p in self._geoms:
            rings.extend(p.rings)
        return rings

    def __repr__(self) -> str:
        return f"MultiPolygon({len(self._geoms)} polygons)"


Geometry = Union[Polygon, MultiPolygon]


def _gather_rings(geom_or_list) -> list[np.ndarray]:
    if isinstance(geom_or_list, Polygon):
        return list(geom_or_list.rings)
    if isinstance(geom_or_list, MultiPolygon):
        return geom_or_list.all_rings()
    rings: list[np.ndarray] = []
    for g in geom_or_list:
        rings.extend(_gather_rings(g))
    return rings


def _run_boolean(op: int, a_rings: list[np.ndarray],
                 b_rings: list[np.ndarray]) -> MultiPolygon:
    a_xy, a_sizes = _pack_rings(a_rings)
    b_xy, b_sizes = _pack_rings(b_rings)
    handle = ctypes.c_void_p()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = native.lib.pg_boolean(
        op, _dptr(a_xy), _i32ptr(a_sizes), len(a_sizes),
        _dptr(b_xy), _i32ptr(b_sizes), len(b_sizes),
        ctypes.byref(handle), err, _ERRLEN)
    if rc:
        raise GeometryError(err.value.decode())
    try:
        npolys = native.lib.pg_polyset_npolys(handle)
        polys = []
        for p in range(npolys):
            nrings = native.lib.pg_polyset_nrings(handle, p)
            rings = []
            for r in range(nrings):
                n = native.lib.pg_polyset_ring_size(handle, p, r)
                buf = np.zeros((n, 2), dtype=np.float64)
                native.lib.pg_polyset_ring_coords(handle, p, r, _dptr(buf))
                rings.append(buf)
            poly = Polygon.__new__(Polygon)
            # Native output is already CCW-outer / CW-holes; skip
            # re-normalization.
            poly._rings = tuple(np.ascontiguousarray(r) for r in rings)
            polys.append(poly)
        return MultiPolygon(polys)
    finally:
        native.lib.pg_polyset_free(handle)


def union_all(geoms) -> MultiPolygon:
    """Union of polygons/multipolygons (nonzero winding rule)."""
    return _run_boolean(0, _gather_rings(geoms), [])


def intersection(a, b) -> MultiPolygon:
    return _run_boolean(1, _gather_rings(a), _gather_rings(b))


def difference(a, b) -> MultiPolygon:
    return _run_boolean(2, _gather_rings(a), _gather_rings(b))


def _simplify_ring(ring: np.ndarray, tol: float) -> np.ndarray:
    """Iteratively drop vertices whose distance to the chord between their
    neighbors is below `tol` (plays the role of the reference's
    shapely simplify(1e-4) cleanup, kicad.py:1384-1391, removing
    snap-rounding noise such as nanometer-scale edges and near-collinear
    jitter)."""
    pts = ring
    for _ in range(16):  # passes until stable
        n = len(pts)
        if n <= 3:
            return pts
        prev = np.roll(pts, 1, axis=0)
        nxt = np.roll(pts, -1, axis=0)
        chord = nxt - prev
        rel = pts - prev
        chord_len = np.hypot(chord[:, 0], chord[:, 1])
        cross = np.abs(chord[:, 0] * rel[:, 1] - chord[:, 1] * rel[:, 0])
        dev = np.where(chord_len > 0, cross / np.maximum(chord_len, 1e-30),
                       np.hypot(rel[:, 0], rel[:, 1]))
        removable = dev < tol
        if not removable.any():
            return pts
        # Remove a maximal independent set (no two adjacent) to keep the
        # chord test valid within one pass.
        keep = np.ones(n, dtype=bool)
        last_removed = -2
        for i in range(n):
            if removable[i] and i - 1 != last_removed and keep.sum() > 3:
                keep[i] = False
                last_removed = i
        if keep.all():
            return pts
        pts = pts[keep]
    return pts


def simplify(geometry: Geometry, tolerance: float = 1e-4) -> "MultiPolygon":
    """Simplify all rings of a geometry; drops degenerate polygons."""
    mp = ensure_multipolygon(geometry)
    out = []
    for p in mp.geoms:
        ext = _simplify_ring(p.exterior, tolerance)
        if len(ext) < 3 or abs(_ring_signed_area(ext)) < tolerance**2:
            continue
        holes = []
        for h in p.interiors:
            hs = _simplify_ring(h, tolerance)
            if len(hs) >= 3 and abs(_ring_signed_area(hs)) >= tolerance**2:
                holes.append(hs)
        poly = Polygon.__new__(Polygon)
        poly._rings = tuple(
            np.ascontiguousarray(r) for r in [ext] + holes
        )
        out.append(poly)
    return MultiPolygon(out)


def ensure_multipolygon(geom: Geometry) -> MultiPolygon:
    if isinstance(geom, Polygon):
        return MultiPolygon([geom])
    if isinstance(geom, MultiPolygon):
        return geom
    raise ValueError(f"Expected Polygon or MultiPolygon, got {type(geom)}")


def buffer(geometry: Geometry, distance: float,
           cap_segments: int = 8) -> MultiPolygon:
    """Morphological offset (shapely buffer role, round joins).

    Positive distance dilates, negative erodes.  Built from the boolean
    engine: dilation = union(P, stroked boundary of width 2d);
    erosion = difference(P, stroked boundary of width 2|d|).
    """
    mp = ensure_multipolygon(geometry)
    if distance == 0 or mp.is_empty:
        return mp
    strokes: list[Polygon] = []
    for poly in mp.geoms:
        for ring in poly.rings:
            strokes.extend(stroke_ring(ring, 2 * abs(distance), cap_segments))
    if distance > 0:
        return union_all(list(mp.geoms) + strokes)
    return difference(mp, strokes)


def box(x0: float, y0: float, x1: float, y1: float) -> Polygon:
    return Polygon([(x0, y0), (x1, y0), (x1, y1), (x0, y1)])


def circle(cx: float, cy: float, radius: float, segments: int = 16) -> Polygon:
    """Regular-polygon approximation of a circle (CCW).

    Matches the reference's use of shapely ``buffer(r, quad_segs=4)`` for
    via shapes (kicad.py:814) when ``segments = 4 * quad_segs``.
    """
    th = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    pts = np.stack([cx + radius * np.cos(th), cy + radius * np.sin(th)], axis=1)
    return Polygon(pts)


def stroke_segment(x0: float, y0: float, x1: float, y1: float, width: float,
                   cap_segments: int = 8) -> Polygon:
    """Polygon of a stroked line segment with round caps (track copper)."""
    dx, dy = x1 - x0, y1 - y0
    length = float(np.hypot(dx, dy))
    r = width / 2
    if length < 1e-12:
        return circle(x0, y0, r, segments=max(8, 2 * cap_segments))
    a_dir = float(np.arctan2(dy, dx))
    pts = []
    # End cap: sweep from the right normal through the forward direction to
    # the left normal (CCW polygon, caps bulging outward).
    for i in range(cap_segments + 1):
        th = a_dir - np.pi / 2 + np.pi * i / cap_segments
        pts.append((x1 + r * np.cos(th), y1 + r * np.sin(th)))
    # Start cap: left normal through backward direction to right normal.
    for i in range(cap_segments + 1):
        th = a_dir + np.pi / 2 + np.pi * i / cap_segments
        pts.append((x0 + r * np.cos(th), y0 + r * np.sin(th)))
    return Polygon(pts)


def stroke_ring(ring: np.ndarray, width: float,
                cap_segments: int = 8) -> list[Polygon]:
    """Stroke every edge of a closed ring (outline drawing of zone fills)."""
    out = []
    n = len(ring)
    for i in range(n):
        x0, y0 = ring[i]
        x1, y1 = ring[(i + 1) % n]
        out.append(stroke_segment(x0, y0, x1, y1, width, cap_segments))
    return out


class BBoxIndex:
    """Bounding-box query index over a list of geometries.

    Plays the role of shapely's STRtree in the reference solver
    (solver.py:55-70): candidate prefiltering for point queries; exact
    predicates are applied by the caller.
    """

    def __init__(self, geoms: Sequence[Geometry]):
        self._geoms = list(geoms)
        if self._geoms:
            self._bounds = np.array([g.bounds for g in self._geoms])
        else:
            self._bounds = np.zeros((0, 4))

    def query_point(self, point: Point, pad: float = 1e-9) -> np.ndarray:
        """Indices of geometries whose bbox contains the point."""
        if len(self._geoms) == 0:
            return np.zeros(0, dtype=np.int64)
        b = self._bounds
        mask = (
            (b[:, 0] - pad <= point.x)
            & (point.x <= b[:, 2] + pad)
            & (b[:, 1] - pad <= point.y)
            & (point.y <= b[:, 3] + pad)
        )
        return np.nonzero(mask)[0]

    def query_points(self, pts: np.ndarray, pad: float = 1e-9):
        """Batched query_point: (point_idx, geom_idx) arrays for every
        bbox containment over (P, 2) query points.  One broadcast
        replaces P python-loop queries (the connectivity pre-pass on
        via-dense boards issues ~100k of them); chunked so the (P, G)
        mask stays bounded."""
        pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
        if len(self._geoms) == 0 or len(pts) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        b = self._bounds
        chunk = max(1, 20_000_000 // max(len(self._geoms), 1))
        pi_all, gi_all = [], []
        for at in range(0, len(pts), chunk):
            p = pts[at:at + chunk]
            m = (
                (b[None, :, 0] - pad <= p[:, 0, None])
                & (p[:, 0, None] <= b[None, :, 2] + pad)
                & (b[None, :, 1] - pad <= p[:, 1, None])
                & (p[:, 1, None] <= b[None, :, 3] + pad)
            )
            pi, gi = np.nonzero(m)
            pi_all.append(pi + at)
            gi_all.append(gi)
        return np.concatenate(pi_all), np.concatenate(gi_all)


class DistanceMap:
    """Quantized boundary-distance field with bilinear queries.

    API parity with the reference's PolyBoundaryDistanceMap
    (_cgal.cpp:492-589).
    """

    def __init__(self, polygon: Polygon, quantization: float):
        xy, sizes = _pack_rings(list(polygon.rings))
        handle = ctypes.c_void_p()
        err = ctypes.create_string_buffer(_ERRLEN)
        rc = native.lib.pg_distmap_build(
            _dptr(xy), _i32ptr(sizes), len(sizes), float(quantization),
            ctypes.byref(handle), err, _ERRLEN)
        if rc:
            raise GeometryError(err.value.decode())
        self._handle = handle
        info = np.zeros(7, dtype=np.float64)
        native.lib.pg_distmap_info(handle, _dptr(info))
        self.min_x, self.min_y, self.max_x, self.max_y = (
            float(info[0]), float(info[1]), float(info[2]), float(info[3]))
        self.quantization = float(info[4])
        self.width, self.height = int(info[5]), int(info[6])

    def query(self, x: float, y: float) -> float:
        return float(self.query_many(np.array([[x, y]]))[0])

    def query_many(self, pts: np.ndarray) -> np.ndarray:
        q = np.ascontiguousarray(np.asarray(pts, dtype=np.float64).reshape(-1))
        n = len(q) // 2
        out = np.zeros(n, dtype=np.float64)
        native.lib.pg_distmap_query(self._handle, _dptr(q), n, _dptr(out))
        return out

    def __del__(self):
        try:
            native.lib.pg_distmap_free(self._handle)
        except Exception:
            pass
