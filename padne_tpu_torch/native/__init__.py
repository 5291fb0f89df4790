"""ctypes loader for the native geometry/meshing core.

The shared library is built on demand from the C++ sources in ``src/``
(g++ only; no external dependencies).  A content hash of the sources is
embedded in the library filename so stale builds are detected and rebuilt
automatically.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import subprocess
import sys

_SRC_DIR = pathlib.Path(__file__).parent / "src"
_BUILD_DIR = pathlib.Path(__file__).parent / "build"

_SOURCES = ["pg_core.h", "pg_cdt.h", "pg_overlay.h", "pg_refine.h", "pg_api.cpp"]


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_SRC_DIR / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())   # flag changes also rebuild
    return h.hexdigest()[:16]


_FLAGS = [
    "-std=c++20",
    # -O3 measured 24% faster refinement than -O2 (1M-vertex CDT); no
    # -march=native: the cached .so must stay portable across machines
    # that share a checkout.
    "-O3",
    "-fPIC",
    "-shared",
    # std::thread for the solver set-up's row-parallel loops.
    "-pthread",
]


def _build(lib_path: pathlib.Path) -> None:
    _BUILD_DIR.mkdir(exist_ok=True)
    cmd = [
        "g++",
        *_FLAGS,
        "-o",
        str(lib_path),
        str(_SRC_DIR / "pg_api.cpp"),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"Failed to build native geometry library:\n{proc.stderr}"
        )


def _load() -> ctypes.CDLL:
    suffix = "dylib" if sys.platform == "darwin" else "so"
    lib_path = _BUILD_DIR / f"libpadne_torch_geom_{_source_hash()}.{suffix}"
    if not lib_path.exists():
        # Clean out stale builds.
        if _BUILD_DIR.exists():
            for old in _BUILD_DIR.glob(f"libpadne_torch_geom_*.{suffix}"):
                try:
                    old.unlink()
                except OSError:
                    pass
        _build(lib_path)
    return ctypes.CDLL(str(lib_path))


_lib = _load()

# --- signatures -----------------------------------------------------------
_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_int8_p = ctypes.POINTER(ctypes.c_int8)

_lib.pg_boolean.restype = ctypes.c_int
_lib.pg_boolean.argtypes = [
    ctypes.c_int,
    _c_double_p, _c_int32_p, ctypes.c_int32,
    _c_double_p, _c_int32_p, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_polyset_npolys.restype = ctypes.c_int32
_lib.pg_polyset_npolys.argtypes = [ctypes.c_void_p]
_lib.pg_polyset_nrings.restype = ctypes.c_int32
_lib.pg_polyset_nrings.argtypes = [ctypes.c_void_p, ctypes.c_int32]
_lib.pg_polyset_ring_size.restype = ctypes.c_int32
_lib.pg_polyset_ring_size.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
_lib.pg_polyset_ring_coords.restype = None
_lib.pg_polyset_ring_coords.argtypes = [
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, _c_double_p]
_lib.pg_polyset_free.restype = None
_lib.pg_polyset_free.argtypes = [ctypes.c_void_p]

_lib.pg_classify_build.restype = ctypes.c_int
_lib.pg_classify_build.argtypes = [
    _c_double_p, _c_int32_p, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_classify_query.restype = ctypes.c_int
_lib.pg_classify_query.argtypes = [
    ctypes.c_void_p, _c_double_p, ctypes.c_int32, _c_int8_p,
    ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_classify_handle_free.restype = None
_lib.pg_classify_handle_free.argtypes = [ctypes.c_void_p]

_lib.pg_classify_points.restype = ctypes.c_int
_lib.pg_classify_points.argtypes = [
    _c_double_p, _c_int32_p, ctypes.c_int32,
    _c_double_p, ctypes.c_int32, _c_int8_p, ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_distance_to_boundary.restype = ctypes.c_int
_lib.pg_distance_to_boundary.argtypes = [
    _c_double_p, _c_int32_p, ctypes.c_int32,
    _c_double_p, ctypes.c_int32, _c_double_p, ctypes.c_char_p, ctypes.c_int,
]

_lib.pg_distmap_build.restype = ctypes.c_int
_lib.pg_distmap_build.argtypes = [
    _c_double_p, _c_int32_p, ctypes.c_int32, ctypes.c_double,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_distmap_query.restype = None
_lib.pg_distmap_query.argtypes = [
    ctypes.c_void_p, _c_double_p, ctypes.c_int32, _c_double_p]
_lib.pg_distmap_info.restype = None
_lib.pg_distmap_info.argtypes = [ctypes.c_void_p, _c_double_p]
_lib.pg_distmap_free.restype = None
_lib.pg_distmap_free.argtypes = [ctypes.c_void_p]

_lib.pg_triangulate.restype = ctypes.c_int
_lib.pg_triangulate.argtypes = [
    _c_double_p, _c_int32_p, ctypes.c_int32,
    _c_double_p, ctypes.c_int32,
    ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int,
]
_lib.pg_mesh_nverts.restype = ctypes.c_int32
_lib.pg_mesh_nverts.argtypes = [ctypes.c_void_p]
_lib.pg_mesh_ntris.restype = ctypes.c_int32
_lib.pg_mesh_ntris.argtypes = [ctypes.c_void_p]
_lib.pg_mesh_coords.restype = None
_lib.pg_mesh_coords.argtypes = [ctypes.c_void_p, _c_double_p]
_lib.pg_mesh_tris.restype = None
_lib.pg_mesh_tris.argtypes = [ctypes.c_void_p, _c_int32_p]
_lib.pg_mesh_free.restype = None
_lib.pg_mesh_free.argtypes = [ctypes.c_void_p]

_lib.pg_greedy_aggregate.restype = ctypes.c_int32
_lib.pg_greedy_aggregate.argtypes = [_c_int32_p, _c_int32_p, ctypes.c_int32, _c_int32_p]

_lib.pg_greedy_aggregate_capped.restype = ctypes.c_int32
_lib.pg_greedy_aggregate_capped.argtypes = [
    _c_int32_p, _c_int32_p, ctypes.c_int32, ctypes.c_int32, _c_int32_p]

_c_int64_p = ctypes.POINTER(ctypes.c_int64)

_lib.pg_unique_edges.restype = ctypes.c_int
_lib.pg_unique_edges.argtypes = [
    _c_int32_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
    ctypes.c_char_p, ctypes.c_int]
_lib.pg_edges_count.restype = ctypes.c_int64
_lib.pg_edges_count.argtypes = [ctypes.c_void_p]
_lib.pg_edges_read.restype = None
_lib.pg_edges_read.argtypes = [ctypes.c_void_p, _c_int32_p, _c_int64_p]
_lib.pg_edges_free.restype = None
_lib.pg_edges_free.argtypes = [ctypes.c_void_p]

_lib.pg_build_ell.restype = ctypes.c_int
_lib.pg_build_ell.argtypes = [
    ctypes.c_int64, _c_int64_p, _c_int64_p, _c_double_p, ctypes.c_int64,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int]
_lib.pg_ell_k.restype = ctypes.c_int32
_lib.pg_ell_k.argtypes = [ctypes.c_void_p]
_lib.pg_ell_read.restype = None
_lib.pg_ell_read.argtypes = [ctypes.c_void_p, _c_int32_p, _c_double_p,
                             _c_double_p]
_lib.pg_ell_free.restype = None
_lib.pg_ell_free.argtypes = [ctypes.c_void_p]


def unique_edges(tris):
    """(edges (E, 2) int32 lo<hi sorted by packed key, inverse (3F,)
    int64) for (F, 3) int32 triangles — native twin of the numpy
    np.unique path in TriMesh._edge_data (~4x faster at millions of
    faces)."""
    import numpy as np

    tris = np.ascontiguousarray(tris, dtype=np.int32)
    nf = len(tris)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_unique_edges(
        tris.ctypes.data_as(_c_int32_p), nf, ctypes.byref(out), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    try:
        ecount = _lib.pg_edges_count(out)
        edges = np.empty((ecount, 2), dtype=np.int32)
        inverse = np.empty(3 * nf, dtype=np.int64)
        _lib.pg_edges_read(out, edges.ctypes.data_as(_c_int32_p),
                           inverse.ctypes.data_as(_c_int64_p))
        return edges, inverse
    finally:
        _lib.pg_edges_free(out)


def build_ell(n, eu, ev, w):
    """(cols (n, k) int32, vals (n, k) f64, diag (n,) f64) Laplacian ELL
    from undirected weighted edges — native twin of
    ops.assembly.build_ell's numpy path (~5x faster at millions of
    edges)."""
    import numpy as np

    eu = np.ascontiguousarray(eu, dtype=np.int64)
    ev = np.ascontiguousarray(ev, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_build_ell(
        int(n), eu.ctypes.data_as(_c_int64_p), ev.ctypes.data_as(_c_int64_p),
        w.ctypes.data_as(_c_double_p), len(eu), ctypes.byref(out), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    try:
        k = _lib.pg_ell_k(out)
        cols = np.empty((int(n), k), dtype=np.int32)
        vals = np.empty((int(n), k), dtype=np.float64)
        diag = np.empty(int(n), dtype=np.float64)
        _lib.pg_ell_read(out, cols.ctypes.data_as(_c_int32_p),
                         vals.ctypes.data_as(_c_double_p),
                         diag.ctypes.data_as(_c_double_p))
        return cols, vals, diag
    finally:
        _lib.pg_ell_free(out)


# --- threads of the solver set-up's loops ------------------------------

# Rows (entries, for a COO input) below which a set-up loop runs on the
# calling thread alone: starting threads costs more than it saves there.
# On an 8-core H100 host, row prefixes of the 1M-DoF board's top level
# (~7 nonzeros a row) ran as fast on 8 threads as on 1 at about 32k rows
# (strength filter, Galerkin product), 50k (DIA packing) and 70k (the
# permutation, which runs only on a DIA route's top level, 200,000 rows
# and up); its second level (159,590 rows) ran 2.8-4.5x faster on 8,
# and its third (27,098 rows) slower in the Galerkin product (0.74x).
MIN_PARALLEL_ROWS = 65_536


def _cgroup_cpu_quota() -> "float | None":
    """CPUs the cgroup's CPU quota allows (quota / period), None where
    no quota is set: cgroup v2's cpu.max, else v1's cfs files."""
    root = pathlib.Path("/sys/fs/cgroup")
    try:
        quota, period = (root / "cpu.max").read_text().split()[:2]
        return None if quota == "max" else int(quota) / int(period)
    except (OSError, ValueError):
        pass
    try:
        quota = int((root / "cpu" / "cpu.cfs_quota_us").read_text())
        period = int((root / "cpu" / "cpu.cfs_period_us").read_text())
        return quota / period if quota > 0 and period > 0 else None
    except (OSError, ValueError):
        return None


@functools.cache
def usable_cpus() -> int:
    """The CPUs this process may run on (its affinity), further limited
    by a cgroup CPU quota where one is set; read once."""
    cpus = len(os.sched_getaffinity(0))
    quota = _cgroup_cpu_quota()
    if quota is not None:
        cpus = min(cpus, max(1, math.ceil(quota)))
    return max(1, cpus)


def threads_for(rows: int, threads: "int | None" = None) -> int:
    """Threads a set-up loop over `rows` rows runs on: every usable CPU
    from MIN_PARALLEL_ROWS rows, one below; `threads` (tests) forces a
    count.  Every count gives the same bits."""
    if threads is None:
        threads = usable_cpus() if rows >= MIN_PARALLEL_ROWS else 1
    return max(1, int(threads))


_c_uint16_p = ctypes.POINTER(ctypes.c_uint16)

_lib.pg_pack_dia.restype = ctypes.c_int
_lib.pg_pack_dia.argtypes = [
    ctypes.c_int64, _c_int64_p, _c_int64_p, _c_double_p, ctypes.c_int64,
    ctypes.c_double, ctypes.c_int32, _c_int64_p, ctypes.c_int32,
    ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
    ctypes.c_int]
_lib.pg_hilbert_order.restype = ctypes.c_int
_lib.pg_hilbert_order.argtypes = [
    _c_double_p, ctypes.c_int64, ctypes.c_int32, _c_int64_p, _c_int64_p,
    ctypes.c_char_p, ctypes.c_int]

_lib.pg_strength_csr.restype = ctypes.c_int64
_lib.pg_strength_csr.argtypes = [
    ctypes.c_int64, _c_int32_p, _c_int32_p, _c_double_p, _c_double_p,
    ctypes.c_double, _c_int32_p, _c_int32_p, ctypes.c_int32]

_lib.pg_pack_dia_csr.restype = ctypes.c_int
_lib.pg_pack_dia_csr.argtypes = [
    ctypes.c_int64, _c_int32_p, _c_int32_p, _c_double_p, _c_int64_p,
    ctypes.c_int64, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p, ctypes.c_int]
_lib.pg_pack_dia_sizes.restype = None
_lib.pg_pack_dia_sizes.argtypes = [ctypes.c_void_p, _c_int64_p]
_lib.pg_pack_dia_read.restype = ctypes.c_int
_lib.pg_pack_dia_read.argtypes = [
    ctypes.c_void_p, _c_int64_p, _c_int32_p, _c_uint16_p, _c_double_p,
    _c_int32_p, _c_int32_p, _c_double_p, ctypes.c_char_p, ctypes.c_int]
_lib.pg_pack_dia_free.restype = None
_lib.pg_pack_dia_free.argtypes = [ctypes.c_void_p]


def _read_pack_dia(out):
    """The pack of a pg_pack_dia(_csr) handle into fresh arrays (the
    native side writes them: the handle's inputs must still be alive),
    and the handle freed."""
    import numpy as np

    try:
        sizes = np.zeros(3, dtype=np.int64)
        _lib.pg_pack_dia_sizes(out, sizes.ctypes.data_as(_c_int64_p))
        d, nm, nr = map(int, sizes)
        offs_out = np.empty(d, dtype=np.int64)
        hi = np.empty(nm, dtype=np.int32)
        lo = np.empty(nm, dtype=np.uint16)
        wv = np.empty(nm, dtype=np.float64)
        rr = np.empty(nr, dtype=np.int32)
        rcc = np.empty(nr, dtype=np.int32)
        rv = np.empty(nr, dtype=np.float64)
        err = ctypes.create_string_buffer(256)
        rc = _lib.pg_pack_dia_read(
            out, offs_out.ctypes.data_as(_c_int64_p),
            hi.ctypes.data_as(_c_int32_p), lo.ctypes.data_as(_c_uint16_p),
            wv.ctypes.data_as(_c_double_p), rr.ctypes.data_as(_c_int32_p),
            rcc.ctypes.data_as(_c_int32_p), rv.ctypes.data_as(_c_double_p),
            err, 256)
        if rc != 0:
            raise RuntimeError(err.value.decode())
        return tuple(int(o) for o in offs_out), hi, lo, wv, rr, rcc, rv
    finally:
        _lib.pg_pack_dia_free(out)


def pack_dia_csr(a, pos, b, coverage, max_offsets, threads=None):
    """Same outputs as pack_dia, fed directly from a scipy CSR matrix
    with row/col ids mapped through `pos` (padded positions) and
    diagonal entries skipped — the AMG hierarchy's per-level shape.
    Runs on threads_for(rows, threads) threads."""
    import numpy as np

    indptr = np.ascontiguousarray(a.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    data = np.ascontiguousarray(a.data, dtype=np.float64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_pack_dia_csr(
        a.shape[0], indptr.ctypes.data_as(_c_int32_p),
        indices.ctypes.data_as(_c_int32_p),
        data.ctypes.data_as(_c_double_p), pos.ctypes.data_as(_c_int64_p),
        int(b), float(coverage), int(max_offsets),
        threads_for(a.shape[0], threads), ctypes.byref(out), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return _read_pack_dia(out)


def pack_dia(b, rows, cols, vals, coverage, max_offsets, offs=None,
             threads=None):
    """(offs tuple, widx_hi int32, widx_lo uint16, wval f64,
    rem_rows/rem_cols int32, rem_vals f64) — native twin of
    ops.dia.pack_dia's COO split (offset selection + W-index
    composition + row-sorted remainder), on threads_for(entries,
    threads) threads."""
    import numpy as np

    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if offs is not None:
        offs_arr = np.ascontiguousarray(sorted(offs), dtype=np.int64)
        offs_p = offs_arr.ctypes.data_as(_c_int64_p)
        n_preset = len(offs_arr)
    else:
        offs_p = None
        n_preset = 0
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_pack_dia(
        int(b), rows.ctypes.data_as(_c_int64_p),
        cols.ctypes.data_as(_c_int64_p), vals.ctypes.data_as(_c_double_p),
        len(rows), float(coverage), int(max_offsets), offs_p, n_preset,
        threads_for(len(rows), threads), ctypes.byref(out), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return _read_pack_dia(out)


_lib.pg_ell_csr_nnz.restype = ctypes.c_int64
_lib.pg_ell_csr_nnz.argtypes = [ctypes.c_int64, ctypes.c_int32, _c_double_p]
_lib.pg_ell_to_csr.restype = ctypes.c_int
_lib.pg_ell_to_csr.argtypes = [
    ctypes.c_int64, ctypes.c_int32, _c_int32_p, _c_double_p, _c_double_p,
    _c_int32_p, _c_int32_p, _c_double_p, ctypes.c_char_p, ctypes.c_int]

_lib.pg_galerkin.restype = ctypes.c_int
_lib.pg_galerkin.argtypes = [
    ctypes.c_int64, _c_int32_p, _c_int32_p, _c_double_p, _c_int32_p,
    ctypes.c_int64, _c_double_p, ctypes.c_double, ctypes.c_double,
    ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
    ctypes.c_int]
_lib.pg_csr_sizes.restype = None
_lib.pg_csr_sizes.argtypes = [ctypes.c_void_p, _c_int64_p]
_lib.pg_csr_read.restype = None
_lib.pg_csr_read.argtypes = [ctypes.c_void_p, _c_int32_p, _c_int32_p,
                             _c_double_p]
_lib.pg_csr_free.restype = None
_lib.pg_csr_free.argtypes = [ctypes.c_void_p]


def ell_to_csr(cols, vals, diag):
    """(indptr int32, indices int32, data f64) CSR arrays from a padded
    ELL operator — native twin of assembly.EllMatrix.to_scipy (diagonal
    first in each row, padding slots dropped).  Two passes: an exact nnz
    count, then a fill into exact-size buffers (the numpy pipeline's
    ~10 temporaries cost seconds of first-touch page faults at 1M rows)."""
    import numpy as np

    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    diag = np.ascontiguousarray(diag, dtype=np.float64)
    n, k = cols.shape
    nnz = _lib.pg_ell_csr_nnz(n, k, vals.ctypes.data_as(_c_double_p))
    if nnz > 2**31 - 1:
        raise ValueError("ell_to_csr: nnz exceeds int32 index range")
    indptr = np.empty(n + 1, dtype=np.int32)
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_ell_to_csr(
        n, k, cols.ctypes.data_as(_c_int32_p),
        vals.ctypes.data_as(_c_double_p), diag.ctypes.data_as(_c_double_p),
        indptr.ctypes.data_as(_c_int32_p), indices.ctypes.data_as(_c_int32_p),
        data.ctypes.data_as(_c_double_p), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return indptr, indices, data


def galerkin(a, agg, nc, dinv, omega_p, drop_tol, threads=None):
    """Coarse operator Ac = P^T A P (scipy CSR in, scipy CSR out) with
    the smoothed prolongation P = P0 - omega_p diag(dinv) (A P0) built
    internally and the drop_tol sparsify+lump filter fused — native twin
    of the scipy chain in amg.build_hierarchy_dia.  Runs on
    threads_for(fine rows, threads) threads."""
    import numpy as np
    import scipy.sparse

    indptr = np.ascontiguousarray(a.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    data = np.ascontiguousarray(a.data, dtype=np.float64)
    agg = np.ascontiguousarray(agg, dtype=np.int32)
    dinv = np.ascontiguousarray(dinv, dtype=np.float64)
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_galerkin(
        a.shape[0], indptr.ctypes.data_as(_c_int32_p),
        indices.ctypes.data_as(_c_int32_p),
        data.ctypes.data_as(_c_double_p), agg.ctypes.data_as(_c_int32_p),
        int(nc), dinv.ctypes.data_as(_c_double_p), float(omega_p),
        float(drop_tol), threads_for(a.shape[0], threads),
        ctypes.byref(out), err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    try:
        sizes = np.zeros(2, dtype=np.int64)
        _lib.pg_csr_sizes(out, sizes.ctypes.data_as(_c_int64_p))
        nr, nnz = map(int, sizes)
        out_indptr = np.empty(nr + 1, dtype=np.int32)
        out_indices = np.empty(nnz, dtype=np.int32)
        out_data = np.empty(nnz, dtype=np.float64)
        _lib.pg_csr_read(out, out_indptr.ctypes.data_as(_c_int32_p),
                         out_indices.ctypes.data_as(_c_int32_p),
                         out_data.ctypes.data_as(_c_double_p))
        return scipy.sparse.csr_matrix(
            (out_data, out_indices, out_indptr), shape=(nr, nr))
    finally:
        _lib.pg_csr_free(out)


_lib.pg_csr_permute.restype = ctypes.c_int
_lib.pg_csr_permute.argtypes = [
    ctypes.c_int64, _c_int32_p, _c_int32_p, _c_double_p, _c_int64_p,
    _c_int32_p, _c_int32_p, _c_double_p, ctypes.c_int32, ctypes.c_char_p,
    ctypes.c_int]


def csr_permute(a, perm, threads=None):
    """A[perm][:, perm] as scipy CSR (perm: new index -> old index) —
    one counting + one gather pass (scipy's fancy-index chain runs two
    permutation-matrix SpGEMMs), on threads_for(rows, threads) threads.
    Columns ascend within each row."""
    import numpy as np
    import scipy.sparse

    n = a.shape[0]
    indptr = np.ascontiguousarray(a.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    data = np.ascontiguousarray(a.data, dtype=np.float64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    out_indptr = np.empty(n + 1, dtype=np.int32)
    out_indices = np.empty(len(indices), dtype=np.int32)
    out_data = np.empty(len(data), dtype=np.float64)
    err = ctypes.create_string_buffer(256)
    rc = _lib.pg_csr_permute(
        n, indptr.ctypes.data_as(_c_int32_p),
        indices.ctypes.data_as(_c_int32_p),
        data.ctypes.data_as(_c_double_p), perm.ctypes.data_as(_c_int64_p),
        out_indptr.ctypes.data_as(_c_int32_p),
        out_indices.ctypes.data_as(_c_int32_p),
        out_data.ctypes.data_as(_c_double_p), threads_for(n, threads),
        err, 256)
    if rc != 0:
        raise RuntimeError(err.value.decode())
    return scipy.sparse.csr_matrix(
        (out_data, out_indices, out_indptr), shape=(n, n))


def strength_csr(a, d, theta, threads=None):
    """(indptr, indices) int32 CSR pattern of a's strong off-diagonal
    entries, |a_ij| >= theta * sqrt(d_i d_j) (d: the positive-clamped
    diagonal), on threads_for(rows, threads) threads."""
    import numpy as np

    n = a.shape[0]
    indptr = np.ascontiguousarray(a.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    data = np.ascontiguousarray(a.data, dtype=np.float64)
    d = np.ascontiguousarray(d, dtype=np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int32)
    out_indices = np.empty(len(indices), dtype=np.int32)
    nnz = _lib.pg_strength_csr(
        n, indptr.ctypes.data_as(_c_int32_p),
        indices.ctypes.data_as(_c_int32_p), data.ctypes.data_as(_c_double_p),
        d.ctypes.data_as(_c_double_p), float(theta),
        out_indptr.ctypes.data_as(_c_int32_p),
        out_indices.ctypes.data_as(_c_int32_p), threads_for(n, threads))
    return out_indptr, out_indices[:nnz]


lib = _lib
