// C ABI for the padne_tpu native geometry/meshing core (loaded via ctypes).
//
// Conventions:
//  * all coordinates cross the boundary as double mm; internally everything
//    is snapped to the int64 nanometer grid;
//  * ring arrays are flat [x0,y0,x1,y1,...] with a parallel ring-size array
//    (number of points per ring, no duplicated closing point required —
//    a duplicate closing point is tolerated and dropped);
//  * results are returned via opaque handles + accessor functions;
//  * every entry point returns 0 on success, nonzero on failure with a
//    message in the provided error buffer.
#include "pg_refine.h"

#include <cstring>
#include <exception>
#include <memory>
#include <new>
#include <system_error>
#include <thread>
#include <type_traits>
#include <utility>
#include <variant>

using namespace pg;

namespace {

Pt snap(double x_mm, double y_mm) {
  double x = x_mm * UNITS_PER_MM, y = y_mm * UNITS_PER_MM;
  if (std::abs(x) >= (double)COORD_LIMIT || std::abs(y) >= (double)COORD_LIMIT)
    throw GeomError("coordinate out of supported range (|x| < 2.1e3 mm)");
  return Pt{(i64)llround(x), (i64)llround(y)};
}

std::vector<Ring> read_rings(const double* xy, const int32_t* sizes,
                             int32_t nrings) {
  std::vector<Ring> rings;
  rings.reserve(nrings);
  size_t off = 0;
  for (int32_t r = 0; r < nrings; r++) {
    Ring ring;
    int32_t n = sizes[r];
    ring.pts.reserve(n);
    for (int32_t i = 0; i < n; i++) {
      Pt p = snap(xy[2 * (off + i)], xy[2 * (off + i) + 1]);
      if (!ring.pts.empty() && ring.pts.back() == p) continue;  // dedupe
      ring.pts.push_back(p);
    }
    off += n;
    while (ring.pts.size() > 1 && ring.pts.front() == ring.pts.back())
      ring.pts.pop_back();
    if (ring.pts.size() >= 3) rings.push_back(std::move(ring));
  }
  return rings;
}

int fail(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.what(), errlen - 1);
    err[errlen - 1] = '\0';
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Row-block parallelism for the solver set-up's loops.  A loop over n
// independent rows splits into `nb` contiguous blocks, one thread each
// (block 0 on the calling thread).  Every output row is computed by the
// serial loop's own arithmetic in its own order; counts add up exactly
// and a block's output lands after its predecessors' (an exclusive
// prefix over block counts), so the result is bit-equal to the serial
// loop's for every thread count.  threads <= 1 runs serially.
// ---------------------------------------------------------------------------

int32_t block_count(int32_t threads, int64_t n) {
  return (int32_t)std::max<int64_t>(1, std::min<int64_t>(threads, n));
}

// fn(t, lo, hi) for t = 0..nb-1 over rows [n t / nb, n (t + 1) / nb).
// A block that throws has its exception rethrown once all have joined.
template <class F>
void run_blocks(int32_t nb, int64_t n, const F& fn) {
  if (nb <= 1) {
    fn(0, (int64_t)0, n);
    return;
  }
  std::vector<std::exception_ptr> errs(nb);
  auto one = [&](int32_t t) {
    try {
      fn(t, n * t / nb, n * (t + 1) / nb);
    } catch (...) {
      errs[t] = std::current_exception();
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(nb - 1);
  for (int32_t t = 1; t < nb; t++) {
    try {
      pool.emplace_back(one, t);
    } catch (const std::system_error&) {
      one(t);  // no thread to be had: the block runs here
    }
  }
  one(0);
  for (auto& th : pool) th.join();
  for (auto& e : errs)
    if (e) std::rethrow_exception(e);
}

// A std::vector whose resize() leaves new elements uninitialized, so
// the pages of a large output are first touched by the blocks that
// fill it, each on its own thread, and not zeroed serially before.
template <class T>
struct NoInitAlloc : std::allocator<T> {
  template <class U>
  struct rebind {
    using other = NoInitAlloc<U>;
  };
  NoInitAlloc() = default;
  template <class U>
  NoInitAlloc(const NoInitAlloc<U>&) noexcept {}
  template <class U>
  void construct(U* p) noexcept(std::is_nothrow_default_constructible_v<U>) {
    ::new (static_cast<void*>(p)) U;
  }
  template <class U, class... A>
  void construct(U* p, A&&... a) {
    ::new (static_cast<void*>(p)) U(std::forward<A>(a)...);
  }
};
template <class T>
using Buf = std::vector<T, NoInitAlloc<T>>;

// Exclusive prefix of per-block counts: (nb + 1) offsets.
std::vector<int64_t> block_offsets(const std::vector<int64_t>& counts) {
  std::vector<int64_t> off(counts.size() + 1, 0);
  for (size_t t = 0; t < counts.size(); t++) off[t + 1] = off[t] + counts[t];
  return off;
}

struct PolySetHandle {
  PolySet ps;
};

// Parsed ring set + per-ring bounding boxes for point classification.
// A ring can affect a point's classification only when p.y is within
// [ymin, ymax] and p.x <= xmax (the winding ray goes toward +x).
struct ClassifyHandle {
  struct BB {
    i64 x0, y0, x1, y1;
  };
  std::vector<Ring> rings;
  std::vector<BB> bbs;
};

void classify_prepare(ClassifyHandle& h, const double* xy,
                      const int32_t* sizes, int32_t nrings) {
  h.rings = read_rings(xy, sizes, nrings);
  h.bbs.resize(h.rings.size());
  for (size_t ri = 0; ri < h.rings.size(); ri++) {
    ClassifyHandle::BB bb{INT64_MAX, INT64_MAX, INT64_MIN, INT64_MIN};
    for (const Pt& q : h.rings[ri].pts) {
      bb.x0 = std::min(bb.x0, q.x);
      bb.y0 = std::min(bb.y0, q.y);
      bb.x1 = std::max(bb.x1, q.x);
      bb.y1 = std::max(bb.y1, q.y);
    }
    h.bbs[ri] = bb;
  }
}

int8_t classify_one(const ClassifyHandle& h, Pt p) {
  int winding = 0;
  bool boundary = false;
  for (size_t ri = 0; ri < h.rings.size() && !boundary; ri++) {
    const ClassifyHandle::BB& bb = h.bbs[ri];
    if (p.y < bb.y0 || p.y > bb.y1 || p.x > bb.x1) continue;
    const Ring& r = h.rings[ri];
    size_t n = r.pts.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& a = r.pts[i];
      const Pt& b = r.pts[(i + 1) % n];
      if (on_segment(a, b, p)) {
        boundary = true;
        break;
      }
      // Winding: signed crossings of the horizontal ray toward +x.
      if (a.y <= p.y) {
        if (b.y > p.y && orient2d(a, b, p) > 0) winding++;
      } else {
        if (b.y <= p.y && orient2d(a, b, p) < 0) winding--;
      }
    }
  }
  return boundary ? 1 : (winding != 0 ? 2 : 0);
}

struct MeshHandle {
  MeshResult mr;
};

struct DistMapHandle {
  DistanceMap dm;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Boolean operations.  op: 0=union, 1=intersection, 2=difference (A - B).
// ---------------------------------------------------------------------------
int pg_boolean(int op, const double* a_xy, const int32_t* a_sizes,
               int32_t a_nrings, const double* b_xy, const int32_t* b_sizes,
               int32_t b_nrings, void** out, char* err, int errlen) {
  try {
    std::vector<Ring> a = read_rings(a_xy, a_sizes, a_nrings);
    std::vector<Ring> b = read_rings(b_xy, b_sizes, b_nrings);
    auto h = std::make_unique<PolySetHandle>();
    h->ps = boolean_op((BoolOp)op, a, b);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

int32_t pg_polyset_npolys(void* h) {
  return (int32_t)((PolySetHandle*)h)->ps.polys.size();
}

int32_t pg_polyset_nrings(void* h, int32_t poly) {
  return (int32_t)((PolySetHandle*)h)->ps.polys[poly].rings.size();
}

int32_t pg_polyset_ring_size(void* h, int32_t poly, int32_t ring) {
  return (int32_t)((PolySetHandle*)h)->ps.polys[poly].rings[ring].pts.size();
}

void pg_polyset_ring_coords(void* h, int32_t poly, int32_t ring, double* out) {
  const Ring& r = ((PolySetHandle*)h)->ps.polys[poly].rings[ring];
  for (size_t i = 0; i < r.pts.size(); i++) {
    out[2 * i] = r.pts[i].x / UNITS_PER_MM;
    out[2 * i + 1] = r.pts[i].y / UNITS_PER_MM;
  }
}

void pg_polyset_free(void* h) { delete (PolySetHandle*)h; }

// ---------------------------------------------------------------------------
// Point-in-polygon classification (winding rule, exact).
// Classifies each query point against a ring set: 0 outside, 1 on boundary,
// 2 strictly inside.
// ---------------------------------------------------------------------------
int pg_classify_points(const double* xy, const int32_t* sizes, int32_t nrings,
                       const double* pts, int32_t npts, int8_t* result,
                       char* err, int errlen) {
  try {
    ClassifyHandle h;
    classify_prepare(h, xy, sizes, nrings);
    for (int32_t k = 0; k < npts; k++)
      result[k] = classify_one(h, snap(pts[2 * k], pts[2 * k + 1]));
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// Persistent variant: parse + bbox the rings ONCE (pg_classify_build),
// then answer point queries against the handle.  Point-in-polygon is
// the seed-placement/connectivity hot loop — via-dense boards issue
// tens of thousands of single-point queries against polygons with
// thousands of hole rings, and re-snapping every ring per query
// dominated meshing wall-clock (many_meshes_many_vias: 203 s -> <1 s).
int pg_classify_build(const double* xy, const int32_t* sizes, int32_t nrings,
                      void** out, char* err, int errlen) {
  try {
    auto h = std::make_unique<ClassifyHandle>();
    classify_prepare(*h, xy, sizes, nrings);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

int pg_classify_query(void* handle, const double* pts, int32_t npts,
                      int8_t* result, char* err, int errlen) {
  try {
    const ClassifyHandle& h = *(const ClassifyHandle*)handle;
    for (int32_t k = 0; k < npts; k++)
      result[k] = classify_one(h, snap(pts[2 * k], pts[2 * k + 1]));
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_classify_handle_free(void* h) { delete (ClassifyHandle*)h; }

// Minimum distance from each query point to the ring boundary (mm).
int pg_distance_to_boundary(const double* xy, const int32_t* sizes,
                            int32_t nrings, const double* pts, int32_t npts,
                            double* result, char* err, int errlen) {
  try {
    std::vector<Ring> rings = read_rings(xy, sizes, nrings);
    for (int32_t k = 0; k < npts; k++) {
      double px = pts[2 * k], py = pts[2 * k + 1];
      double best = 1e300;
      for (const Ring& r : rings) {
        size_t n = r.pts.size();
        for (size_t i = 0; i < n; i++) {
          double ax = r.pts[i].x / UNITS_PER_MM, ay = r.pts[i].y / UNITS_PER_MM;
          double bx = r.pts[(i + 1) % n].x / UNITS_PER_MM,
                 by = r.pts[(i + 1) % n].y / UNITS_PER_MM;
          double dx = bx - ax, dy = by - ay;
          double len2 = dx * dx + dy * dy;
          double t = len2 > 0 ? ((px - ax) * dx + (py - ay) * dy) / len2 : 0.0;
          t = std::clamp(t, 0.0, 1.0);
          double qx = ax + t * dx - px, qy = ay + t * dy - py;
          best = std::min(best, std::sqrt(qx * qx + qy * qy));
        }
      }
      result[k] = best;
    }
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// ---------------------------------------------------------------------------
// Distance map (reference PolyBoundaryDistanceMap parity).
// ---------------------------------------------------------------------------
int pg_distmap_build(const double* xy, const int32_t* sizes, int32_t nrings,
                     double quantization_mm, void** out, char* err,
                     int errlen) {
  try {
    std::vector<Ring> rings = read_rings(xy, sizes, nrings);
    auto h = std::make_unique<DistMapHandle>();
    h->dm = build_distance_map(rings, quantization_mm);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_distmap_query(void* h, const double* pts, int32_t npts, double* out) {
  const DistanceMap& dm = ((DistMapHandle*)h)->dm;
  for (int32_t k = 0; k < npts; k++)
    out[k] = dm.query(pts[2 * k], pts[2 * k + 1]);
}

void pg_distmap_info(void* h, double* info) {
  const DistanceMap& dm = ((DistMapHandle*)h)->dm;
  info[0] = dm.min_x;
  info[1] = dm.min_y;
  info[2] = dm.max_x;
  info[3] = dm.max_y;
  info[4] = dm.quantization;
  info[5] = dm.width;
  info[6] = dm.height;
}

void pg_distmap_free(void* h) { delete (DistMapHandle*)h; }

// ---------------------------------------------------------------------------
// Meshing.
// ---------------------------------------------------------------------------
int pg_triangulate(const double* xy, const int32_t* sizes, int32_t nrings,
                   const double* seeds, int32_t nseeds, double min_angle_deg,
                   double max_size_mm, double vd_min_dist_mm,
                   double vd_max_dist_mm, double vd_factor,
                   double quantization_mm, int use_distance_map, int strict,
                   void** out, char* err, int errlen) {
  try {
    std::vector<Ring> rings = read_rings(xy, sizes, nrings);
    if (rings.empty()) throw GeomError("triangulate: no valid rings");
    std::vector<Pt> seed_pts;
    for (int32_t i = 0; i < nseeds; i++)
      seed_pts.push_back(snap(seeds[2 * i], seeds[2 * i + 1]));

    RefineConfig cfg;
    cfg.minimum_angle_deg = min_angle_deg;
    cfg.maximum_size_mm = max_size_mm;
    cfg.vd_min_distance_mm = vd_min_dist_mm;
    cfg.vd_max_distance_mm = vd_max_dist_mm;
    cfg.vd_size_factor = vd_factor;

    DistanceMap dm;
    const DistanceMap* dmp = nullptr;
    if (use_distance_map && vd_factor != 1.0 && max_size_mm > 0) {
      dm = build_distance_map(rings, quantization_mm);
      dmp = &dm;
    }

    auto h = std::make_unique<MeshHandle>();
    h->mr = triangulate_polygon(rings, seed_pts, cfg, dmp, strict != 0);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

int32_t pg_mesh_nverts(void* h) {
  return (int32_t)((MeshHandle*)h)->mr.vx_mm.size();
}

int32_t pg_mesh_ntris(void* h) {
  return (int32_t)(((MeshHandle*)h)->mr.tri.size() / 3);
}

void pg_mesh_coords(void* h, double* out) {
  const MeshResult& mr = ((MeshHandle*)h)->mr;
  for (size_t i = 0; i < mr.vx_mm.size(); i++) {
    out[2 * i] = mr.vx_mm[i];
    out[2 * i + 1] = mr.vy_mm[i];
  }
}

void pg_mesh_tris(void* h, int32_t* out) {
  const MeshResult& mr = ((MeshHandle*)h)->mr;
  std::memcpy(out, mr.tri.data(), mr.tri.size() * sizeof(int32_t));
}

void pg_mesh_free(void* h) { delete (MeshHandle*)h; }

// ---------------------------------------------------------------------------
// Unique undirected mesh edges (FEM assembly hot loop).
// Input: (F, 3) CCW triangles.  Output handle: unique (lo < hi) edges
// sorted by packed key lo<<32|hi, plus the inverse map from the raw
// directed-edge slot (block-major [v0v1 | v1v2 | v2v0], matching
// TriMesh._edge_data) to its unique edge id.
// ---------------------------------------------------------------------------

namespace {

struct EdgesHandle {
  std::vector<int32_t> edges;    // (E, 2) flattened
  std::vector<int64_t> inverse;  // (3F,)
};

struct EllHandle {
  int64_t n = 0;
  int32_t k = 1;
  std::vector<int32_t> cols;  // (n, k) row-major; padding col = row
  std::vector<double> vals;   // (n, k); padding 0
  std::vector<double> diag;   // (n,)
};

}  // namespace

int pg_unique_edges(const int32_t* tris, int64_t nf, void** out, char* err,
                    int errlen) {
  try {
    auto h = std::make_unique<EdgesHandle>();
    const int64_t m = 3 * nf;
    std::vector<std::pair<int64_t, int64_t>> ki(m);
    for (int64_t f = 0; f < nf; f++) {
      for (int e = 0; e < 3; e++) {
        int64_t a = tris[3 * f + e], b = tris[3 * f + (e + 1) % 3];
        int64_t lo = a < b ? a : b, hi = a < b ? b : a;
        ki[e * nf + f] = {(lo << 32) | hi, e * nf + f};
      }
    }
    std::sort(ki.begin(), ki.end());
    h->inverse.resize(m);
    h->edges.reserve(m);  // upper bound; shrunk implicitly by usage
    int64_t prev_key = -1, id = -1;
    for (int64_t i = 0; i < m; i++) {
      if (ki[i].first != prev_key) {
        prev_key = ki[i].first;
        id++;
        h->edges.push_back((int32_t)(prev_key >> 32));
        h->edges.push_back((int32_t)(prev_key & 0xFFFFFFFF));
      }
      h->inverse[ki[i].second] = id;
    }
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

int64_t pg_edges_count(void* h) {
  return (int64_t)((EdgesHandle*)h)->edges.size() / 2;
}

void pg_edges_read(void* h, int32_t* edges, int64_t* inverse) {
  EdgesHandle* eh = (EdgesHandle*)h;
  std::memcpy(edges, eh->edges.data(), eh->edges.size() * sizeof(int32_t));
  std::memcpy(inverse, eh->inverse.data(),
              eh->inverse.size() * sizeof(int64_t));
}

void pg_edges_free(void* h) { delete (EdgesHandle*)h; }

// ---------------------------------------------------------------------------
// Graph-Laplacian ELL packing (FEM assembly hot loop).
// Semantics mirror ops.assembly.build_ell: zero-weight edges dropped,
// diag[i] = sum of incident weights, off-diagonals -w with duplicate
// (i, j) pairs accumulated, columns ascending within each row, padding
// slots (col=row, val=0), k = max deduplicated row degree (>= 1).
// ---------------------------------------------------------------------------
int pg_build_ell(int64_t n, const int64_t* eu, const int64_t* ev,
                 const double* w, int64_t ne, void** out, char* err,
                 int errlen) {
  try {
    auto h = std::make_unique<EllHandle>();
    h->n = n;
    h->diag.assign(n, 0.0);
    std::vector<int32_t> cnt(n, 0);
    for (int64_t e = 0; e < ne; e++) {
      if (w[e] == 0.0) continue;
      int64_t u = eu[e], v = ev[e];
      if (u < 0 || u >= n || v < 0 || v >= n)
        throw GeomError("build_ell: edge index out of range");
      h->diag[u] += w[e];
      h->diag[v] += w[e];
      cnt[u]++;
      cnt[v]++;
    }
    int32_t k0 = 1;
    for (int64_t i = 0; i < n; i++) k0 = std::max(k0, cnt[i]);
    // Scratch placement at pre-dedup width, then per-row sort + merge.
    std::vector<int32_t> scols((size_t)n * k0);
    std::vector<double> svals((size_t)n * k0);
    std::vector<int32_t> cur(n, 0);
    for (int64_t e = 0; e < ne; e++) {
      if (w[e] == 0.0) continue;
      int64_t u = eu[e], v = ev[e];
      size_t pu = (size_t)u * k0 + cur[u]++;
      scols[pu] = (int32_t)v;
      svals[pu] = -w[e];
      size_t pv = (size_t)v * k0 + cur[v]++;
      scols[pv] = (int32_t)u;
      svals[pv] = -w[e];
    }
    int32_t k = 1;
    for (int64_t i = 0; i < n; i++) {
      int32_t c = cur[i];
      int32_t* rc = &scols[(size_t)i * k0];
      double* rv = &svals[(size_t)i * k0];
      // Insertion sort by column (row degrees are small), stable so
      // duplicate accumulation order stays the input order.
      for (int32_t a = 1; a < c; a++) {
        int32_t ca = rc[a];
        double va = rv[a];
        int32_t b = a - 1;
        while (b >= 0 && rc[b] > ca) {
          rc[b + 1] = rc[b];
          rv[b + 1] = rv[b];
          b--;
        }
        rc[b + 1] = ca;
        rv[b + 1] = va;
      }
      // Merge duplicates in place.
      int32_t o = 0;
      for (int32_t a = 0; a < c; a++) {
        if (o > 0 && rc[o - 1] == rc[a]) {
          rv[o - 1] += rv[a];
        } else {
          rc[o] = rc[a];
          rv[o] = rv[a];
          o++;
        }
      }
      cur[i] = o;
      k = std::max(k, o);
    }
    h->k = k;
    h->cols.resize((size_t)n * k);
    h->vals.assign((size_t)n * k, 0.0);
    for (int64_t i = 0; i < n; i++) {
      int32_t c = cur[i];
      const int32_t* rc = &scols[(size_t)i * k0];
      const double* rv = &svals[(size_t)i * k0];
      int32_t* oc = &h->cols[(size_t)i * k];
      double* ov = &h->vals[(size_t)i * k];
      for (int32_t a = 0; a < c; a++) {
        oc[a] = rc[a];
        ov[a] = rv[a];
      }
      for (int32_t a = c; a < k; a++) oc[a] = (int32_t)i;  // padding
    }
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// ---------------------------------------------------------------------------
// Block-offset-DIA packing (solver-setup hot loop).  Mirrors
// ops.dia.pack_dia's COO path: greedy offset selection by block-delta
// histogram (coverage target, 0 always included), split W index
// (widx_hi = (rb*d + slot)*b + col_local, widx_lo = row_local), and the
// off-offset remainder as row-sorted triplets.  One C++ pass replaces
// ~15 nnz-sized numpy temporaries (first-touch page faults dominate at
// millions of entries on the CI host).
//
// Two calls: pg_pack_dia / pg_pack_dia_csr choose the offsets and count
// each block's main and remainder entries; pg_pack_dia_read, given the
// caller's buffers of the sizes pg_pack_dia_sizes reports, walks the
// entries again and writes them there (the remainder through one
// scratch copy for its sort).  The inputs must stay alive until the
// read.  Entries run by blocks of the source's units (COO entries or
// CSR rows), in the source's order.
// ---------------------------------------------------------------------------

extern "C++" {
namespace {

// COO triplets.
struct CooSource {
  const int64_t* rows;
  const int64_t* cols;
  const double* vals;
  int64_t ne;
  int64_t units() const { return ne; }
  template <class F>
  void each(int64_t lo, int64_t hi, F&& f) const {
    for (int64_t e = lo; e < hi; e++) f(rows[e], cols[e], vals[e]);
  }
};

// A CSR matrix's off-diagonal entries, row/column ids mapped through
// `pos` (padded positions) where given.
struct CsrSource {
  int64_t n_rows;
  const int32_t* indptr;
  const int32_t* indices;
  const double* data;
  const int64_t* pos;
  int64_t units() const { return n_rows; }
  template <class F>
  void each(int64_t lo, int64_t hi, F&& f) const {
    for (int64_t i = lo; i < hi; i++) {
      const int64_t ri = pos ? pos[i] : i;
      for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++) {
        const int32_t j = indices[jj];
        if (j == i) continue;
        f(ri, pos ? (int64_t)pos[j] : (int64_t)j, data[jj]);
      }
    }
  }
};

struct DiaPackHandle {
  std::variant<CooSource, CsrSource> src;
  int64_t b = 1;
  int sh = -1;  // log2(b) where b is a power of two
  int32_t nb = 1;
  std::vector<int64_t> offs;
  std::vector<int32_t> lut;  // block delta - offs.front() -> slot or -1
  std::vector<int64_t> moff, roff;  // per-block output offsets

  // Row/column block of an index: a shift where b is a power of two
  // (indices are >= 0, so the same as the division).
  int64_t blk(int64_t v) const { return sh >= 0 ? v >> sh : v / b; }
  int32_t slot(int64_t r, int64_t c) const {
    const int64_t k = blk(c) - blk(r) - offs.front();
    return (k >= 0 && k < (int64_t)lut.size()) ? lut[(size_t)k] : -1;
  }
};

template <class Src>
void pack_plan(DiaPackHandle& h, const Src& src, double coverage,
               int32_t max_offsets, const int64_t* preset_offs,
               int32_t n_preset, int32_t threads) {
  const int64_t units = src.units();
  const int32_t nb = h.nb = block_count(threads, units);
  std::vector<int64_t> ne_of(nb, 0);
  if (n_preset > 0) {
    h.offs.assign(preset_offs, preset_offs + n_preset);
    std::sort(h.offs.begin(), h.offs.end());
  } else {
    std::vector<int64_t> bmin(nb, INT64_MAX), bmax(nb, INT64_MIN);
    run_blocks(nb, units, [&](int32_t t, int64_t lo, int64_t hi) {
      int64_t mn = INT64_MAX, mx = INT64_MIN, k = 0;  // locals: no
      src.each(lo, hi, [&](int64_t r, int64_t c, double) {  // false sharing
        const int64_t bd = h.blk(c) - h.blk(r);
        mn = std::min(mn, bd);
        mx = std::max(mx, bd);
        k++;
      });
      bmin[t] = mn;
      bmax[t] = mx;
      ne_of[t] = k;
    });
    const int64_t ne = block_offsets(ne_of)[nb];
    if (ne == 0) {
      h.offs = {0};
    } else {
      const int64_t bdmin = *std::min_element(bmin.begin(), bmin.end());
      const int64_t bdmax = *std::max_element(bmax.begin(), bmax.end());
      // Block-delta histogram: one per block, summed (integers: exact).
      const size_t nbins = (size_t)(bdmax - bdmin + 1);
      std::vector<std::vector<int64_t>> hist(nb);
      run_blocks(nb, units, [&](int32_t t, int64_t lo, int64_t hi) {
        std::vector<int64_t> k(nbins, 0);
        src.each(lo, hi, [&](int64_t r, int64_t c, double) {
          k[(size_t)(h.blk(c) - h.blk(r) - bdmin)]++;
        });
        hist[t].swap(k);
      });
      std::vector<int64_t>& cnt = hist[0];
      for (int32_t t = 1; t < nb; t++)
        for (size_t k = 0; k < nbins; k++) cnt[k] += hist[t][k];
      std::vector<int64_t> present;
      for (int64_t d0 = 0; d0 < (int64_t)cnt.size(); d0++)
        if (cnt[d0]) present.push_back(d0);
      // Count-descending, delta-ascending on ties (deterministic).
      std::sort(present.begin(), present.end(), [&](int64_t x, int64_t y) {
        if (cnt[x] != cnt[y]) return cnt[x] > cnt[y];
        return x < y;
      });
      int64_t covered = 0;
      bool has_zero = false;
      for (int64_t d0 : present) {
        if ((int32_t)h.offs.size() >= max_offsets) break;
        int64_t delta = d0 + bdmin;
        h.offs.push_back(delta);
        has_zero |= delta == 0;
        covered += cnt[(size_t)d0];
        if ((double)covered >= coverage * (double)ne) break;
      }
      if (!has_zero) h.offs.push_back(0);
      std::sort(h.offs.begin(), h.offs.end());
    }
  }
  const int64_t omin = h.offs.front(), omax = h.offs.back();
  h.lut.assign((size_t)(omax - omin + 1), -1);
  for (int32_t s = 0; s < (int32_t)h.offs.size(); s++)
    h.lut[(size_t)(h.offs[s] - omin)] = s;

  // Each block's main/remainder counts and their exclusive prefixes.
  std::vector<int64_t> nmain(nb, 0), nrem(nb, 0);
  run_blocks(nb, units, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t m = 0, q = 0;
    src.each(lo, hi, [&](int64_t r, int64_t c, double) {
      if (h.slot(r, c) >= 0)
        m++;
      else
        q++;
    });
    nmain[t] = m;
    nrem[t] = q;
  });
  h.moff = block_offsets(nmain);
  h.roff = block_offsets(nrem);
}

template <class Src>
void pack_fill(const DiaPackHandle& h, const Src& src, int32_t* widx_hi,
               uint16_t* widx_lo, double* wval, int32_t* rem_rows,
               int32_t* rem_cols, double* rem_vals) {
  const int32_t nb = h.nb;
  const int64_t d = (int64_t)h.offs.size(), b = h.b;
  // Main entries in place, order kept; the remainder in walk order
  // first, then sorted by row, stable (matches the numpy stable
  // argsort; rem_ell's bucketing depends on row grouping).
  const int64_t nr = h.roff[nb];
  Buf<int32_t> rr(nr), rc(nr);
  Buf<double> rv(nr);
  run_blocks(nb, src.units(), [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t m = h.moff[t], q = h.roff[t];
    src.each(lo, hi, [&](int64_t r, int64_t c, double v) {
      const int32_t slot = h.slot(r, c);
      if (slot >= 0) {
        const int64_t rb = h.blk(r), cb = h.blk(c);
        widx_hi[m] = (int32_t)((rb * d + slot) * b + (c - cb * b));
        widx_lo[m] = (uint16_t)(r - rb * b);
        wval[m] = v;
        m++;
      } else {
        rr[q] = (int32_t)r;
        rc[q] = (int32_t)c;
        rv[q] = v;
        q++;
      }
    });
  });
  Buf<int64_t> order(nr);
  for (int64_t i = 0; i < nr; i++) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t x, int64_t y) { return rr[x] < rr[y]; });
  run_blocks(block_count(nb, nr / 65536), nr,
             [&](int32_t, int64_t lo, int64_t hi) {
               for (int64_t i = lo; i < hi; i++) {
                 rem_rows[i] = rr[order[i]];
                 rem_cols[i] = rc[order[i]];
                 rem_vals[i] = rv[order[i]];
               }
             });
}

template <class Src>
int pack_start(const Src& src, int64_t b, double coverage,
               int32_t max_offsets, const int64_t* preset_offs,
               int32_t n_preset, int32_t threads, void** out, char* err,
               int errlen) {
  try {
    auto h = std::make_unique<DiaPackHandle>();
    h->src = src;
    h->b = b;
    for (int k = 0; k < 62; k++)
      if (b == ((int64_t)1 << k)) h->sh = k;
    pack_plan(*h, src, coverage, max_offsets, preset_offs, n_preset,
              threads);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

}  // namespace
}  // extern "C++"

int pg_pack_dia(int64_t b, const int64_t* rows, const int64_t* cols,
                const double* vals, int64_t ne, double coverage,
                int32_t max_offsets, const int64_t* preset_offs,
                int32_t n_preset, int32_t threads, void** out, char* err,
                int errlen) {
  return pack_start(CooSource{rows, cols, vals, ne}, b, coverage,
                    max_offsets, preset_offs, n_preset, threads, out, err,
                    errlen);
}

// CSR front-end for pg_pack_dia: walks the CSR structure directly
// (diagonal entries skipped, row/col ids mapped through `pos`) instead
// of materializing permuted COO triplets — the AMG hierarchy packs
// every level through this shape.
int pg_pack_dia_csr(int64_t n_rows, const int32_t* indptr,
                    const int32_t* indices, const double* data,
                    const int64_t* pos, int64_t b, double coverage,
                    int32_t max_offsets, int32_t threads, void** out,
                    char* err, int errlen) {
  return pack_start(CsrSource{n_rows, indptr, indices, data, pos}, b,
                    coverage, max_offsets, nullptr, 0, threads, out, err,
                    errlen);
}

void pg_pack_dia_sizes(void* h, int64_t* sizes) {
  DiaPackHandle* ph = (DiaPackHandle*)h;
  sizes[0] = (int64_t)ph->offs.size();
  sizes[1] = ph->moff.back();
  sizes[2] = ph->roff.back();
}

int pg_pack_dia_read(void* h, int64_t* offs, int32_t* widx_hi,
                     uint16_t* widx_lo, double* wval, int32_t* rem_rows,
                     int32_t* rem_cols, double* rem_vals, char* err,
                     int errlen) {
  try {
    DiaPackHandle* ph = (DiaPackHandle*)h;
    std::memcpy(offs, ph->offs.data(), ph->offs.size() * sizeof(int64_t));
    std::visit(
        [&](const auto& src) {
          pack_fill(*ph, src, widx_hi, widx_lo, wval, rem_rows, rem_cols,
                    rem_vals);
        },
        ph->src);
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_pack_dia_free(void* h) { delete (DiaPackHandle*)h; }

int32_t pg_ell_k(void* h) { return ((EllHandle*)h)->k; }

void pg_ell_read(void* h, int32_t* cols, double* vals, double* diag) {
  EllHandle* eh = (EllHandle*)h;
  std::memcpy(cols, eh->cols.data(), eh->cols.size() * sizeof(int32_t));
  std::memcpy(vals, eh->vals.data(), eh->vals.size() * sizeof(double));
  std::memcpy(diag, eh->diag.data(), eh->diag.size() * sizeof(double));
}

void pg_ell_free(void* h) { delete (EllHandle*)h; }

// ---------------------------------------------------------------------------
// Hilbert-curve ordering of 2-D points (solver-setup hot loop).
// Mirrors ops.bell.hilbert_order: quantize to a 2^bits grid, compute
// the Hilbert distance, stable-sort by (group, distance) — group (the
// mesh/layer id) is the primary key so stacked layers stay contiguous.
// perm_out: new index -> old index.
// ---------------------------------------------------------------------------
int pg_hilbert_order(const double* xy, int64_t n, int32_t bits,
                     const int64_t* group, int64_t* perm_out, char* err,
                     int errlen) {
  try {
    if (n == 0) return 0;
    double lox = xy[0], loy = xy[1], hix = xy[0], hiy = xy[1];
    for (int64_t i = 0; i < n; i++) {
      lox = std::min(lox, xy[2 * i]);
      hix = std::max(hix, xy[2 * i]);
      loy = std::min(loy, xy[2 * i + 1]);
      hiy = std::max(hiy, xy[2 * i + 1]);
    }
    const double span = std::max(std::max(hix - lox, hiy - loy), 1e-30);
    const double scale = (double)((1LL << bits) - 1) / span;
    std::vector<std::pair<uint64_t, int64_t>> ki(n);
    for (int64_t i = 0; i < n; i++) {
      int64_t x = (int64_t)((xy[2 * i] - lox) * scale);
      int64_t y = (int64_t)((xy[2 * i + 1] - loy) * scale);
      uint64_t d = 0;
      for (int64_t s = 1LL << (bits - 1); s > 0; s >>= 1) {
        const int64_t rx = (x & s) > 0, ry = (y & s) > 0;
        d += (uint64_t)(s * s) * (uint64_t)((3 * rx) ^ ry);
        if (ry == 0) {               // rotate quadrant
          if (rx == 1) {
            x = s - 1 - x;
            y = s - 1 - y;
          }
          std::swap(x, y);
        }
      }
      const uint64_t g = group ? (uint64_t)group[i] : 0;
      ki[i] = {(g << 32) | d, i};
    }
    std::stable_sort(ki.begin(), ki.end(),
                     [](const auto& a, const auto& b) {
                       return a.first < b.first;
                     });
    for (int64_t i = 0; i < n; i++) perm_out[i] = ki[i].second;
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// ---------------------------------------------------------------------------
// Strength-of-connection filter (AMG setup hot loop): from a CSR
// operator, keep off-diagonal entries with |a_ij| >= theta *
// sqrt(d_i d_j) (d = positive-clamped diagonal, precomputed by the
// caller).  Writes a CSR pattern into caller-allocated buffers
// (out_indices sized >= input nnz) and returns the output nnz.  A is
// row-sorted already, so no sort is needed — a count and a fill pass
// by row blocks replace the tocoo + boolean-mask + csr_matrix round trip.
// ---------------------------------------------------------------------------
int64_t pg_strength_csr(int64_t n, const int32_t* indptr,
                        const int32_t* indices, const double* data,
                        const double* d, double theta, int32_t* out_indptr,
                        int32_t* out_indices, int32_t threads) {
  auto strong = [&](int64_t i, int32_t jj) {
    const int32_t j = indices[jj];
    if (j == i) return false;
    const double a = data[jj] < 0 ? -data[jj] : data[jj];
    return a >= theta * std::sqrt(d[i] * d[j]);
  };
  // Count by row blocks, an exclusive prefix, then the fill.
  const int32_t nb = block_count(threads, n);
  std::vector<int64_t> counts(nb, 0);
  run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t k = 0;
    for (int64_t i = lo; i < hi; i++)
      for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++)
        k += strong(i, jj);
    counts[t] = k;
  });
  const std::vector<int64_t> off = block_offsets(counts);
  out_indptr[0] = 0;
  run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t o = off[t];
    for (int64_t i = lo; i < hi; i++) {
      for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++)
        if (strong(i, jj)) out_indices[o++] = indices[jj];
      out_indptr[i + 1] = (int32_t)o;
    }
  });
  return off[nb];
}

// ---------------------------------------------------------------------------
// Greedy graph aggregation (AMG setup hot loop).
// Pass 1: seed aggregates where the whole strong neighborhood is free;
// pass 2: attach leftovers to a neighboring aggregate; pass 3: singletons.
// ---------------------------------------------------------------------------
int32_t pg_greedy_aggregate(const int32_t* indptr, const int32_t* indices,
                            int32_t n, int32_t* agg) {
  for (int32_t i = 0; i < n; i++) agg[i] = -1;
  int32_t num_agg = 0;
  for (int32_t i = 0; i < n; i++) {
    if (agg[i] >= 0) continue;
    bool all_free = indptr[i + 1] > indptr[i];
    for (int32_t k = indptr[i]; k < indptr[i + 1]; k++)
      if (agg[indices[k]] >= 0) {
        all_free = false;
        break;
      }
    if (all_free) {
      agg[i] = num_agg;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; k++)
        agg[indices[k]] = num_agg;
      num_agg++;
    }
  }
  for (int32_t i = 0; i < n; i++) {
    if (agg[i] >= 0) continue;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; k++)
      if (agg[indices[k]] >= 0) {
        agg[i] = agg[indices[k]];
        break;
      }
  }
  for (int32_t i = 0; i < n; i++)
    if (agg[i] < 0) agg[i] = num_agg++;
  return num_agg;
}

// Capped variant: no aggregate exceeds `cap` members.  Bounded sizes
// let the AMG transfer operators become pure reshapes on device
// (members padded to `cap` slots), eliminating gather/scatter from the
// V-cycle entirely.  Aggregate ids are assigned in input (sweep) order,
// so a locality-ordered input yields a locality-ordered coarse level.
int32_t pg_greedy_aggregate_capped(const int32_t* indptr,
                                   const int32_t* indices, int32_t n,
                                   int32_t cap, int32_t* agg) {
  if (cap < 1) cap = 1;
  for (int32_t i = 0; i < n; i++) agg[i] = -1;
  std::vector<int32_t> size;
  int32_t num_agg = 0;
  // Pass 1: seed where the whole strong neighborhood is free, taking at
  // most cap-1 neighbors.
  for (int32_t i = 0; i < n; i++) {
    if (agg[i] >= 0) continue;
    bool all_free = indptr[i + 1] > indptr[i];
    for (int32_t k = indptr[i]; k < indptr[i + 1]; k++)
      if (agg[indices[k]] >= 0) {
        all_free = false;
        break;
      }
    if (all_free) {
      agg[i] = num_agg;
      int32_t taken = 1;
      for (int32_t k = indptr[i]; k < indptr[i + 1] && taken < cap; k++) {
        agg[indices[k]] = num_agg;
        taken++;
      }
      size.push_back(taken);
      num_agg++;
    }
  }
  // Pass 2: attach leftovers to a neighboring aggregate with room.
  for (int32_t i = 0; i < n; i++) {
    if (agg[i] >= 0) continue;
    for (int32_t k = indptr[i]; k < indptr[i + 1]; k++) {
      int32_t a = agg[indices[k]];
      if (a >= 0 && size[a] < cap) {
        agg[i] = a;
        size[a]++;
        break;
      }
    }
  }
  // Pass 3: remaining nodes become singletons.
  for (int32_t i = 0; i < n; i++)
    if (agg[i] < 0) {
      agg[i] = num_agg++;
      size.push_back(1);
    }
  // Pass 4: merge undersized aggregates into an adjacent one with room,
  // iterated until a sweep makes no progress.  Larger mean aggregate
  // size -> less slot padding in the aligned AMG levels (fine rows are
  // padded to `cap` slots per aggregate) and faster coarsening.
  std::vector<int32_t> target(num_agg, -1);
  for (int sweep = 0; sweep < 4; sweep++) {
    bool merged = false;
    for (int32_t i = 0; i < n; i++) {
      int32_t a = agg[i];
      while (target[a] >= 0) a = target[a];
      if (size[a] * 2 > cap) continue;
      for (int32_t k = indptr[i]; k < indptr[i + 1]; k++) {
        int32_t b = agg[indices[k]];
        while (target[b] >= 0) b = target[b];
        if (b != a && size[a] + size[b] <= cap) {
          target[a] = b;
          size[b] += size[a];
          size[a] = 0;
          merged = true;
          break;
        }
      }
    }
    if (!merged) break;
  }
  // Compact ids.
  std::vector<int32_t> remap(num_agg, -1);
  int32_t out = 0;
  for (int32_t a = 0; a < num_agg; a++)
    if (target[a] < 0) remap[a] = out++;
  for (int32_t i = 0; i < n; i++) {
    int32_t a = agg[i];
    while (target[a] >= 0) a = target[a];
    agg[i] = remap[a];
  }
  return out;
}

// ---------------------------------------------------------------------------
// ELL -> CSR (solver-setup hot path).  Matches assembly.EllMatrix.to_scipy:
// per row the diagonal entry comes first, then the row's nonzero ELL slots
// in stored order (padding slots have val == 0 and are dropped).  Split
// into a count pass and a fill pass so the caller allocates exact-size
// numpy buffers once (no handle copy; first-touch page faults dominate
// allocation cost on the CI host).
// ---------------------------------------------------------------------------
int64_t pg_ell_csr_nnz(int64_t n, int32_t k, const double* vals) {
  int64_t nnz = n;  // one diagonal per row
  const int64_t total = n * (int64_t)k;
  for (int64_t e = 0; e < total; e++) nnz += vals[e] != 0.0;
  return nnz;
}

int pg_ell_to_csr(int64_t n, int32_t k, const int32_t* cols,
                  const double* vals, const double* diag,
                  int32_t* out_indptr, int32_t* out_indices,
                  double* out_data, char* err, int errlen) {
  try {
    int64_t o = 0;
    out_indptr[0] = 0;
    for (int64_t i = 0; i < n; i++) {
      out_indices[o] = (int32_t)i;
      out_data[o] = diag[i];
      o++;
      const int32_t* rc = cols + i * k;
      const double* rv = vals + i * k;
      for (int32_t s = 0; s < k; s++) {
        if (rv[s] != 0.0) {
          out_indices[o] = rc[s];
          out_data[o] = rv[s];
          o++;
        }
      }
      if (o > INT32_MAX)
        throw GeomError("ell_to_csr: nnz exceeds int32 indptr range");
      out_indptr[i + 1] = (int32_t)o;
    }
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// ---------------------------------------------------------------------------
// Smoothed-aggregation Galerkin coarse operator (AMG setup hot loop):
// Ac = P^T A P with P = P0 - omega_p * diag(dinv) (A P0), P0 the
// aggregation indicator (P0[i, agg[i]] = 1).  Replaces the scipy chain
// diags(dinv) @ (A @ P0) / transpose / csr_matmat (which allocates
// ~400 MB of intermediates at 1M DoF; first-touch page faults dominate).
// Exact zeros are skipped on emit (scipy eliminate_zeros parity) and the
// drop-tolerance filter runs fused: off-diagonals with
// |v| < drop_tol * sqrt(dc_i dc_j) are LUMPED into the diagonal, keeping
// row sums (the Neumann constant-vector kernel) exact.  Per-row columns
// emit in ascending order.
//
// Every pass runs by row blocks.  Memory is taken once, on the calling
// thread, and written in place: the blocks allocate and free nothing
// (each fresh page costs a fault, and page faults and unmaps do not run
// in parallel on every host).
// ---------------------------------------------------------------------------

namespace {

struct CsrHandle {
  int64_t n = 0;
  Buf<int32_t> indptr;  // (n + 1,) row offsets of the result
  // The result's entries, rows [lo_t, hi_t) of block t at base[t] on.
  Buf<int32_t> ind;
  Buf<double> val;
  std::vector<int64_t> base;
};

// ptr[i + 1] holds row i's entry count on entry and its end offset on
// return (ptr[0] = 0); returns the total.  Throws `what` past the int32
// index range.
int64_t prefix_rows(int32_t nb, int64_t n, int32_t* ptr, const char* what) {
  std::vector<int64_t> sums(nb, 0);
  run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t k = 0;
    for (int64_t i = lo; i < hi; i++) k += ptr[i + 1];
    sums[t] = k;
  });
  const std::vector<int64_t> off = block_offsets(sums);
  if (off[nb] > INT32_MAX) throw GeomError(what);
  ptr[0] = 0;
  run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
    int64_t o = off[t];
    for (int64_t i = lo; i < hi; i++) {
      o += ptr[i + 1];
      ptr[i + 1] = (int32_t)o;
    }
  });
  return off[nb];
}

}  // namespace

int pg_galerkin(int64_t n, const int32_t* indptr, const int32_t* indices,
                const double* data, const int32_t* agg, int64_t nc,
                const double* dinv, double omega_p, double drop_tol,
                int32_t threads, void** out, char* err, int errlen) {
  try {
    auto h = std::make_unique<CsrHandle>();
    h->n = nc;
    // Fine rows (P, P^T) and coarse rows (Ac, the drop filter) run by
    // row blocks.
    const int32_t nbf = block_count(threads, n);
    const int32_t nbc = block_count(threads, nc);
    // An epoch-stamped accumulator over coarse columns a block.
    const size_t nbm = (size_t)std::max(nbf, nbc);
    Buf<int32_t> stamps(nbm * nc);
    Buf<double> accs(nbm * nc);
    auto stamp_of = [&](int32_t t) {
      int32_t* stamp = stamps.data() + (size_t)t * nc;
      std::fill(stamp, stamp + nc, -1);
      return stamp;
    };

    // P in CSR (n x nc).  omega_p == 0 degenerates to one entry per row
    // (the aggregation indicator).
    Buf<int32_t> pptr(n + 1), pind;
    Buf<double> pval;
    if (omega_p == 0.0) {
      pind.resize(n);
      pval.assign(n, 1.0);
      for (int64_t i = 0; i < n; i++) {
        pptr[i] = (int32_t)i;
        pind[i] = agg[i];
      }
      pptr[n] = (int32_t)n;
    } else {
      // Row i of P into (stamp, acc) over `touched`, sorted: the
      // per-row contributions {agg[i]: +1} + {agg[j]: -omega_p dinv_i
      // a_ij} (j runs over the FULL row, diagonal included — matching
      // A @ P0).  Run twice, the same arithmetic each time: to count
      // the row's nonzeros, then to write them at its offset.
      auto p_row = [&](int64_t i, int32_t* stamp, double* acc,
                       std::vector<int32_t>& touched) {
        touched.clear();
        const double w = -omega_p * dinv[i];
        const int32_t ai = agg[i];
        stamp[ai] = (int32_t)i;
        acc[ai] = 1.0;
        touched.push_back(ai);
        for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++) {
          const int32_t J = agg[indices[jj]];
          if (stamp[J] != (int32_t)i) {
            stamp[J] = (int32_t)i;
            acc[J] = 0.0;
            touched.push_back(J);
          }
          acc[J] += w * data[jj];
        }
        std::sort(touched.begin(), touched.end());
      };
      run_blocks(nbf, n, [&](int32_t t, int64_t lo, int64_t hi) {
        int32_t* stamp = stamp_of(t);
        double* acc = accs.data() + (size_t)t * nc;
        std::vector<int32_t> touched;
        for (int64_t i = lo; i < hi; i++) {
          p_row(i, stamp, acc, touched);
          int32_t k = 0;
          for (int32_t J : touched) k += acc[J] != 0.0;
          pptr[i + 1] = k;
        }
      });
      const int64_t nnz_p =
          prefix_rows(nbf, n, pptr.data(),
                      "galerkin: prolongation nnz exceeds int32 range");
      pind.resize(nnz_p);
      pval.resize(nnz_p);
      run_blocks(nbf, n, [&](int32_t t, int64_t lo, int64_t hi) {
        int32_t* stamp = stamp_of(t);
        double* acc = accs.data() + (size_t)t * nc;
        std::vector<int32_t> touched;
        for (int64_t i = lo; i < hi; i++) {
          p_row(i, stamp, acc, touched);
          int32_t o = pptr[i];
          for (int32_t J : touched) {
            if (acc[J] != 0.0) {
              pind[o] = J;
              pval[o] = acc[J];
              o++;
            }
          }
        }
      });
    }

    // P^T by counting sort (coarse-row-grouped (fine row, value) lists,
    // fine rows ascending in each): a histogram per fine-row block, then
    // block t's cursor in coarse row I starts after the entries of
    // blocks < t, so the fill keeps the serial sort's order.
    const int64_t nnz_p = pptr[n];
    Buf<int32_t> curs((size_t)nbf * nc);
    run_blocks(nbf, n, [&](int32_t t, int64_t lo, int64_t hi) {
      int32_t* cur = curs.data() + (size_t)t * nc;
      std::fill(cur, cur + nc, 0);
      for (int32_t e = pptr[lo]; e < pptr[hi]; e++) cur[pind[e]]++;
    });
    std::vector<int32_t> tptr(nc + 1, 0);
    for (int64_t I = 0; I < nc; I++) {
      int32_t o = tptr[I];
      for (int32_t t = 0; t < nbf; t++) {
        int32_t& c = curs[(size_t)t * nc + I];
        const int32_t k = c;
        c = o;
        o += k;
      }
      tptr[I + 1] = o;
    }
    Buf<int32_t> trow(nnz_p);
    Buf<double> tval(nnz_p);
    run_blocks(nbf, n, [&](int32_t t, int64_t lo, int64_t hi) {
      int32_t* cur = curs.data() + (size_t)t * nc;
      for (int64_t i = lo; i < hi; i++)
        for (int32_t e = pptr[i]; e < pptr[i + 1]; e++) {
          const int32_t o = cur[pind[e]]++;
          trow[o] = (int32_t)i;
          tval[o] = pval[e];
        }
    });

    // Room for Ac: coarse row I makes at most min(nc, sum over its fine
    // rows i of sum over A_i's columns j of |P_j|) entries; each block
    // writes its rows one after another from its own base.  Only the
    // pages written are touched.
    Buf<int32_t> wrow(n);
    run_blocks(nbf, n, [&](int32_t, int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; i++) {
        int32_t k = 0;
        for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++)
          k += pptr[indices[jj] + 1] - pptr[indices[jj]];
        wrow[i] = k;
      }
    });
    std::vector<int64_t> room(nbc, 0);
    run_blocks(nbc, nc, [&](int32_t t, int64_t lo, int64_t hi) {
      int64_t k = 0;
      for (int64_t I = lo; I < hi; I++) {
        int64_t u = 0;
        for (int32_t q = tptr[I]; q < tptr[I + 1]; q++) u += wrow[trow[q]];
        k += std::min<int64_t>(u, nc);
      }
      room[t] = k;
    });
    h->base = block_offsets(room);
    h->ind.resize(h->base[nbc]);
    h->val.resize(h->base[nbc]);
    h->indptr.resize(nc + 1);

    // Ac row by row: Ac_I = sum_{(i, p) in PT_I} p * (A P)_i, expanding
    // (A P)_i on the fly (avoids materializing the B = A P intermediate;
    // P rows average ~2-3 entries so the recompute is cheap).
    run_blocks(nbc, nc, [&](int32_t t, int64_t lo, int64_t hi) {
      int32_t* stamp = stamp_of(t);
      double* acc = accs.data() + (size_t)t * nc;
      std::vector<int32_t> touched;
      int64_t o = h->base[t];
      for (int64_t I = lo; I < hi; I++) {
        touched.clear();
        for (int32_t q = tptr[I]; q < tptr[I + 1]; q++) {
          const int32_t i = trow[q];
          const double p = tval[q];
          for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++) {
            const double w = p * data[jj];
            const int32_t j = indices[jj];
            for (int32_t e = pptr[j]; e < pptr[j + 1]; e++) {
              const int32_t J = pind[e];
              if (stamp[J] != (int32_t)I) {
                stamp[J] = (int32_t)I;
                acc[J] = 0.0;
                touched.push_back(J);
              }
              acc[J] += w * pval[e];
            }
          }
        }
        std::sort(touched.begin(), touched.end());
        const int64_t start = o;
        for (int32_t J : touched) {
          // Exact zeros are dropped (eliminate_zeros parity) EXCEPT the
          // diagonal when the drop filter runs — lumping needs a stored
          // diagonal slot in every row (a whole-component aggregate has
          // an exactly-zero Galerkin diagonal).
          if (acc[J] != 0.0 || (drop_tol > 0.0 && J == (int32_t)I)) {
            h->ind[o] = J;
            h->val[o] = acc[J];
            o++;
          }
        }
        h->indptr[I + 1] = (int32_t)(o - start);
      }
    });

    if (drop_tol > 0.0) {
      // Fused sparsify + lump (amg.build_hierarchy_dia drop_tol
      // semantics): needs the full coarse diagonal first, then one
      // compaction pass, in place in each block's rows.
      Buf<double> dc(nc);
      run_blocks(nbc, nc, [&](int32_t t, int64_t lo, int64_t hi) {
        int64_t r = h->base[t];
        for (int64_t I = lo; I < hi; I++) {
          dc[I] = 1.0;
          for (int32_t k = 0; k < h->indptr[I + 1]; k++)
            if (h->ind[r + k] == (int32_t)I && h->val[r + k] > 0.0)
              dc[I] = h->val[r + k];
          r += h->indptr[I + 1];
        }
      });
      run_blocks(nbc, nc, [&](int32_t t, int64_t lo, int64_t hi) {
        int64_t r = h->base[t], o = r;  // read, write: o <= r
        for (int64_t I = lo; I < hi; I++) {
          double lump = 0.0;
          int64_t diag_at = -1;
          const int64_t start = o, end = r + h->indptr[I + 1];
          for (; r < end; r++) {
            const int32_t J = h->ind[r];
            const double v = h->val[r];
            if (J == (int32_t)I) {
              diag_at = o;
            } else if (std::abs(v) < drop_tol * std::sqrt(dc[I] * dc[J])) {
              lump += v;
              continue;
            }
            h->ind[o] = J;
            h->val[o] = v;
            o++;
          }
          if (lump != 0.0) {
            if (diag_at < 0)  // cannot happen: diagonals always emit
              throw GeomError("galerkin: missing diagonal slot");
            h->val[diag_at] += lump;
          }
          h->indptr[I + 1] = (int32_t)(o - start);
        }
      });
    }
    prefix_rows(nbc, nc, h->indptr.data(),
                "galerkin: coarse nnz exceeds int32 range");

    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_csr_sizes(void* h, int64_t* sizes) {
  CsrHandle* ch = (CsrHandle*)h;
  sizes[0] = ch->n;
  sizes[1] = ch->indptr[ch->n];
}

// The result into caller buffers: block t's rows from ind[base[t]] on,
// one copy a block.
void pg_csr_read(void* h, int32_t* indptr, int32_t* indices, double* data) {
  CsrHandle* ch = (CsrHandle*)h;
  const int64_t n = ch->n;
  std::memcpy(indptr, ch->indptr.data(), (n + 1) * sizeof(int32_t));
  const int32_t nb = (int32_t)ch->base.size() - 1;
  run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
    const int64_t a = ch->indptr[lo], k = ch->indptr[hi] - a;
    std::memcpy(indices + a, ch->ind.data() + ch->base[t],
                k * sizeof(int32_t));
    std::memcpy(data + a, ch->val.data() + ch->base[t], k * sizeof(double));
  });
}

void pg_csr_free(void* h) { delete (CsrHandle*)h; }

// ---------------------------------------------------------------------------
// Symmetric CSR permutation: out = A[perm][:, perm] (perm: new -> old).
// scipy implements fancy-index row selection as a permutation-matrix
// SpGEMM; this is one counting pass + one gather pass into exact-size
// caller buffers.  Columns re-sort per row (small row degrees ->
// insertion sort).
// ---------------------------------------------------------------------------
int pg_csr_permute(int64_t n, const int32_t* indptr, const int32_t* indices,
                   const double* data, const int64_t* perm,
                   int32_t* out_indptr, int32_t* out_indices,
                   double* out_data, int32_t threads, char* err,
                   int errlen) {
  try {
    const int32_t nb = block_count(threads, n);
    Buf<int32_t> inv(n);  // old -> new
    run_blocks(nb, n, [&](int32_t, int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; i++) inv[perm[i]] = (int32_t)i;
    });
    // Output rows by blocks: per-block entry counts, their prefix, then
    // each block fills its rows.
    std::vector<int64_t> counts(nb, 0);
    run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
      int64_t k = 0;
      for (int64_t i = lo; i < hi; i++)
        k += indptr[perm[i] + 1] - indptr[perm[i]];
      counts[t] = k;
    });
    const std::vector<int64_t> off = block_offsets(counts);
    out_indptr[0] = 0;
    run_blocks(nb, n, [&](int32_t t, int64_t lo, int64_t hi) {
      int64_t o = off[t];
      for (int64_t i = lo; i < hi; i++) {
        const int64_t old = perm[i];
        const int64_t start = o;
        for (int32_t jj = indptr[old]; jj < indptr[old + 1]; jj++) {
          out_indices[o] = inv[indices[jj]];
          out_data[o] = data[jj];
          o++;
        }
        // Insertion sort by column (row degrees are small).
        for (int64_t a = start + 1; a < o; a++) {
          const int32_t ca = out_indices[a];
          const double va = out_data[a];
          int64_t b = a - 1;
          while (b >= start && out_indices[b] > ca) {
            out_indices[b + 1] = out_indices[b];
            out_data[b + 1] = out_data[b];
            b--;
          }
          out_indices[b + 1] = ca;
          out_data[b + 1] = va;
        }
        out_indptr[i + 1] = (int32_t)o;
      }
    });
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

}  // extern "C"
