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
#include <memory>

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
// ---------------------------------------------------------------------------

namespace {

struct DiaPackHandle {
  std::vector<int64_t> offs;
  std::vector<int32_t> widx_hi;
  std::vector<uint16_t> widx_lo;
  std::vector<double> wval;
  std::vector<int32_t> rem_rows, rem_cols;
  std::vector<double> rem_vals;
};

}  // namespace

int pg_pack_dia(int64_t b, const int64_t* rows, const int64_t* cols,
                const double* vals, int64_t ne, double coverage,
                int32_t max_offsets, const int64_t* preset_offs,
                int32_t n_preset, void** out, char* err, int errlen) {
  try {
    auto h = std::make_unique<DiaPackHandle>();
    if (n_preset > 0) {
      h->offs.assign(preset_offs, preset_offs + n_preset);
      std::sort(h->offs.begin(), h->offs.end());
    } else if (ne == 0) {
      h->offs = {0};
    } else {
      int64_t bdmin = INT64_MAX, bdmax = INT64_MIN;
      for (int64_t e = 0; e < ne; e++) {
        int64_t bd = cols[e] / b - rows[e] / b;
        bdmin = std::min(bdmin, bd);
        bdmax = std::max(bdmax, bd);
      }
      std::vector<int64_t> cnt((size_t)(bdmax - bdmin + 1), 0);
      for (int64_t e = 0; e < ne; e++)
        cnt[(size_t)(cols[e] / b - rows[e] / b - bdmin)]++;
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
        if ((int32_t)h->offs.size() >= max_offsets) break;
        int64_t delta = d0 + bdmin;
        h->offs.push_back(delta);
        has_zero |= delta == 0;
        covered += cnt[(size_t)d0];
        if ((double)covered >= coverage * (double)ne) break;
      }
      if (!has_zero) h->offs.push_back(0);
      std::sort(h->offs.begin(), h->offs.end());
    }
    const int32_t d = (int32_t)h->offs.size();
    const int64_t omin = h->offs.front(), omax = h->offs.back();
    std::vector<int32_t> lut((size_t)(omax - omin + 1), -1);
    for (int32_t s = 0; s < d; s++) lut[(size_t)(h->offs[s] - omin)] = s;

    // Count main/remainder split for exact allocations.
    int64_t nmain = 0;
    for (int64_t e = 0; e < ne; e++) {
      int64_t bd = cols[e] / b - rows[e] / b;
      nmain += (bd >= omin && bd <= omax && lut[(size_t)(bd - omin)] >= 0);
    }
    h->widx_hi.reserve(nmain);
    h->widx_lo.reserve(nmain);
    h->wval.reserve(nmain);
    h->rem_rows.reserve(ne - nmain);
    h->rem_cols.reserve(ne - nmain);
    h->rem_vals.reserve(ne - nmain);
    for (int64_t e = 0; e < ne; e++) {
      const int64_t r = rows[e], c = cols[e];
      const int64_t rb = r / b, cb = c / b;
      const int64_t bd = cb - rb;
      const int32_t slot =
          (bd >= omin && bd <= omax) ? lut[(size_t)(bd - omin)] : -1;
      if (slot >= 0) {
        h->widx_hi.push_back((int32_t)((rb * d + slot) * b + (c - cb * b)));
        h->widx_lo.push_back((uint16_t)(r - rb * b));
        h->wval.push_back(vals[e]);
      } else {
        h->rem_rows.push_back((int32_t)r);
        h->rem_cols.push_back((int32_t)c);
        h->rem_vals.push_back(vals[e]);
      }
    }
    // Remainder sorted by row, stable (matches the numpy stable
    // argsort; rem_ell's bucketing depends on row grouping).
    const int64_t nr = (int64_t)h->rem_rows.size();
    std::vector<int64_t> order(nr);
    for (int64_t i = 0; i < nr; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
      return h->rem_rows[x] < h->rem_rows[y];
    });
    std::vector<int32_t> rr(nr), rc(nr);
    std::vector<double> rv(nr);
    for (int64_t i = 0; i < nr; i++) {
      rr[i] = h->rem_rows[order[i]];
      rc[i] = h->rem_cols[order[i]];
      rv[i] = h->rem_vals[order[i]];
    }
    h->rem_rows.swap(rr);
    h->rem_cols.swap(rc);
    h->rem_vals.swap(rv);
    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

// CSR front-end for pg_pack_dia: walks the CSR structure directly
// (diagonal entries skipped, row/col ids mapped through `pos`) instead
// of materializing permuted COO triplets in numpy first — the AMG
// hierarchy packs every level through this shape.
int pg_pack_dia_csr(int64_t n_rows, const int32_t* indptr,
                    const int32_t* indices, const double* data,
                    const int64_t* pos, int64_t b, double coverage,
                    int32_t max_offsets, void** out, char* err, int errlen) {
  try {
    int64_t ne = 0;
    for (int64_t i = 0; i < n_rows; i++)
      for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++)
        ne += indices[jj] != i;
    std::vector<int64_t> rows(ne), cols(ne);
    std::vector<double> vals(ne);
    int64_t o = 0;
    for (int64_t i = 0; i < n_rows; i++) {
      const int64_t ri = pos ? pos[i] : i;
      for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++) {
        const int32_t j = indices[jj];
        if (j == i) continue;
        rows[o] = ri;
        cols[o] = pos ? pos[j] : j;
        vals[o] = data[jj];
        o++;
      }
    }
    return pg_pack_dia(b, rows.data(), cols.data(), vals.data(), ne,
                       coverage, max_offsets, nullptr, 0, out, err, errlen);
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_pack_dia_sizes(void* h, int64_t* sizes) {
  DiaPackHandle* ph = (DiaPackHandle*)h;
  sizes[0] = (int64_t)ph->offs.size();
  sizes[1] = (int64_t)ph->widx_hi.size();
  sizes[2] = (int64_t)ph->rem_rows.size();
}

void pg_pack_dia_read(void* h, int64_t* offs, int32_t* widx_hi,
                      uint16_t* widx_lo, double* wval, int32_t* rem_rows,
                      int32_t* rem_cols, double* rem_vals) {
  DiaPackHandle* ph = (DiaPackHandle*)h;
  std::memcpy(offs, ph->offs.data(), ph->offs.size() * sizeof(int64_t));
  std::memcpy(widx_hi, ph->widx_hi.data(),
              ph->widx_hi.size() * sizeof(int32_t));
  std::memcpy(widx_lo, ph->widx_lo.data(),
              ph->widx_lo.size() * sizeof(uint16_t));
  std::memcpy(wval, ph->wval.data(), ph->wval.size() * sizeof(double));
  std::memcpy(rem_rows, ph->rem_rows.data(),
              ph->rem_rows.size() * sizeof(int32_t));
  std::memcpy(rem_cols, ph->rem_cols.data(),
              ph->rem_cols.size() * sizeof(int32_t));
  std::memcpy(rem_vals, ph->rem_vals.data(),
              ph->rem_vals.size() * sizeof(double));
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
// row-sorted already, so no sort is needed — one pass replaces the
// tocoo + boolean-mask + csr_matrix round trip.
// ---------------------------------------------------------------------------
int64_t pg_strength_csr(int64_t n, const int32_t* indptr,
                        const int32_t* indices, const double* data,
                        const double* d, double theta, int32_t* out_indptr,
                        int32_t* out_indices) {
  int64_t o = 0;
  out_indptr[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    const double di = d[i];
    for (int32_t jj = indptr[i]; jj < indptr[i + 1]; jj++) {
      const int32_t j = indices[jj];
      if (j == i) continue;
      const double a = data[jj] < 0 ? -data[jj] : data[jj];
      if (a >= theta * std::sqrt(di * d[j])) out_indices[o++] = j;
    }
    out_indptr[i + 1] = (int32_t)o;
  }
  return o;
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
// ---------------------------------------------------------------------------

namespace {

struct CsrHandle {
  int64_t n = 0;
  std::vector<int32_t> indptr, indices;
  std::vector<double> data;
};

}  // namespace

int pg_galerkin(int64_t n, const int32_t* indptr, const int32_t* indices,
                const double* data, const int32_t* agg, int64_t nc,
                const double* dinv, double omega_p, double drop_tol,
                void** out, char* err, int errlen) {
  try {
    auto h = std::make_unique<CsrHandle>();
    h->n = nc;
    const int64_t nnz_a = indptr[n];

    // P in CSR (n x nc).  omega_p == 0 degenerates to one entry per row
    // (the aggregation indicator).
    std::vector<int32_t> pptr(n + 1), pind;
    std::vector<double> pval;
    if (omega_p == 0.0) {
      pind.resize(n);
      pval.assign(n, 1.0);
      for (int64_t i = 0; i < n; i++) {
        pptr[i] = (int32_t)i;
        pind[i] = agg[i];
      }
      pptr[n] = (int32_t)n;
    } else {
      // Epoch-stamped accumulator over coarse columns: collapse the
      // per-row contributions {agg[i]: +1} + {agg[j]: -omega_p dinv_i
      // a_ij} (j runs over the FULL row, diagonal included — matching
      // A @ P0).
      std::vector<int32_t> stamp(nc, -1);
      std::vector<double> acc(nc, 0.0);
      std::vector<int32_t> touched;
      pind.reserve(nnz_a);  // upper bound: <= row degree + 1 per row
      pval.reserve(nnz_a);
      pptr[0] = 0;
      for (int64_t i = 0; i < n; i++) {
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
        for (int32_t J : touched) {
          if (acc[J] != 0.0) {
            pind.push_back(J);
            pval.push_back(acc[J]);
          }
        }
        pptr[i + 1] = (int32_t)pind.size();
      }
    }

    // P^T by counting sort (coarse-row-grouped (fine row, value) lists).
    const int64_t nnz_p = (int64_t)pind.size();
    std::vector<int32_t> tptr(nc + 1, 0);
    for (int64_t e = 0; e < nnz_p; e++) tptr[pind[e] + 1]++;
    for (int64_t I = 0; I < nc; I++) tptr[I + 1] += tptr[I];
    std::vector<int32_t> trow(nnz_p);
    std::vector<double> tval(nnz_p);
    {
      std::vector<int32_t> cur(tptr.begin(), tptr.end() - 1);
      for (int64_t i = 0; i < n; i++)
        for (int32_t e = pptr[i]; e < pptr[i + 1]; e++) {
          const int32_t o = cur[pind[e]]++;
          trow[o] = (int32_t)i;
          tval[o] = pval[e];
        }
    }

    // Ac row by row: Ac_I = sum_{(i, p) in PT_I} p * (A P)_i, expanding
    // (A P)_i on the fly (avoids materializing the B = A P intermediate;
    // P rows average ~2-3 entries so the recompute is cheap).
    std::vector<int32_t> stamp(nc, -1);
    std::vector<double> acc(nc, 0.0);
    std::vector<int32_t> touched;
    h->indptr.resize(nc + 1);
    h->indptr[0] = 0;
    h->indices.reserve(nnz_a / 2);
    h->data.reserve(nnz_a / 2);
    for (int64_t I = 0; I < nc; I++) {
      touched.clear();
      for (int32_t t = tptr[I]; t < tptr[I + 1]; t++) {
        const int32_t i = trow[t];
        const double p = tval[t];
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
      for (int32_t J : touched) {
        // Exact zeros are dropped (eliminate_zeros parity) EXCEPT the
        // diagonal when the drop filter runs — lumping needs a stored
        // diagonal slot in every row (a whole-component aggregate has
        // an exactly-zero Galerkin diagonal).
        if (acc[J] != 0.0 || (drop_tol > 0.0 && J == (int32_t)I)) {
          h->indices.push_back(J);
          h->data.push_back(acc[J]);
        }
      }
      if ((int64_t)h->indices.size() > INT32_MAX)
        throw GeomError("galerkin: coarse nnz exceeds int32 range");
      h->indptr[I + 1] = (int32_t)h->indices.size();
    }

    if (drop_tol > 0.0) {
      // Fused sparsify + lump (amg.build_hierarchy_dia drop_tol
      // semantics): needs the full coarse diagonal first, then one
      // in-place compaction pass.
      std::vector<double> dc(nc, 1.0);
      for (int64_t I = 0; I < nc; I++)
        for (int32_t e = h->indptr[I]; e < h->indptr[I + 1]; e++)
          if (h->indices[e] == (int32_t)I && h->data[e] > 0.0)
            dc[I] = h->data[e];
      int64_t o = 0;
      int32_t prev_end = h->indptr[0];
      for (int64_t I = 0; I < nc; I++) {
        double lump = 0.0;
        int64_t diag_at = -1;
        for (int32_t e = prev_end; e < h->indptr[I + 1]; e++) {
          const int32_t J = h->indices[e];
          const double v = h->data[e];
          if (J == (int32_t)I) {
            diag_at = o;
          } else if (std::abs(v) < drop_tol * std::sqrt(dc[I] * dc[J])) {
            lump += v;
            continue;
          }
          h->indices[o] = J;
          h->data[o] = v;
          o++;
        }
        if (lump != 0.0) {
          if (diag_at < 0)  // cannot happen: diagonals always emit
            throw GeomError("galerkin: missing diagonal slot");
          h->data[diag_at] += lump;
        }
        prev_end = h->indptr[I + 1];
        h->indptr[I + 1] = (int32_t)o;
      }
      h->indices.resize(o);
      h->data.resize(o);
    }

    *out = h.release();
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

void pg_csr_sizes(void* h, int64_t* sizes) {
  CsrHandle* ch = (CsrHandle*)h;
  sizes[0] = ch->n;
  sizes[1] = (int64_t)ch->indices.size();
}

void pg_csr_read(void* h, int32_t* indptr, int32_t* indices, double* data) {
  CsrHandle* ch = (CsrHandle*)h;
  std::memcpy(indptr, ch->indptr.data(), ch->indptr.size() * sizeof(int32_t));
  std::memcpy(indices, ch->indices.data(),
              ch->indices.size() * sizeof(int32_t));
  std::memcpy(data, ch->data.data(), ch->data.size() * sizeof(double));
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
                   double* out_data, char* err, int errlen) {
  try {
    std::vector<int32_t> inv(n);  // old -> new
    for (int64_t i = 0; i < n; i++) inv[perm[i]] = (int32_t)i;
    out_indptr[0] = 0;
    int64_t o = 0;
    for (int64_t i = 0; i < n; i++) {
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
    return 0;
  } catch (const std::exception& e) {
    return fail(e, err, errlen);
  }
}

}  // extern "C"
