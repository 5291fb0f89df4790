// Delaunay refinement (Ruppert/Chew) with variable-density sizing.
//
// Reproduces the behavior of the reference's CGAL-based mesher
// (_cgal.cpp:146-344, 461-489): triangles are "imperatively bad" when their
// longest edge exceeds a size bound interpolated from a boundary-distance
// map at the triangle centroid, and "bad" when sin^2 of their minimum angle
// falls below sin^2(minimum_angle).  Refinement splits encroached boundary
// segments first, then inserts (snapped) circumcenters of bad triangles,
// with concentric-shell splitting near acute input corners and minimum
// length guards for termination on degenerate inputs.
#pragma once

#include "pg_overlay.h"

#include <queue>

namespace pg {

constexpr double UNITS_PER_MM = 1e6;

// ---------------------------------------------------------------------------
// Boundary distance map (reference: PolyBoundaryDistanceMap,
// _cgal.cpp:492-589).  Grid of distance-to-boundary values at pixel centers
// over the polygon bbox + 2*quantization margin; 0 outside the polygon;
// bilinear interpolation on query.  All values in mm.
// ---------------------------------------------------------------------------
struct DistanceMap {
  double min_x = 0, min_y = 0, max_x = 0, max_y = 0;  // mm
  double quantization = 1.0;                          // mm
  int width = 0, height = 0;
  std::vector<double> d;

  double query(double x, double y) const {
    if (x < min_x || x > max_x || y < min_y || y > max_y) return 0.0;
    double gx = (x - min_x) / quantization;
    double gy = (y - min_y) / quantization;
    int i0 = (int)std::floor(gx), j0 = (int)std::floor(gy);
    int i1 = i0 + 1, j1 = j0 + 1;
    i0 = std::clamp(i0, 0, width - 1);
    i1 = std::clamp(i1, 0, width - 1);
    j0 = std::clamp(j0, 0, height - 1);
    j1 = std::clamp(j1, 0, height - 1);
    double fx = gx - std::floor(gx), fy = gy - std::floor(gy);
    double v00 = d[(size_t)j0 * width + i0], v10 = d[(size_t)j0 * width + i1];
    double v01 = d[(size_t)j1 * width + i0], v11 = d[(size_t)j1 * width + i1];
    double v0 = v00 * (1 - fx) + v10 * fx;
    double v1 = v01 * (1 - fx) + v11 * fx;
    return v0 * (1 - fy) + v1 * fy;
  }
};

// Build the map from polygon rings given in grid units (ring 0 exterior,
// others holes; even-odd fill).  Scanline parity for inside/outside plus a
// binned nearest-edge search for distances.
inline DistanceMap build_distance_map(const std::vector<Ring>& rings,
                                      double quantization_mm) {
  DistanceMap m;
  m.quantization = quantization_mm;
  if (rings.empty() || rings[0].pts.empty()) return m;
  double bx0 = 1e300, by0 = 1e300, bx1 = -1e300, by1 = -1e300;
  for (const Ring& r : rings)
    for (const Pt& p : r.pts) {
      double x = p.x / UNITS_PER_MM, y = p.y / UNITS_PER_MM;
      bx0 = std::min(bx0, x);
      by0 = std::min(by0, y);
      bx1 = std::max(bx1, x);
      by1 = std::max(by1, y);
    }
  double margin = 2 * quantization_mm;
  m.min_x = bx0 - margin;
  m.min_y = by0 - margin;
  m.max_x = bx1 + margin;
  m.max_y = by1 + margin;
  m.width = (int)std::ceil((m.max_x - m.min_x) / quantization_mm);
  m.height = (int)std::ceil((m.max_y - m.min_y) / quantization_mm);
  if (m.width <= 0 || m.height <= 0) return m;
  m.d.assign((size_t)m.width * m.height, 0.0);

  // Edge list in mm.
  struct E {
    double ax, ay, bx, by;
  };
  std::vector<E> edges;
  for (const Ring& r : rings) {
    size_t n = r.pts.size();
    for (size_t i = 0; i < n; i++) {
      const Pt& a = r.pts[i];
      const Pt& b = r.pts[(i + 1) % n];
      edges.push_back(E{a.x / UNITS_PER_MM, a.y / UNITS_PER_MM,
                        b.x / UNITS_PER_MM, b.y / UNITS_PER_MM});
    }
  }

  // Inside mask by scanline parity at pixel-center rows.
  std::vector<char> inside((size_t)m.width * m.height, 0);
  for (int j = 0; j < m.height; j++) {
    double yc = m.min_y + (j + 0.5) * quantization_mm;
    std::vector<double> xs;
    for (const E& e : edges) {
      double y0 = e.ay, y1 = e.by;
      if ((y0 <= yc) == (y1 <= yc)) continue;  // half-open rule
      double t = (yc - y0) / (y1 - y0);
      xs.push_back(e.ax + t * (e.bx - e.ax));
    }
    std::sort(xs.begin(), xs.end());
    // Parity fill.
    size_t k = 0;
    for (int i = 0; i < m.width; i++) {
      double xc = m.min_x + (i + 0.5) * quantization_mm;
      while (k < xs.size() && xs[k] <= xc) k++;
      if (k % 2 == 1) inside[(size_t)j * m.width + i] = 1;
    }
  }

  // Distances: bin edges into a coarse grid, expanding-ring search.
  double cell = quantization_mm;
  int gw = m.width, gh = m.height;
  std::vector<std::vector<int>> bins((size_t)gw * gh);
  auto bin_of = [&](double x, double y) {
    int i = std::clamp((int)((x - m.min_x) / cell), 0, gw - 1);
    int j = std::clamp((int)((y - m.min_y) / cell), 0, gh - 1);
    return std::make_pair(i, j);
  };
  for (size_t ei = 0; ei < edges.size(); ei++) {
    const E& e = edges[ei];
    auto [i0, j0] = bin_of(std::min(e.ax, e.bx), std::min(e.ay, e.by));
    auto [i1, j1] = bin_of(std::max(e.ax, e.bx), std::max(e.ay, e.by));
    for (int j = j0; j <= j1; j++)
      for (int i = i0; i <= i1; i++) bins[(size_t)j * gw + i].push_back((int)ei);
  }
  auto seg_dist = [](const E& e, double x, double y) {
    double dx = e.bx - e.ax, dy = e.by - e.ay;
    double len2 = dx * dx + dy * dy;
    double t = len2 > 0 ? ((x - e.ax) * dx + (y - e.ay) * dy) / len2 : 0.0;
    t = std::clamp(t, 0.0, 1.0);
    double px = e.ax + t * dx - x, py = e.ay + t * dy - y;
    return std::sqrt(px * px + py * py);
  };
  for (int j = 0; j < m.height; j++) {
    for (int i = 0; i < m.width; i++) {
      if (!inside[(size_t)j * m.width + i]) continue;
      double xc = m.min_x + (i + 0.5) * quantization_mm;
      double yc = m.min_y + (j + 0.5) * quantization_mm;
      double best = 1e300;
      for (int ring = 0; ring < std::max(gw, gh); ring++) {
        // Search ring of bins at Chebyshev radius `ring` around (i, j).
        bool any_bin = false;
        for (int dj = -ring; dj <= ring; dj++) {
          int jj = j + dj;
          if (jj < 0 || jj >= gh) continue;
          int step = (std::abs(dj) == ring) ? 1 : 2 * ring;
          if (step == 0) step = 1;
          for (int di = -ring; di <= ring; di += step) {
            int ii = i + di;
            if (ii < 0 || ii >= gw) continue;
            any_bin = true;
            for (int ei : bins[(size_t)jj * gw + ii])
              best = std::min(best, seg_dist(edges[ei], xc, yc));
          }
        }
        // Can any farther ring contain a closer edge?
        if (best < (ring)*cell) break;
        if (!any_bin && ring > std::max(gw, gh)) break;
      }
      m.d[(size_t)j * m.width + i] = (best >= 1e300) ? 0.0 : best;
    }
  }
  return m;
}

// ---------------------------------------------------------------------------
// Refinement
// ---------------------------------------------------------------------------
struct RefineConfig {
  double minimum_angle_deg = 20.0;
  double maximum_size_mm = 0.6;  // 0 disables the size criterion
  double vd_min_distance_mm = 0.5;
  double vd_max_distance_mm = 3.0;
  double vd_size_factor = 3.0;  // 1.0 disables variable density
  size_t max_vertices = 30'000'000;
};

class Refiner {
 public:
  CDT& cdt;
  const RefineConfig cfg;
  const DistanceMap* dmap;
  double sin2_bound;       // sin^2(minimum angle)
  double size_bound_u;     // base size bound in grid units
  // Minimum constrained-edge length we are willing to split (units).
  static constexpr double MIN_SEG_LEN = 16.0;

  // Vertices that are endpoints of >= 2 constraints meeting at < 60 deg
  // (concentric-shell split anchors, Shewchuk's terminator rule).
  std::unordered_set<int> acute_vertices;

  struct SegItem {
    int u, v;
  };
  std::deque<SegItem> seg_queue;

  struct TriItem {
    double size_key;  // >1 means size-violating; larger first
    double sine_key;  // smaller first
    int tri, v0, v1, v2;
    bool operator<(const TriItem& o) const {
      bool big = size_key > 1, obig = o.size_key > 1;
      if (big != obig) return !big;  // size-violating has priority
      if (big) return size_key < o.size_key;
      return sine_key > o.sine_key;
    }
  };
  std::priority_queue<TriItem> tri_queue;

  Refiner(CDT& c, const RefineConfig& config, const DistanceMap* dm)
      : cdt(c), cfg(config), dmap(dm) {
    double s = std::sin(cfg.minimum_angle_deg * M_PI / 180.0);
    sin2_bound = s * s;
    size_bound_u = cfg.maximum_size_mm * UNITS_PER_MM;
  }

  bool in_domain(int ti) const {
    return (size_t)ti < cdt.tri_wa.size() && cdt.tri_wa[ti] != 0;
  }

  double effective_size_u(double cx_u, double cy_u) const {
    if (size_bound_u <= 0) return 0.0;
    if (!dmap || cfg.vd_size_factor == 1.0) return size_bound_u;
    double dist_mm = dmap->query(cx_u / UNITS_PER_MM, cy_u / UNITS_PER_MM);
    double lo = cfg.vd_min_distance_mm, hi = cfg.vd_max_distance_mm;
    double f;
    if (dist_mm <= lo)
      f = 1.0;
    else if (dist_mm >= hi)
      f = cfg.vd_size_factor;
    else
      f = 1.0 + (dist_mm - lo) / (hi - lo) * (cfg.vd_size_factor - 1.0);
    return size_bound_u * f;
  }

  // Evaluate triangle quality; push onto queue if bad.
  void consider_triangle(int ti) {
    const CDT::Tri& t = cdt.tris[ti];
    if (!t.alive || !in_domain(ti)) return;
    Pt a = cdt.pt(t.v[0]), b = cdt.pt(t.v[1]), c = cdt.pt(t.v[2]);
    double l2ab = (double)dist2(a, b), l2bc = (double)dist2(b, c),
           l2ca = (double)dist2(c, a);
    double mx = std::max({l2ab, l2bc, l2ca});
    double mn = std::min({l2ab, l2bc, l2ca});
    double mid = l2ab + l2bc + l2ca - mx - mn;

    double size_key = 0.0;
    double cx = (a.x + b.x + c.x) / 3.0, cy = (a.y + b.y + c.y) / 3.0;
    double eff = effective_size_u(cx, cy);
    if (eff > 0) size_key = mx / (eff * eff);

    double area2 = std::abs((double)(b.x - a.x) * (c.y - a.y) -
                            (double)(b.y - a.y) * (c.x - a.x));
    double sine2 = (area2 * area2) / (mx * mid);

    if (size_key > 1.0) {
      tri_queue.push(TriItem{size_key, 1.0, ti, t.v[0], t.v[1], t.v[2]});
    } else if (sine2 < sin2_bound) {
      // Termination guard: ignore angle-bad triangles that are already tiny.
      if (mn < MIN_SEG_LEN * MIN_SEG_LEN * 4) return;
      tri_queue.push(TriItem{size_key, sine2, ti, t.v[0], t.v[1], t.v[2]});
    }
  }

  // A constrained edge is encroached iff an apex of an adjacent triangle
  // lies strictly inside its diametral circle.
  bool segment_encroached(int ti, int ei) const {
    const CDT::Tri& t = cdt.tris[ti];
    int a = t.v[(ei + 1) % 3], b = t.v[(ei + 2) % 3];
    Pt pa = cdt.pt(a), pb = cdt.pt(b);
    if (in_diametral_circle(pa, pb, cdt.pt(t.v[ei]))) return true;
    int n = t.nb[ei];
    if (n >= 0) {
      const CDT::Tri& tn = cdt.tris[n];
      int j = CDT::eidx(tn, a, b);
      if (j >= 0 && in_diametral_circle(pa, pb, cdt.pt(tn.v[j]))) return true;
    }
    return false;
  }

  void find_acute_vertices() {
    // Collect constrained edges per vertex.
    std::unordered_map<int, std::vector<int>> nbrs;
    for (size_t ti = 0; ti < cdt.tris.size(); ti++) {
      const CDT::Tri& t = cdt.tris[ti];
      if (!t.alive) continue;
      for (int i = 0; i < 3; i++) {
        if (!cdt.edge_constrained((int)ti, i)) continue;
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        if (a < b) {  // each undirected edge once (from one side it repeats;
                      // duplicates are harmless for the angle test)
          nbrs[a].push_back(b);
          nbrs[b].push_back(a);
        }
      }
    }
    for (auto& [v, around] : nbrs) {
      if (around.size() < 2) continue;
      Pt pv = cdt.pt(v);
      for (size_t i = 0; i < around.size() && !acute_vertices.count(v); i++)
        for (size_t j = i + 1; j < around.size(); j++) {
          Pt a = cdt.pt(around[i]), b = cdt.pt(around[j]);
          double ux = (double)(a.x - pv.x), uy = (double)(a.y - pv.y);
          double wx = (double)(b.x - pv.x), wy = (double)(b.y - pv.y);
          double dot = ux * wx + uy * wy;
          double cross = std::abs(ux * wy - uy * wx);
          if (dot > 0 && cross < dot * 1.7320508075688772) {  // angle < 60 deg
            acute_vertices.insert(v);
            break;
          }
        }
    }
  }

  // Split a constrained segment (possibly with concentric-shell position).
  void split_segment(int u, int v) {
    auto [ti, ei] = cdt.find_edge(u, v);
    if (ti < 0 || !cdt.edge_constrained(ti, ei)) return;  // stale
    Pt pu = cdt.pt(u), pv = cdt.pt(v);
    double len = dist(pu, pv);
    if (len < MIN_SEG_LEN * 2) return;  // refuse to split further
    if (cdt.num_vertices() >= (int)cfg.max_vertices)
      throw GeomError("refinement exceeded maximum vertex budget");

    double frac = 0.5;
    bool au = acute_vertices.count(u), av = acute_vertices.count(v);
    if (au != av) {
      // Shell split: distance from the acute endpoint rounded to a power
      // of two (in units) — Shewchuk's concentric-shell rule.
      double half = len / 2;
      double shell = std::pow(2.0, std::round(std::log2(half)));
      shell = std::clamp(shell, MIN_SEG_LEN, len - MIN_SEG_LEN);
      frac = au ? shell / len : 1.0 - shell / len;
    }
    // The snapped point usually lies a hair off the exact segment; the
    // forced-split primitive handles that.  Retry with different
    // fractions if a clean split is not possible.
    for (double f : {frac, 0.45, 0.55, 0.4, 0.6}) {
      Pt mid{(i64)llround(pu.x + f * (pv.x - pu.x)),
             (i64)llround(pu.y + f * (pv.y - pu.y))};
      if (mid == pu || mid == pv) continue;
      int vid = cdt.split_constrained_edge(ti, ei, mid);
      if (vid >= 0) {
        requeue_around(vid);
        return;
      }
      // Stale handles after a failed attempt are unlikely but cheap to
      // refresh.
      std::tie(ti, ei) = cdt.find_edge(u, v);
      if (ti < 0 || !cdt.edge_constrained(ti, ei)) return;
    }
  }

  // Re-examine the fan around a vertex: requeue bad triangles and check
  // constrained edges for encroachment.
  void requeue_around(int vid) {
    int t0 = cdt.vtri[vid];
    int cur = t0, guard = 0;
    do {
      if (++guard > (1 << 22)) throw GeomError("refine: fan overflow");
      const CDT::Tri& t = cdt.tris[cur];
      int i = CDT::vidx(t, vid);
      consider_triangle(cur);
      for (int k = 0; k < 3; k++) {
        if (cdt.edge_constrained(cur, k) && segment_encroached(cur, k))
          seg_queue.push_back(
              SegItem{t.v[(k + 1) % 3], t.v[(k + 2) % 3]});
      }
      cur = t.nb[(i + 2) % 3];
    } while (cur != t0 && cur >= 0);
  }

  // Insert a vertex, then re-examine the new triangles and their constrained
  // edges.  Returns the vertex id or -1 when nothing was inserted.
  int insert_and_requeue(Pt p, int hint) {
    if (cdt.num_vertices() >= (int)cfg.max_vertices)
      throw GeomError("refinement exceeded maximum vertex budget");
    int before = cdt.num_vertices();
    int vid = cdt.insert_point(p, hint);
    if (vid < before) return -1;  // duplicate of existing vertex
    requeue_fan(vid);
    return vid;
  }

  // Walk the fan around a freshly inserted vertex: requeue triangles
  // and check the opposite (cavity-boundary) constrained edges for
  // encroachment.
  void requeue_fan(int vid) {
    int t0 = cdt.vtri[vid];
    int cur = t0, guard = 0;
    do {
      if (++guard > (1 << 22)) throw GeomError("refine: fan overflow");
      const CDT::Tri& t = cdt.tris[cur];
      int i = CDT::vidx(t, vid);
      consider_triangle(cur);
      if (cdt.edge_constrained(cur, i) && segment_encroached(cur, i))
        seg_queue.push_back(SegItem{t.v[(i + 1) % 3], t.v[(i + 2) % 3]});
      // Also the edges incident to vid may be constrained (segment split):
      for (int k = 1; k <= 2; k++) {
        int e = (i + k) % 3;
        if (cdt.edge_constrained(cur, e) && segment_encroached(cur, e)) {
          seg_queue.push_back(
              SegItem{t.v[(e + 1) % 3], t.v[(e + 2) % 3]});
        }
      }
      cur = t.nb[(i + 2) % 3];
    } while (cur != t0 && cur >= 0);
  }

  // Ruppert's rule: a circumcenter that would encroach boundary segments
  // must not be inserted; split those segments instead.  Dry-run the
  // insertion cavity of `p` starting from `start` and collect encroached
  // constrained edges on its boundary.  (Superseded in the refinement
  // loop by CDT::insert_point_checked, which fuses this walk with the
  // insertion; kept for targeted testing.)
  std::vector<SegItem> encroached_by(Pt p, int start) const {
    std::vector<SegItem> result;
    CDT::Loc loc = cdt.locate(p, start);
    if (loc.kind == 2) return result;  // duplicate vertex; nothing to do
    // Dry-run cavity via the CDT's epoch-stamped scratch (a fresh hash
    // set here was ~25% of total mesher wall time; never nested with
    // the real insertion's cavity walk).
    cdt.cavity_begin();
    std::vector<int>& cavity = cdt.cav_list;
    cdt.cavity_push(loc.tri);
    if (loc.kind == 1 && !cdt.edge_constrained(loc.tri, loc.sub)) {
      int n = cdt.tris[loc.tri].nb[loc.sub];
      if (n >= 0) cdt.cavity_push(n);
    }
    for (size_t qi = 0; qi < cavity.size(); qi++) {
      int ti = cavity[qi];
      const CDT::Tri& t = cdt.tris[ti];
      for (int i = 0; i < 3; i++) {
        int n = t.nb[i];
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        if (cdt.edge_constrained(ti, i)) {
          if (in_diametral_circle(cdt.pt(a), cdt.pt(b), p))
            result.push_back(SegItem{a, b});
          continue;
        }
        if (n < 0 || cdt.cavity_has(n)) continue;
        const CDT::Tri& tn = cdt.tris[n];
        if (incircle(cdt.pt(tn.v[0]), cdt.pt(tn.v[1]), cdt.pt(tn.v[2]), p) > 0) {
          cdt.cavity_push(n);
        }
      }
    }
    return result;
  }

  // Walk from the centroid of triangle `ti` toward its circumcenter; stop
  // at the first constrained edge.  Returns (blocked_tri, blocked_edge) or
  // (-1, target_tri).
  struct WalkResult {
    bool blocked;
    int tri, ei;
  };
  WalkResult walk_to(Pt from_inside_tri, int start, Pt target) const {
    int cur = start;
    Pt a = from_inside_tri;
    int guard = 0;
    while (true) {
      if (++guard > (1 << 22)) throw GeomError("refine: walk overflow");
      const CDT::Tri& t = cdt.tris[cur];
      // Does `target` lie inside `cur`?
      bool inside = true;
      int exit_edge = -1;
      for (int i = 0; i < 3; i++) {
        Pt ea = cdt.pt(t.v[(i + 1) % 3]), eb = cdt.pt(t.v[(i + 2) % 3]);
        if (orient2d(ea, eb, target) < 0) {
          // target beyond this edge; does segment (a, target) cross it?
          if (orient2d(ea, eb, a) >= 0) {
            exit_edge = i;
            inside = false;
            // prefer an edge properly crossed by the walk segment
            if (proper_crossing(a, target, ea, eb)) break;
          }
        }
      }
      if (inside || exit_edge < 0) return WalkResult{false, cur, -1};
      if (cdt.edge_constrained(cur, exit_edge))
        return WalkResult{true, cur, exit_edge};
      int n = t.nb[exit_edge];
      if (n < 0) return WalkResult{true, cur, exit_edge};
      cur = n;
    }
  }

  void refine() {
    find_acute_vertices();
    // Initial scan.
    for (size_t ti = 0; ti < cdt.tris.size(); ti++) {
      const CDT::Tri& t = cdt.tris[ti];
      if (!t.alive) continue;
      bool dom = in_domain((int)ti);
      for (int i = 0; i < 3; i++) {
        if (!cdt.edge_constrained((int)ti, i)) continue;
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        if (a < b && dom && segment_encroached((int)ti, i))
          seg_queue.push_back(SegItem{a, b});
      }
      consider_triangle((int)ti);
    }

    while (true) {
      if (!seg_queue.empty()) {
        SegItem s = seg_queue.front();
        seg_queue.pop_front();
        split_segment(s.u, s.v);
        continue;
      }
      if (tri_queue.empty()) break;
      TriItem item = tri_queue.top();
      tri_queue.pop();
      // Validity: triangle still alive with the same vertices?
      if (item.tri >= (int)cdt.tris.size()) continue;
      const CDT::Tri& t = cdt.tris[item.tri];
      if (!t.alive || t.v[0] != item.v0 || t.v[1] != item.v1 ||
          t.v[2] != item.v2)
        continue;
      if (!in_domain(item.tri)) continue;

      // Circumcenter (in doubles; exactness is not needed for quality).
      Pt a = cdt.pt(t.v[0]), b = cdt.pt(t.v[1]), c = cdt.pt(t.v[2]);
      double d = 2.0 * ((double)(a.x) * (b.y - c.y) + (double)(b.x) * (c.y - a.y) +
                        (double)(c.x) * (a.y - b.y));
      if (d == 0) continue;
      double a2 = (double)a.x * a.x + (double)a.y * a.y;
      double b2 = (double)b.x * b.x + (double)b.y * b.y;
      double c2 = (double)c.x * c.x + (double)c.y * c.y;
      double ux = (a2 * (b.y - c.y) + b2 * (c.y - a.y) + c2 * (a.y - b.y)) / d;
      double uy = (a2 * (c.x - b.x) + b2 * (a.x - c.x) + c2 * (b.x - a.x)) / d;
      if (std::abs(ux) >= COORD_LIMIT || std::abs(uy) >= COORD_LIMIT) continue;
      Pt cc{(i64)llround(ux), (i64)llround(uy)};
      if (cc == a || cc == b || cc == c) continue;

      Pt centroid{(i64)llround((a.x + b.x + c.x) / 3.0),
                  (i64)llround((a.y + b.y + c.y) / 3.0)};
      WalkResult wr = walk_to(centroid, item.tri, cc);
      if (wr.blocked) {
        const CDT::Tri& bt = cdt.tris[wr.tri];
        int su = bt.v[(wr.ei + 1) % 3], sv = bt.v[(wr.ei + 2) % 3];
        Pt psu = cdt.pt(su), psv = cdt.pt(sv);
        if (dist(psu, psv) >= MIN_SEG_LEN * 2) {
          seg_queue.push_back(SegItem{su, sv});
          // Re-examine this triangle later.
          tri_queue.push(item);
        }
        continue;
      }
      // Ruppert's rule, fused with the insertion: the cavity walk that
      // would insert cc first checks its boundary's constrained edges;
      // on encroachment nothing is inserted (-2) and those segments
      // split instead.  One locate + one cavity walk instead of the
      // former dry-run + insert pair (~15% of mesher wall time).
      if (cdt.num_vertices() >= (int)cfg.max_vertices)
        throw GeomError("refinement exceeded maximum vertex budget");
      int before = cdt.num_vertices();
      int vid = cdt.insert_point_checked(cc, wr.tri, enc_scratch);
      if (vid == -2) {
        bool any_split = false;
        for (const auto& [su2, sv2] : enc_scratch) {
          if (dist(cdt.pt(su2), cdt.pt(sv2)) >= MIN_SEG_LEN * 2) {
            seg_queue.push_back(SegItem{su2, sv2});
            any_split = true;
          }
        }
        if (any_split) tri_queue.push(item);
        continue;
      }
      if (vid >= before) requeue_fan(vid);
    }
  }

  std::vector<std::pair<int, int>> enc_scratch;
};

// ---------------------------------------------------------------------------
// Full meshing pipeline: polygon rings (+ interior seed vertices) ->
// refined triangulation of the polygon interior.
// ---------------------------------------------------------------------------
struct MeshResult {
  std::vector<double> vx_mm, vy_mm;
  std::vector<int32_t> tri;  // 3 per triangle
};

inline MeshResult triangulate_polygon(const std::vector<Ring>& rings,
                                      const std::vector<Pt>& seeds,
                                      const RefineConfig& cfg,
                                      const DistanceMap* dmap,
                                      bool strict = true) {
  CDT cdt;
  cdt.allow_splitting = !strict;
  insert_operand(cdt, rings, 0);
  std::vector<int32_t> wa, wb;
  cdt.compute_windings(wa, wb);
  cdt.tri_wa.assign(cdt.tris.size(), 0);
  for (size_t i = 0; i < cdt.tris.size(); i++)
    if (cdt.tris[i].alive) cdt.tri_wa[i] = wa[i];
  cdt.track_winding = true;
  cdt.allow_splitting = true;  // refinement splits are always legitimate
  for (const Pt& s : seeds) cdt.insert_point(s);

  Refiner r(cdt, cfg, dmap);
  r.refine();

  // Export in-domain triangles with compacted vertex ids.
  MeshResult out;
  std::vector<int32_t> vmap(cdt.num_vertices(), -1);
  for (size_t ti = 0; ti < cdt.tris.size(); ti++) {
    const CDT::Tri& t = cdt.tris[ti];
    if (!t.alive || cdt.tri_wa[ti] == 0) continue;
    for (int i = 0; i < 3; i++) {
      int v = t.v[i];
      if (vmap[v] < 0) {
        vmap[v] = (int32_t)out.vx_mm.size();
        out.vx_mm.push_back(cdt.px[v] / UNITS_PER_MM);
        out.vy_mm.push_back(cdt.py[v] / UNITS_PER_MM);
      }
      out.tri.push_back(vmap[v]);
    }
  }
  return out;
}

}  // namespace pg
