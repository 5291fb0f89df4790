// Boolean overlay: polygon set operations via CDT + winding classification.
//
// Both operands' ring edges are inserted as constraints carrying winding
// deltas; a flood fill labels every triangle with (wA, wB); the boolean
// rule selects "inside" triangles; connected components of inside
// triangles become output polygons, and each component's boundary loops
// split into one CCW outer ring and CW hole rings by signed area.
//
// This replaces shapely/GEOS union/difference/intersection used throughout
// the reference loader (kicad.py:1374-1391, 1588-1629, 1675-1689) with an
// exact grid-snapped design sharing the CDT core with the mesher.
#pragma once

#include "pg_cdt.h"

namespace pg {

enum class BoolOp { UNION = 0, INTERSECTION = 1, DIFFERENCE = 2 };

struct Ring {
  std::vector<Pt> pts;  // closed implicitly; no duplicate last point
};

// A polygon with holes: ring 0 is the CCW exterior, the rest are CW holes.
struct PolyWithHoles {
  std::vector<Ring> rings;
};

struct PolySet {
  std::vector<PolyWithHoles> polys;
};

inline i128 ring_signed_area2(const std::vector<Pt>& pts) {
  i128 s = 0;
  size_t n = pts.size();
  for (size_t i = 0; i < n; i++) {
    const Pt& p = pts[i];
    const Pt& q = pts[(i + 1) % n];
    s += (i128)p.x * q.y - (i128)q.x * p.y;
  }
  return s;  // 2x signed area; >0 for CCW
}

// Insert one operand's rings as winding-carrying constraints.
// Rings are used exactly as given (no orientation normalization) — a CCW
// ring contributes +1 winding inside, CW contributes -1, so callers control
// fill semantics via orientation (nonzero fill rule).
inline void insert_operand(CDT& cdt, const std::vector<Ring>& rings, int operand) {
  for (const Ring& ring : rings) {
    size_t n = ring.pts.size();
    if (n < 3) continue;
    std::vector<int> vid(n);
    for (size_t i = 0; i < n; i++) vid[i] = cdt.insert_point(ring.pts[i]);
    for (size_t i = 0; i < n; i++) {
      int u = vid[i], v = vid[(i + 1) % n];
      if (u == v) continue;
      Delta d = (operand == 0) ? Delta{1, 0} : Delta{0, 1};
      cdt.insert_constraint(u, v, d);
    }
  }
}

inline bool bool_inside(BoolOp op, int wa, int wb) {
  switch (op) {
    case BoolOp::UNION:
      return wa != 0 || wb != 0;
    case BoolOp::INTERSECTION:
      return wa != 0 && wb != 0;
    case BoolOp::DIFFERENCE:
      return wa != 0 && wb == 0;
  }
  return false;
}

// Extract the polygons (with holes) covering the triangles where
// inside[t] != 0.  Components of inside triangles become polygons;
// boundary loops are oriented with the inside on the left (CCW outer,
// CW holes).  Exactly-collinear chain vertices are elided.
inline PolySet extract_polygons(const CDT& cdt, const std::vector<char>& inside) {
  PolySet out;
  size_t nt = cdt.tris.size();
  std::vector<int32_t> comp(nt, -1);
  int ncomp = 0;

  // Label connected components of inside triangles (adjacency only through
  // edges where both sides are inside).
  for (size_t seed = 0; seed < nt; seed++) {
    if (!cdt.tris[seed].alive || !inside[seed] || comp[seed] >= 0) continue;
    std::deque<int> queue{(int)seed};
    comp[seed] = ncomp;
    while (!queue.empty()) {
      int ti = queue.front();
      queue.pop_front();
      const CDT::Tri& t = cdt.tris[ti];
      for (int i = 0; i < 3; i++) {
        int n = t.nb[i];
        if (n < 0 || !inside[n] || comp[n] >= 0) continue;
        comp[n] = ncomp;
        queue.push_back(n);
      }
    }
    ncomp++;
  }

  // Collect directed boundary half-edges per component: edge (a, b) of an
  // inside triangle (appearing CCW so the inside is on the left) whose
  // neighbor is outside/dead.
  // Key: (component, from-vertex) can have multiple outgoing edges at pinch
  // vertices; store them per (tri, edge) and resolve by fan rotation.
  struct BEdge {
    int a, b, tri, ei;
  };
  std::vector<std::vector<BEdge>> comp_edges(ncomp);
  std::vector<std::vector<char>> used;  // parallel to comp_edges
  for (size_t ti = 0; ti < nt; ti++) {
    const CDT::Tri& t = cdt.tris[ti];
    if (!t.alive || !inside[ti]) continue;
    for (int i = 0; i < 3; i++) {
      int n = t.nb[i];
      if (n >= 0 && inside[n]) continue;
      comp_edges[comp[ti]].push_back(
          BEdge{t.v[(i + 1) % 3], t.v[(i + 2) % 3], (int)ti, i});
    }
  }

  for (int c = 0; c < ncomp; c++) {
    auto& edges = comp_edges[c];
    if (edges.empty()) continue;
    // Map (tri, ei) -> index for O(1) lookup while walking.
    std::unordered_map<uint64_t, int> by_slot;
    for (size_t k = 0; k < edges.size(); k++)
      by_slot[(uint64_t(edges[k].tri) << 2) | edges[k].ei] = (int)k;
    std::vector<char> done(edges.size(), 0);

    PolyWithHoles poly;
    for (size_t k0 = 0; k0 < edges.size(); k0++) {
      if (done[k0]) continue;
      // Walk a loop starting at edges[k0].
      std::vector<Pt> loop_pts;
      int k = (int)k0;
      int guard = 0;
      while (!done[k]) {
        if (++guard > (int)edges.size() + 8)
          throw GeomError("extract_polygons: loop walk overflow");
        done[k] = 1;
        const BEdge& e = edges[k];
        loop_pts.push_back(cdt.pt(e.a));
        // Find the next boundary edge leaving e.b for this component:
        // rotate around e.b, starting from triangle e.tri, staying inside
        // the component, until hitting the boundary.
        int cur = e.tri;
        int next_k = -1;
        int g2 = 0;
        while (true) {
          if (++g2 > (1 << 20)) throw GeomError("extract_polygons: fan overflow");
          const CDT::Tri& t = cdt.tris[cur];
          int bi = CDT::vidx(t, e.b);
          // The edge leaving e.b within `cur` is (e.b, t.v[bi+1]); it is a
          // boundary edge iff the neighbor across it is outside.
          int ei = (bi + 2) % 3;  // edge (v[bi], v[bi+1]) is opposite v[bi+2]
          int n = t.nb[ei];
          if (n < 0 || !inside[n] || comp[n] != c) {
            auto it = by_slot.find((uint64_t(cur) << 2) | ei);
            if (it == by_slot.end())
              throw GeomError("extract_polygons: missing boundary slot");
            next_k = it->second;
            break;
          }
          cur = n;
        }
        k = next_k;
      }
      if (k != (int)k0) throw GeomError("extract_polygons: open loop");
      // Elide exactly-collinear vertices.
      std::vector<Pt> simp;
      size_t n = loop_pts.size();
      for (size_t i = 0; i < n; i++) {
        const Pt& prev = simp.empty() ? loop_pts[(i + n - 1) % n] : simp.back();
        const Pt& cur2 = loop_pts[i];
        const Pt& nxt = loop_pts[(i + 1) % n];
        if (orient2d(prev, cur2, nxt) != 0 || prev == nxt) simp.push_back(cur2);
      }
      // Re-check the wrap-around points.
      while (simp.size() >= 3 &&
             orient2d(simp[simp.size() - 2], simp.back(), simp.front()) == 0)
        simp.pop_back();
      while (simp.size() >= 3 &&
             orient2d(simp.back(), simp.front(), simp[1]) == 0)
        simp.erase(simp.begin());
      if (simp.size() < 3) continue;
      Ring r;
      r.pts = std::move(simp);
      poly.rings.push_back(std::move(r));
    }
    if (poly.rings.empty()) continue;
    // Outer ring = CCW (positive area); move it to position 0.
    size_t outer_idx = poly.rings.size();
    for (size_t i = 0; i < poly.rings.size(); i++) {
      if (ring_signed_area2(poly.rings[i].pts) > 0) {
        if (outer_idx != poly.rings.size())
          throw GeomError("extract_polygons: multiple outer rings in component");
        outer_idx = i;
      }
    }
    if (outer_idx == poly.rings.size())
      throw GeomError("extract_polygons: component without outer ring");
    if (outer_idx != 0) std::swap(poly.rings[0], poly.rings[outer_idx]);
    out.polys.push_back(std::move(poly));
  }
  return out;
}

// Full boolean pipeline.
inline PolySet boolean_op(BoolOp op, const std::vector<Ring>& a,
                          const std::vector<Ring>& b) {
  CDT cdt;
  insert_operand(cdt, a, 0);
  insert_operand(cdt, b, 1);
  std::vector<int32_t> wa, wb;
  cdt.compute_windings(wa, wb);
  std::vector<char> inside(cdt.tris.size(), 0);
  for (size_t i = 0; i < cdt.tris.size(); i++)
    if (cdt.tris[i].alive) inside[i] = bool_inside(op, wa[i], wb[i]) ? 1 : 0;
  return extract_polygons(cdt, inside);
}

}  // namespace pg
