// Constrained Delaunay triangulation on the int64 grid.
//
// Replaces the role of CGAL's CDT stack in the reference (_cgal.cpp:88-96,
// 351-384) with an independent design: Bowyer-Watson incremental insertion
// with exact integer predicates, Anglada-style constraint recovery with
// on-the-fly snap-round splitting of crossing constraints, and a winding
// number flood fill that powers both boolean overlay classification and
// mesh domain marking.
#pragma once

#include "pg_core.h"

#include <algorithm>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <unordered_set>

namespace pg {

// Accumulated winding contribution of the original input edges carried by a
// constrained CDT edge, per operand.  Stored against the canonical
// (min vertex, max vertex) direction.
struct Delta {
  int32_t a = 0;  // operand A winding delta
  int32_t b = 0;  // operand B winding delta
  bool zero() const { return a == 0 && b == 0; }
  Delta neg() const { return Delta{-a, -b}; }
  Delta operator+(const Delta& o) const { return Delta{a + o.a, b + o.b}; }
};

inline uint64_t edge_key(int u, int v) {
  if (u > v) std::swap(u, v);
  return (uint64_t(uint32_t(u)) << 32) | uint32_t(v);
}

class CDT {
 public:
  struct Tri {
    int32_t v[3];   // CCW vertices
    int32_t nb[3];  // nb[i] = neighbor across edge opposite v[i]
    uint8_t cons;   // bit i set -> edge opposite v[i] is constrained
    bool alive;
  };

  std::vector<i64> px, py;
  std::vector<Tri> tris;
  std::vector<int32_t> vtri;  // some alive triangle incident to each vertex
  std::vector<int32_t> free_tris;
  // Winding deltas of constrained edges (key = canonical vertex pair).
  std::unordered_map<uint64_t, Delta> cons_delta;

  // Reusable cavity scratch.  Epoch-stamped membership replaces a fresh
  // unordered_set per point insertion — the refinement loop runs one
  // dry-run cavity (encroachment check) plus one real cavity per final
  // vertex, and the hash-set construction dominated the mesher profile
  // (~25% of wall time at 1M vertices).  Never nested: each cavity walk
  // completes before the next begins.
  std::vector<uint32_t> cav_stamp;
  uint32_t cav_epoch = 0;
  std::vector<int> cav_list;

  void cavity_begin() {
    if (cav_stamp.size() < tris.size()) cav_stamp.resize(tris.size(), 0);
    ++cav_epoch;
    cav_list.clear();
  }
  bool cavity_has(int ti) const { return cav_stamp[ti] == cav_epoch; }
  void cavity_push(int ti) {
    cav_stamp[ti] = cav_epoch;
    cav_list.push_back(ti);
  }
  // Insertion-local scratch (see insert_point_impl).
  struct BEdge {
    int u, w, outer;
    bool cons;
  };
  std::unordered_map<int, int> start_scratch;
  std::vector<int> newid_scratch;
  std::vector<BEdge> boundary_scratch;
  int32_t last_tri_hint = 0;
  // When false, any crossing / vertex-on-constraint situation raises instead
  // of snap-splitting (used to reject self-intersecting mesher input the way
  // the reference's CGAL_DEBUG build does, mesh.py:646-659).
  bool allow_splitting = true;
  // When true, per-triangle operand-A windings are maintained incrementally
  // across point insertions (refinement mode: constraints only ever split,
  // never appear/disappear, so windings stay well defined).
  bool track_winding = false;
  std::vector<int32_t> tri_wa;
  // Guard against runaway snap-round cascades.
  int split_budget = 1 << 22;

  CDT() { init_box(); }

  int num_vertices() const { return (int)px.size(); }

  Pt pt(int v) const { return Pt{px[v], py[v]}; }

  // -------------------------------------------------------------------------
  // Initialization: a huge bounding square (vertices 0..3, two triangles).
  // -------------------------------------------------------------------------
  void init_box() {
    px = {-BOX_COORD, BOX_COORD, BOX_COORD, -BOX_COORD};
    py = {-BOX_COORD, -BOX_COORD, BOX_COORD, BOX_COORD};
    tris.clear();
    free_tris.clear();
    cons_delta.clear();
    // Two CCW triangles: (0,1,2) and (0,2,3).
    tris.push_back(Tri{{0, 1, 2}, {-1, 1, -1}, 0, true});
    tris.push_back(Tri{{0, 2, 3}, {-1, -1, 0}, 0, true});
    vtri = {0, 0, 0, 1};
    last_tri_hint = 0;
  }

  // -------------------------------------------------------------------------
  // Basic helpers
  // -------------------------------------------------------------------------
  static int vidx(const Tri& t, int v) {
    for (int i = 0; i < 3; i++)
      if (t.v[i] == v) return i;
    return -1;
  }

  // Index i such that edge opposite v[i] is (a, b) in either direction.
  static int eidx(const Tri& t, int a, int b) {
    for (int i = 0; i < 3; i++) {
      int u = t.v[(i + 1) % 3], w = t.v[(i + 2) % 3];
      if ((u == a && w == b) || (u == b && w == a)) return i;
    }
    return -1;
  }

  int alloc_tri() {
    if (!free_tris.empty()) {
      int id = free_tris.back();
      free_tris.pop_back();
      tris[id].alive = true;
      tris[id].cons = 0;
      return id;
    }
    tris.push_back(Tri{{-1, -1, -1}, {-1, -1, -1}, 0, true});
    return (int)tris.size() - 1;
  }

  void kill_tri(int id) {
    tris[id].alive = false;
    free_tris.push_back(id);
  }

  bool edge_constrained(int ti, int ei) const {
    return (tris[ti].cons >> ei) & 1;
  }

  // -------------------------------------------------------------------------
  // Point location: remembering walk with a brute-force fallback.
  // -------------------------------------------------------------------------
  struct Loc {
    int tri;
    int kind;  // 0 face, 1 edge, 2 vertex
    int sub;   // edge index or vertex index within tri
  };

  Loc locate(const Pt& p, int hint = -1) const {
    int cur = (hint >= 0 && hint < (int)tris.size() && tris[hint].alive)
                  ? hint
                  : last_tri_hint;
    if (cur < 0 || cur >= (int)tris.size() || !tris[cur].alive) {
      cur = -1;
      for (int i = 0; i < (int)tris.size(); i++)
        if (tris[i].alive) {
          cur = i;
          break;
        }
      if (cur < 0) throw GeomError("locate: empty triangulation");
    }
    int prev = -1;
    size_t steps = 0, max_steps = tris.size() * 4 + 64;
    while (true) {
      if (++steps > max_steps) return locate_brute(p);
      const Tri& t = tris[cur];
      int zero_edge = -1;
      bool moved = false;
      for (int i = 0; i < 3; i++) {
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        int o = orient2d(pt(a), pt(b), p);
        if (o < 0) {
          int n = t.nb[i];
          if (n < 0) throw GeomError("locate: point outside bounding box");
          if (n != prev || moved) {
            prev = cur;
            cur = n;
            moved = true;
            break;
          }
          prev = cur;
          cur = n;
          moved = true;
          break;
        } else if (o == 0) {
          zero_edge = i;
        }
      }
      if (moved) continue;
      const Tri& tc = tris[cur];
      for (int i = 0; i < 3; i++)
        if (pt(tc.v[i]) == p) return Loc{cur, 2, i};
      if (zero_edge >= 0) return Loc{cur, 1, zero_edge};
      return Loc{cur, 0, 0};
    }
  }

  Loc locate_brute(const Pt& p) const {
    for (int ti = 0; ti < (int)tris.size(); ti++) {
      const Tri& t = tris[ti];
      if (!t.alive) continue;
      int zero_edge = -1;
      bool outside = false;
      for (int i = 0; i < 3; i++) {
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        int o = orient2d(pt(a), pt(b), p);
        if (o < 0) {
          outside = true;
          break;
        }
        if (o == 0) zero_edge = i;
      }
      if (outside) continue;
      for (int i = 0; i < 3; i++)
        if (pt(t.v[i]) == p) return Loc{ti, 2, i};
      if (zero_edge >= 0) return Loc{ti, 1, zero_edge};
      return Loc{ti, 0, 0};
    }
    throw GeomError("locate_brute: point not found");
  }

  // -------------------------------------------------------------------------
  // Point insertion (Bowyer-Watson with constraint-bounded cavity).
  // Returns the vertex id (an existing one for exact duplicates).
  // A point landing on a constrained edge splits it; both halves inherit
  // the winding delta.
  // -------------------------------------------------------------------------
  int insert_point(Pt p, int hint = -1) {
    return insert_point_impl(p, hint, -1, -1);
  }

  // Ruppert-checked insertion: collect cavity-boundary constrained
  // edges whose diametral circle strictly contains p into `enc_out`
  // (as vertex pairs) and return -2 WITHOUT touching the triangulation
  // when any exist; otherwise insert normally.  Fuses the refiner's
  // encroachment dry run with the insertion — one locate + one cavity
  // walk instead of two of each.
  int insert_point_checked(Pt p, int hint,
                           std::vector<std::pair<int, int>>& enc_out) {
    return insert_point_impl(p, hint, -1, -1, &enc_out);
  }

  // Split the constrained edge `sei` of triangle `sti` at point p, even
  // when p (a snapped midpoint) is not exactly on the segment.  Both
  // halves inherit the winding delta.  Returns the new vertex id, or the
  // absorbed existing vertex when p coincides with one, or -1 when no
  // clean split was possible.
  int split_constrained_edge(int sti, int sei, Pt p) {
    return insert_point_impl(p, sti, sti, sei);
  }

  int insert_point_impl(Pt p, int hint, int force_ti, int force_ei,
                        std::vector<std::pair<int, int>>* enc_out = nullptr) {
    if (p.x < -COORD_LIMIT || p.x > COORD_LIMIT || p.y < -COORD_LIMIT ||
        p.y > COORD_LIMIT)
      throw GeomError("insert_point: coordinate out of range");
    Loc loc;
    if (force_ti >= 0) {
      loc = Loc{force_ti, 1, force_ei};
    } else {
      loc = locate(p, hint);
      if (loc.kind == 2) return tris[loc.tri].v[loc.sub];
    }

    bool cavity_ready = false;
    if (enc_out) {
      // Encroachment-checked mode: run the cavity walk FIRST, before
      // any mutation, collecting constrained cavity-boundary edges
      // whose diametral circle strictly contains p.  A point landing
      // ON a constrained edge always encroaches it, so the walk does
      // not cross the landed-on edge (matching the former dry run).
      enc_out->clear();
      cavity_begin();
      cavity_push(loc.tri);
      if (loc.kind == 1 && !edge_constrained(loc.tri, loc.sub)) {
        int n = tris[loc.tri].nb[loc.sub];
        if (n >= 0) cavity_push(n);
      }
      for (size_t qi = 0; qi < cav_list.size(); qi++) {
        int ti = cav_list[qi];
        const Tri t = tris[ti];
        for (int i = 0; i < 3; i++) {
          int n = t.nb[i];
          int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
          if (edge_constrained(ti, i)) {
            if (in_diametral_circle(pt(a), pt(b), p))
              enc_out->emplace_back(a, b);
            continue;
          }
          if (n < 0 || cavity_has(n)) continue;
          const Tri& tn = tris[n];
          if (incircle(pt(tn.v[0]), pt(tn.v[1]), pt(tn.v[2]), p) > 0)
            cavity_push(n);
        }
      }
      if (!enc_out->empty()) return -2;
      // No encroachment implies p is not on a constrained edge, so this
      // cavity is exactly the insertion cavity below.
      cavity_ready = true;
    }

    // If the point lands on (or force-splits) a constrained edge,
    // remember + unmark it.
    int cons_u = -1, cons_v = -1;
    Delta cons_d;
    bool had_delta = false;
    if (loc.kind == 1 && edge_constrained(loc.tri, loc.sub)) {
      if (!allow_splitting)
        throw GeomError("point insertion would split a constrained edge");
      const Tri& t = tris[loc.tri];
      cons_u = t.v[(loc.sub + 1) % 3];
      cons_v = t.v[(loc.sub + 2) % 3];
      if (p == pt(cons_u) || p == pt(cons_v)) return -1;
      auto it = cons_delta.find(edge_key(cons_u, cons_v));
      if (it != cons_delta.end()) {
        cons_d = it->second;
        had_delta = true;
        cons_delta.erase(it);
      }
      unmark_constraint(loc.tri, loc.sub);
    }
    auto restore_constraint = [&]() {
      if (cons_u >= 0) {
        auto [rti, rei] = find_edge(cons_u, cons_v);
        if (rti >= 0) {
          tris[rti].cons |= (1 << rei);
          int rn = tris[rti].nb[rei];
          if (rn >= 0) {
            int rj = eidx(tris[rn], cons_u, cons_v);
            if (rj >= 0) tris[rn].cons |= (1 << rj);
          }
        }
        if (had_delta) cons_delta[edge_key(cons_u, cons_v)] = cons_d;
      }
    };

    int vnew = (int)px.size();
    px.push_back(p.x);
    py.push_back(p.y);
    vtri.push_back(-1);

    // Seed cavity (epoch-stamped scratch; see cavity_begin).  In
    // checked mode the walk above already produced it.
    std::vector<int>& cavity = cav_list;
    auto add_cav = [&](int ti) {
      if (ti < 0 || cavity_has(ti)) return;
      cavity_push(ti);
    };
    if (!cavity_ready) {
      cavity_begin();
      add_cav(loc.tri);
      if (loc.kind == 1) {
        int n = tris[loc.tri].nb[loc.sub];
        if (n >= 0) add_cav(n);
      }
      for (size_t qi = 0; qi < cavity.size(); qi++) {
        int ti = cavity[qi];
        const Tri t = tris[ti];
        for (int i = 0; i < 3; i++) {
          int n = t.nb[i];
          if (n < 0 || cavity_has(n)) continue;
          if (edge_constrained(ti, i)) continue;
          const Tri& tn = tris[n];
          if (incircle(pt(tn.v[0]), pt(tn.v[1]), pt(tn.v[2]), p) > 0)
            add_cav(n);
        }
      }
    }

    // In forced-split mode the point may coincide with an existing vertex
    // (e.g. a stray near-edge point from an earlier snap); absorb it into
    // the constraint chain instead of inserting a duplicate.
    if (force_ti >= 0) {
      for (int ti : cavity) {
        for (int k = 0; k < 3; k++) {
          int w = tris[ti].v[k];
          if (pt(w) == p && w != cons_u && w != cons_v) {
            px.pop_back();
            py.pop_back();
            vtri.pop_back();
            auto [e1, i1] = find_edge(cons_u, w);
            auto [e2, i2] = find_edge(w, cons_v);
            if (e1 < 0 || e2 < 0) {
              restore_constraint();
              return -1;
            }
            mark_edge(cons_u, w,
                      split_delta(cons_u, w, cons_u, cons_v, cons_d));
            mark_edge(w, cons_v,
                      split_delta(w, cons_v, cons_u, cons_v, cons_d));
            return w;
          }
        }
      }
    }

    // Boundary edges in CCW orientation as seen from inside the cavity.
    std::vector<BEdge>& boundary = boundary_scratch;
    boundary.clear();
    boundary.reserve(cavity.size() + 2);
    bool collect_ok = true;
    for (int pass = 0; pass < 64; pass++) {
      boundary.clear();
      collect_ok = true;
      size_t cav_size_before = cavity.size();
      // Index iteration: add_cav may grow `cavity` mid-pass (digging
      // across a non-visible edge), which would invalidate range-for
      // iterators.  The pass restarts anyway once the size changed.
      for (size_t qi = 0; qi < cav_size_before; qi++) {
        int ti = cavity[qi];
        const Tri& t = tris[ti];
        for (int i = 0; i < 3; i++) {
          int n = t.nb[i];
          if (n >= 0 && cavity_has(n)) continue;
          int bu = t.v[(i + 1) % 3], bw = t.v[(i + 2) % 3];
          // Star-shapedness: every boundary edge must be strictly visible
          // from p.  If not, dig the cavity across it (possible when the
          // cavity was seeded on a slightly-off-edge forced split).
          if (orient2d(pt(bu), pt(bw), p) <= 0) {
            if (n >= 0 && !edge_constrained(ti, i)) {
              add_cav(n);
              collect_ok = false;
              continue;
            }
            // Unfixable degeneracy: abort the insertion.
            px.pop_back();
            py.pop_back();
            vtri.pop_back();
            restore_constraint();
            if (force_ti < 0)
              throw GeomError("insert_point: cavity not star-shaped");
            return -1;
          }
          boundary.push_back(
              BEdge{bu, bw, n, edge_constrained(ti, i)});
        }
      }
      if (collect_ok && cavity.size() == cav_size_before) break;
    }
    if (!collect_ok) {
      px.pop_back();
      py.pop_back();
      vtri.pop_back();
      restore_constraint();
      if (force_ti < 0)
        throw GeomError("insert_point: cavity not star-shaped");
      return -1;
    }

    for (int ti : cavity) kill_tri(ti);
    // Member scratch (clear keeps buckets/capacity): one less hash-map
    // + vector allocation pair per insertion.
    std::unordered_map<int, int>& start_tri = start_scratch;
    start_tri.clear();
    std::vector<int>& new_ids = newid_scratch;
    new_ids.clear();
    new_ids.reserve(boundary.size());
    for (const BEdge& be : boundary) {
      int id = alloc_tri();
      Tri& t = tris[id];
      t.v[0] = be.u;
      t.v[1] = be.w;
      t.v[2] = vnew;
      t.nb[0] = -1;
      t.nb[1] = -1;
      t.nb[2] = be.outer;
      t.cons = be.cons ? 4 : 0;  // bit 2 = edge (u, w)
      start_tri[be.u] = id;
      new_ids.push_back(id);
      vtri[be.u] = id;
      vtri[be.w] = id;
    }
    for (size_t k = 0; k < boundary.size(); k++) {
      const BEdge& be = boundary[k];
      int id = new_ids[k];
      Tri& t = tris[id];
      auto it = start_tri.find(be.w);
      if (it == start_tri.end()) throw GeomError("cavity boundary not closed");
      t.nb[0] = it->second;
      tris[it->second].nb[1] = id;
      if (be.outer >= 0) {
        Tri& ot = tris[be.outer];
        int ei = eidx(ot, be.u, be.w);
        if (ei < 0) throw GeomError("outer neighbor mismatch");
        ot.nb[ei] = id;
      }
    }
    vtri[vnew] = new_ids.empty() ? -1 : new_ids[0];
    last_tri_hint = vtri[vnew];

    if (track_winding) {
      if (tri_wa.size() < tris.size()) tri_wa.resize(tris.size(), 0);
      for (size_t k = 0; k < boundary.size(); k++) {
        const BEdge& be = boundary[k];
        int32_t w = (be.outer >= 0) ? tri_wa[be.outer] : 0;
        if (be.cons) {
          auto it = cons_delta.find(edge_key(be.u, be.w));
          if (it != cons_delta.end()) {
            // New fan triangle contains directed edge (u, w) CCW, so it is
            // on the LEFT of u->w; w(left) = w(right) + canonical delta.
            w += (be.u < be.w) ? it->second.a : -it->second.a;
          }
        }
        tri_wa[new_ids[k]] = w;
      }
    }

    if (cons_u >= 0) {
      mark_edge(cons_u, vnew, split_delta(cons_u, vnew, cons_u, cons_v, cons_d));
      mark_edge(vnew, cons_v, split_delta(vnew, cons_v, cons_u, cons_v, cons_d));
    }
    return vnew;
  }

  // Delta bookkeeping when original constrained edge (ou -> ov) carrying `d`
  // (stored for canonical min->max direction of (ou, ov)) is replaced by a
  // sub-edge (a -> b) oriented along ou -> ov.  Returns the delta to store
  // for the canonical direction of (a, b).
  static Delta split_delta(int a, int b, int ou, int ov, const Delta& d) {
    Delta along_uv = (ou < ov) ? d : d.neg();
    return (a < b) ? along_uv : along_uv.neg();
  }

  void unmark_constraint(int ti, int ei) {
    tris[ti].cons &= ~(1 << ei);
    int n = tris[ti].nb[ei];
    if (n >= 0) {
      int a = tris[ti].v[(ei + 1) % 3], b = tris[ti].v[(ei + 2) % 3];
      int j = eidx(tris[n], a, b);
      if (j >= 0) tris[n].cons &= ~(1 << j);
    }
  }

  // Find the triangle containing edge (u, w).  Returns (tri, eidx) or
  // (-1, -1) when the edge does not exist in the triangulation.
  std::pair<int, int> find_edge(int u, int w) const {
    int t0 = vtri[u];
    if (t0 < 0) return {-1, -1};
    auto check = [&](int cur) -> std::pair<int, int> {
      const Tri& t = tris[cur];
      int i = vidx(t, u);
      if (i < 0) throw GeomError("find_edge: vtri inconsistent");
      if (t.v[(i + 1) % 3] == w) return {cur, (i + 2) % 3};
      if (t.v[(i + 2) % 3] == w) return {cur, (i + 1) % 3};
      return {-1, -1};
    };
    int cur = t0, guard = 0;
    while (true) {
      auto r = check(cur);
      if (r.first >= 0) return r;
      const Tri& t = tris[cur];
      int i = vidx(t, u);
      int nxt = t.nb[(i + 2) % 3];  // rotate across edge (u, v[i+1])
      if (nxt < 0) break;
      cur = nxt;
      if (cur == t0) return {-1, -1};
      if (++guard > (1 << 22)) throw GeomError("find_edge: orbit overflow");
    }
    cur = t0;
    guard = 0;
    while (true) {
      const Tri& t = tris[cur];
      int i = vidx(t, u);
      int nxt = t.nb[(i + 1) % 3];  // rotate across edge (v[i+2], u)
      if (nxt < 0) return {-1, -1};
      cur = nxt;
      auto r = check(cur);
      if (r.first >= 0) return r;
      if (++guard > (1 << 22)) throw GeomError("find_edge: orbit overflow");
    }
  }

  // Mark edge (u, w) constrained, accumulating `d` (already expressed for
  // the canonical direction of (u, w)).
  void mark_edge(int u, int w, const Delta& d) {
    auto [ti, ei] = find_edge(u, w);
    if (ti < 0) throw GeomError("mark_edge: edge not present");
    tris[ti].cons |= (1 << ei);
    int n = tris[ti].nb[ei];
    if (n >= 0) {
      int j = eidx(tris[n], u, w);
      if (j >= 0) tris[n].cons |= (1 << j);
    }
    if (!d.zero()) {
      Delta& slot = cons_delta[edge_key(u, w)];
      slot = slot + d;
    }
  }

  Delta take_delta(int u, int w) {
    auto it = cons_delta.find(edge_key(u, w));
    if (it == cons_delta.end()) return Delta{};
    Delta d = it->second;
    cons_delta.erase(it);
    return d;
  }

  // -------------------------------------------------------------------------
  // Constraint insertion with winding bookkeeping.
  //
  // `d_uv` is the winding delta contributed by this input edge in the
  // direction u -> v (e.g. {+1, 0} for a CCW ring edge of operand A).
  // Crossing constraints and vertices lying exactly on the segment are
  // handled by splitting (snap-rounded to the grid).
  // -------------------------------------------------------------------------
  void insert_constraint(int u, int v, Delta d_uv) {
    struct Item {
      int u, v;
      Delta d;  // for direction u -> v
    };
    std::vector<Item> stack;
    stack.push_back(Item{u, v, d_uv});
    int guard = 0;
    while (!stack.empty()) {
      if (++guard > split_budget)
        throw GeomError("insert_constraint: split budget exceeded");
      Item it = stack.back();
      stack.pop_back();
      if (it.u == it.v) continue;
      // Store deltas canonically.
      Delta canon = (it.u < it.v) ? it.d : it.d.neg();

      auto [ti, ei] = find_edge(it.u, it.v);
      if (ti >= 0) {
        mark_edge(it.u, it.v, canon);
        continue;
      }

      // March from u toward v.
      MarchResult mr = march(it.u, it.v);
      switch (mr.kind) {
        case MarchResult::VERTEX_ON_SEGMENT: {
          if (!allow_splitting)
            throw GeomError("constraint passes through an existing vertex");
          stack.push_back(Item{mr.w, it.v, it.d});
          stack.push_back(Item{it.u, mr.w, it.d});
          break;
        }
        case MarchResult::CROSSES_CONSTRAINT: {
          if (!allow_splitting)
            throw GeomError("constraints intersect");
          int a = mr.a, b = mr.b;
          Pt m = segment_intersection_rounded(pt(it.u), pt(it.v), pt(a), pt(b));
          if (m == pt(a) || m == pt(b)) {
            // Snapped to an endpoint of the crossed edge: treat as a vertex
            // on our segment.
            int w = (m == pt(a)) ? a : b;
            stack.push_back(Item{w, it.v, it.d});
            stack.push_back(Item{it.u, w, it.d});
            break;
          }
          // Remove the crossed constraint, insert the (snapped) crossing
          // point, then re-insert all four half-segments.
          Delta dab_canon = take_delta(a, b);
          Delta dab_dir = (a < b) ? dab_canon : dab_canon.neg();  // along a->b
          auto [cti, cei] = find_edge(a, b);
          if (cti >= 0) unmark_constraint(cti, cei);
          if (m == pt(it.u) || m == pt(it.v)) {
            int w = (m == pt(it.u)) ? it.u : it.v;
            stack.push_back(Item{a, w, dab_dir});
            stack.push_back(Item{w, b, dab_dir});
            stack.push_back(Item{it.u, it.v, it.d});
            break;
          }
          int mv = insert_point(m, mr.tri_hint);
          stack.push_back(Item{a, mv, dab_dir});
          stack.push_back(Item{mv, b, dab_dir});
          stack.push_back(Item{mv, it.v, it.d});
          stack.push_back(Item{it.u, mv, it.d});
          break;
        }
        case MarchResult::CLEAR: {
          recover_edge(it.u, it.v, mr);
          mark_edge(it.u, it.v, canon);
          break;
        }
      }
    }
  }

  struct MarchResult {
    enum Kind { CLEAR, VERTEX_ON_SEGMENT, CROSSES_CONSTRAINT } kind = CLEAR;
    int w = -1;             // VERTEX_ON_SEGMENT: the vertex
    int a = -1, b = -1;     // CROSSES_CONSTRAINT: the crossed edge
    int tri_hint = -1;
    std::vector<int> crossed;  // CLEAR: crossed triangles u -> v
    std::vector<int> upper;    // vertices strictly left of u -> v, in order
    std::vector<int> lower;    // vertices strictly right of u -> v, in order
  };

  // Walk the segment u -> v.  Read-only.
  MarchResult march(int u, int v) const {
    MarchResult mr;
    Pt pu = pt(u), pv = pt(v);

    // Find the starting triangle around u: either (u,v,*) (handled by
    // caller), a vertex exactly on the open segment, or the triangle whose
    // opposite edge is properly crossed.  In a CCW triangle (u, a, b) the
    // segment exits through (a, b) when a is strictly RIGHT and b strictly
    // LEFT of u -> v.
    int start = -1, vl = -1, vr = -1;
    {
      int t0 = vtri[u];
      if (t0 < 0) throw GeomError("march: isolated vertex");
      // Collect the full orbit (handles hull by two-direction rotation).
      std::vector<int> orbit;
      int cur = t0, guard = 0;
      while (true) {
        orbit.push_back(cur);
        const Tri& t = tris[cur];
        int i = vidx(t, u);
        int nxt = t.nb[(i + 2) % 3];
        if (nxt < 0) break;
        if (nxt == t0) break;
        cur = nxt;
        if (++guard > (1 << 22)) throw GeomError("march: orbit overflow");
      }
      if (tris[orbit.back()].nb[(vidx(tris[orbit.back()], u) + 2) % 3] < 0) {
        cur = t0;
        guard = 0;
        while (true) {
          const Tri& t = tris[cur];
          int i = vidx(t, u);
          int nxt = t.nb[(i + 1) % 3];
          if (nxt < 0) break;
          cur = nxt;
          orbit.push_back(cur);
          if (++guard > (1 << 22)) throw GeomError("march: orbit overflow");
        }
      }
      for (int ti : orbit) {
        const Tri& t = tris[ti];
        int i = vidx(t, u);
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        // Vertex exactly on the open segment?
        if (a != v && on_open_segment(pu, pv, pt(a))) {
          mr.kind = MarchResult::VERTEX_ON_SEGMENT;
          mr.w = a;
          return mr;
        }
        if (b != v && on_open_segment(pu, pv, pt(b))) {
          mr.kind = MarchResult::VERTEX_ON_SEGMENT;
          mr.w = b;
          return mr;
        }
        // Segment leaves through the opposite edge (a, b)?
        int oa = orient2d(pu, pv, pt(a));
        int ob = orient2d(pu, pv, pt(b));
        if (oa < 0 && ob > 0) {
          start = ti;
          vr = a;  // right of u -> v
          vl = b;  // left of u -> v
          break;
        }
      }
      if (start < 0) throw GeomError("march: could not find starting triangle");
    }

    mr.crossed.push_back(start);
    mr.upper.push_back(vl);  // left of u -> v
    mr.lower.push_back(vr);  // right of u -> v
    int cur = start;
    int guard = 0;
    while (true) {
      if (++guard > (1 << 24)) throw GeomError("march: walk overflow");
      const Tri& t = tris[cur];
      int ei = eidx(t, vl, vr);
      if (edge_constrained(cur, ei)) {
        mr.kind = MarchResult::CROSSES_CONSTRAINT;
        mr.a = vl;
        mr.b = vr;
        mr.tri_hint = cur;
        return mr;
      }
      int nxt = t.nb[ei];
      if (nxt < 0) throw GeomError("march: fell off the triangulation");
      const Tri& tn = tris[nxt];
      int ci = eidx(tn, vl, vr);  // edge shared with cur
      int c = tn.v[ci];           // apex of next triangle
      mr.crossed.push_back(nxt);
      if (c == v) {
        mr.kind = MarchResult::CLEAR;
        return mr;
      }
      if (on_open_segment(pu, pv, pt(c))) {
        mr.kind = MarchResult::VERTEX_ON_SEGMENT;
        mr.w = c;
        return mr;
      }
      int oc = orient2d(pu, pv, pt(c));
      if (oc > 0) {
        mr.upper.push_back(c);
        vl = c;  // segment now exits between (vr, c)
      } else {
        mr.lower.push_back(c);
        vr = c;
      }
      cur = nxt;
    }
  }

  // Remove the crossed triangles and retriangulate the upper/lower
  // pseudo-polygons so that edge (u, v) exists.
  void recover_edge(int u, int v, const MarchResult& mr) {
    // The corridor crosses only unconstrained edges, so all its triangles
    // share a single winding value.
    int32_t corridor_w = 0;
    if (track_winding && !mr.crossed.empty() &&
        (size_t)mr.crossed[0] < tri_wa.size())
      corridor_w = tri_wa[mr.crossed[0]];
    // Save the outer boundary (neighbor + constraint flag) of the corridor.
    std::unordered_map<uint64_t, std::pair<int, bool>> outer;
    std::unordered_set<int> corridor(mr.crossed.begin(), mr.crossed.end());
    for (int ti : mr.crossed) {
      const Tri& t = tris[ti];
      for (int i = 0; i < 3; i++) {
        int n = t.nb[i];
        if (n >= 0 && corridor.count(n)) continue;
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        outer[edge_key(a, b)] = {n, edge_constrained(ti, i)};
      }
    }
    for (int ti : mr.crossed) kill_tri(ti);

    // New triangles built here; stitch adjacency afterwards.
    std::vector<int> created;
    // retriangulate upper chain (vertices strictly left of u->v):
    retri_chain(u, v, mr.upper, /*left_side=*/true, created);
    retri_chain(u, v, mr.lower, /*left_side=*/false, created);

    // Stitch: match half-edges among created triangles; leftovers bind to
    // the saved outer boundary.
    std::unordered_map<uint64_t, std::pair<int, int>> open_edges;
    for (int id : created) {
      Tri& t = tris[id];
      for (int i = 0; i < 3; i++) {
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        uint64_t k = edge_key(a, b);
        auto it = open_edges.find(k);
        if (it != open_edges.end()) {
          int oid = it->second.first, oei = it->second.second;
          t.nb[i] = oid;
          tris[oid].nb[oei] = id;
          open_edges.erase(it);
        } else {
          open_edges[k] = {id, i};
        }
      }
      for (int i = 0; i < 3; i++) vtri[t.v[i]] = id;
    }
    for (auto& [k, slot] : open_edges) {
      int id = slot.first, ei = slot.second;
      Tri& t = tris[id];
      auto it = outer.find(k);
      if (it == outer.end())
        throw GeomError("recover_edge: unmatched boundary edge");
      int n = it->second.first;
      bool cons = it->second.second;
      t.nb[ei] = n;
      if (cons) t.cons |= (1 << ei);
      if (n >= 0) {
        int a = t.v[(ei + 1) % 3], b = t.v[(ei + 2) % 3];
        Tri& ot = tris[n];
        int oi = eidx(ot, a, b);
        if (oi < 0) throw GeomError("recover_edge: outer mismatch");
        ot.nb[oi] = id;
      }
    }
    if (track_winding) {
      if (tri_wa.size() < tris.size()) tri_wa.resize(tris.size(), 0);
      for (int id : created) tri_wa[id] = corridor_w;
    }
    last_tri_hint = created.empty() ? last_tri_hint : created[0];
  }

  // Triangulate the pseudo-polygon between base (u, v) and `chain` (all
  // vertices strictly on one side of u->v, ordered from u toward v).
  // Creates CCW triangles and records them in `created`.
  void retri_chain(int u, int v, const std::vector<int>& chain, bool left_side,
                   std::vector<int>& created) {
    if (chain.empty()) return;
    retri_rec(u, v, chain, 0, (int)chain.size(), left_side, created);
  }

  void retri_rec(int u, int v, const std::vector<int>& chain, int lo, int hi,
                 bool left_side, std::vector<int>& created) {
    if (lo >= hi) return;
    // Choose c in chain[lo:hi] whose circumcircle with (u, v) is Delaunay.
    int ci = lo;
    for (int k = lo + 1; k < hi; k++) {
      // CCW orientation of the candidate triangle:
      int a = u, b = v, c = chain[ci];
      if (!left_side) std::swap(a, b);
      // triangle (a, b, c)? For left_side, c is left of u->v so (u, v, c)
      // is CCW; for right side, (v, u, c) is CCW.
      if (incircle(pt(a), pt(b), pt(c), pt(chain[k])) > 0) ci = k;
    }
    int c = chain[ci];
    int id = alloc_tri();
    Tri& t = tris[id];
    if (left_side) {
      t.v[0] = u;
      t.v[1] = v;
      t.v[2] = c;
    } else {
      t.v[0] = v;
      t.v[1] = u;
      t.v[2] = c;
    }
    t.nb[0] = t.nb[1] = t.nb[2] = -1;
    created.push_back(id);
    retri_rec(u, c, chain, lo, ci, left_side, created);
    retri_rec(c, v, chain, ci + 1, hi, left_side, created);
  }

  // -------------------------------------------------------------------------
  // Winding-number flood fill.  Returns per-triangle (wA, wB); dead
  // triangles get (0, 0).  Starts from a bounding-box triangle with w = 0.
  // -------------------------------------------------------------------------
  void compute_windings(std::vector<int32_t>& wa, std::vector<int32_t>& wb) const {
    wa.assign(tris.size(), 0);
    wb.assign(tris.size(), 0);
    std::vector<char> seen(tris.size(), 0);
    int start = vtri[0];  // incident to a box corner -> winding 0
    if (start < 0) throw GeomError("compute_windings: no start triangle");
    std::deque<int> queue{start};
    seen[start] = 1;
    while (!queue.empty()) {
      int ti = queue.front();
      queue.pop_front();
      const Tri& t = tris[ti];
      for (int i = 0; i < 3; i++) {
        int n = t.nb[i];
        if (n < 0 || seen[n]) continue;
        int32_t dwa = 0, dwb = 0;
        if (edge_constrained(ti, i)) {
          int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
          auto it = cons_delta.find(edge_key(a, b));
          if (it != cons_delta.end()) {
            // `t` contains directed edge (a, b) in CCW order, so `t` is on
            // the LEFT of a->b.  Stored delta is for canonical (min->max);
            // w(left) = w(right) + delta along the canonical direction.
            Delta d = it->second;
            bool t_left_of_canonical = (a < b);
            // moving from t (one side) to n (other side):
            // if t is left: w(n) = w(t) - d ; else w(n) = w(t) + d
            int sign = t_left_of_canonical ? -1 : 1;
            dwa = sign * d.a;
            dwb = sign * d.b;
          }
        }
        wa[n] = wa[ti] + dwa;
        wb[n] = wb[ti] + dwb;
        seen[n] = 1;
        queue.push_back(n);
      }
    }
    // Any unreachable alive triangle would be a bug (the triangulation of a
    // convex box is connected).
    for (size_t i = 0; i < tris.size(); i++)
      if (tris[i].alive && !seen[i])
        throw GeomError("compute_windings: disconnected triangulation");
  }

  // -------------------------------------------------------------------------
  // Integrity check used by tests.
  // -------------------------------------------------------------------------
  void validate() const {
    for (int ti = 0; ti < (int)tris.size(); ti++) {
      const Tri& t = tris[ti];
      if (!t.alive) continue;
      if (orient2d(pt(t.v[0]), pt(t.v[1]), pt(t.v[2])) <= 0)
        throw GeomError("validate: non-CCW triangle");
      for (int i = 0; i < 3; i++) {
        int n = t.nb[i];
        if (n < 0) continue;
        const Tri& tn = tris[n];
        if (!tn.alive) throw GeomError("validate: dead neighbor");
        int a = t.v[(i + 1) % 3], b = t.v[(i + 2) % 3];
        int j = eidx(tn, a, b);
        if (j < 0) throw GeomError("validate: neighbor does not share edge");
        if (tn.nb[j] != ti) throw GeomError("validate: asymmetric adjacency");
        if (edge_constrained(ti, i) != edge_constrained(n, j))
          throw GeomError("validate: asymmetric constraint flag");
      }
    }
  }
};

}  // namespace pg
