// padne_tpu native geometry core — exact integer predicates.
//
// All geometry lives on an int64 "nanometer" grid (1 mm == 1e6 units).
// User coordinates are bounded by |x| <= 2^31; the triangulation's
// bounding-box super-vertices sit at +-2^33.  With those bounds:
//   orient2d:  differences <= 2^34, products <= 2^68  -> exact in __int128
//   incircle:  lift terms  <= 2^69, cross  <= 2^69    -> products <= 2^138,
//              accumulated exactly in a 256-bit sign-magnitude integer.
// No floating-point filters are needed for correctness; everything is
// exact by construction (this replaces CGAL's exact predicate kernel used
// by the reference, _cgal.cpp:88-96, with a grid-snapped design).
#pragma once

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <string>
#include <stdexcept>

namespace pg {

using i64 = int64_t;
using i128 = __int128;
using u128 = unsigned __int128;

// User coordinates must satisfy |x| <= COORD_LIMIT.
constexpr i64 COORD_LIMIT = (i64(1) << 31);
// Super-box corners.
constexpr i64 BOX_COORD = (i64(1) << 33);

struct Pt {
  i64 x, y;
  bool operator==(const Pt& o) const { return x == o.x && y == o.y; }
  bool operator!=(const Pt& o) const { return !(*this == o); }
};

// ---------------------------------------------------------------------------
// 256-bit sign-magnitude accumulator (enough for incircle determinants).
// ---------------------------------------------------------------------------
struct I256 {
  int sign = 0;       // -1, 0, +1
  u128 hi = 0, lo = 0;  // 256-bit magnitude

  static I256 mul(i128 a, i128 b) {
    I256 r;
    int s = 1;
    if (a < 0) { a = -a; s = -s; }
    if (b < 0) { b = -b; s = -s; }
    if (a == 0 || b == 0) return r;
    u128 ua = (u128)a, ub = (u128)b;
    uint64_t a0 = (uint64_t)ua, a1 = (uint64_t)(ua >> 64);
    uint64_t b0 = (uint64_t)ub, b1 = (uint64_t)(ub >> 64);
    u128 p00 = (u128)a0 * b0;
    u128 p01 = (u128)a0 * b1;
    u128 p10 = (u128)a1 * b0;
    u128 p11 = (u128)a1 * b1;
    // magnitude = p11<<128 + (p01+p10)<<64 + p00
    u128 mid = p01 + p10;           // may carry past 128 bits
    u128 carry_mid = (mid < p01) ? ((u128)1 << 64) : 0;
    u128 lo = p00 + (mid << 64);
    u128 carry_lo = (lo < p00) ? 1 : 0;
    u128 hi = p11 + (mid >> 64) + carry_mid + carry_lo;
    r.sign = s;
    r.hi = hi;
    r.lo = lo;
    if (hi == 0 && lo == 0) r.sign = 0;
    return r;
  }

  // magnitude comparison: -1, 0, +1
  static int cmp_mag(const I256& a, const I256& b) {
    if (a.hi != b.hi) return a.hi < b.hi ? -1 : 1;
    if (a.lo != b.lo) return a.lo < b.lo ? -1 : 1;
    return 0;
  }

  I256 operator+(const I256& o) const {
    if (sign == 0) return o;
    if (o.sign == 0) return *this;
    I256 r;
    if (sign == o.sign) {
      r.sign = sign;
      r.lo = lo + o.lo;
      r.hi = hi + o.hi + (r.lo < lo ? 1 : 0);
    } else {
      int c = cmp_mag(*this, o);
      if (c == 0) return r;  // zero
      const I256& big = (c > 0) ? *this : o;
      const I256& sml = (c > 0) ? o : *this;
      r.sign = big.sign;
      r.lo = big.lo - sml.lo;
      r.hi = big.hi - sml.hi - (big.lo < sml.lo ? 1 : 0);
    }
    if (r.hi == 0 && r.lo == 0) r.sign = 0;
    return r;
  }
};

// ---------------------------------------------------------------------------
// Predicates (all exact)
// ---------------------------------------------------------------------------

// Sign of the cross product (b-a) x (c-a):  >0 iff a,b,c are CCW.
inline int orient2d(const Pt& a, const Pt& b, const Pt& c) {
  i128 det = (i128)(b.x - a.x) * (c.y - a.y) - (i128)(b.y - a.y) * (c.x - a.x);
  return det > 0 ? 1 : (det < 0 ? -1 : 0);
}

// Sign of the incircle determinant: >0 iff d is strictly inside the
// circumcircle of CCW triangle (a, b, c).
//
// Fast path: a Shewchuk-style static floating-point filter.  The int64
// coordinate differences are <= 2^34 so they convert to double EXACTLY;
// the double determinant then carries <= ~8 eps relative to the
// permanent (sum of absolute products), and a 32-eps margin makes the
// sign decision rigorous.  Only near-cocircular queries (|det| below
// the bound) fall through to the exact 256-bit evaluation — in Ruppert
// refinement that is a fraction of a percent of calls, and the exact
// path costs ~10x the filter (software 128x128 multiplies).
inline int incircle(const Pt& a, const Pt& b, const Pt& c, const Pt& d) {
  const double adx = (double)(a.x - d.x), ady = (double)(a.y - d.y);
  const double bdx = (double)(b.x - d.x), bdy = (double)(b.y - d.y);
  const double cdx = (double)(c.x - d.x), cdy = (double)(c.y - d.y);
  const double bdxcdy = bdx * cdy, cdxbdy = cdx * bdy;
  const double cdxady = cdx * ady, adxcdy = adx * cdy;
  const double adxbdy = adx * bdy, bdxady = bdx * ady;
  const double alift = adx * adx + ady * ady;
  const double blift = bdx * bdx + bdy * bdy;
  const double clift = cdx * cdx + cdy * cdy;
  const double det = alift * (bdxcdy - cdxbdy) + blift * (cdxady - adxcdy) +
                     clift * (adxbdy - bdxady);
  const double perm = alift * (std::abs(bdxcdy) + std::abs(cdxbdy)) +
                      blift * (std::abs(cdxady) + std::abs(adxcdy)) +
                      clift * (std::abs(adxbdy) + std::abs(bdxady));
  constexpr double ERR = 32 * 1.1102230246251565e-16;  // 32 eps
  if (det > ERR * perm) return 1;
  if (det < -ERR * perm) return -1;

  i128 iadx = a.x - d.x, iady = a.y - d.y;
  i128 ibdx = b.x - d.x, ibdy = b.y - d.y;
  i128 icdx = c.x - d.x, icdy = c.y - d.y;
  i128 ialift = iadx * iadx + iady * iady;
  i128 iblift = ibdx * ibdx + ibdy * ibdy;
  i128 iclift = icdx * icdx + icdy * icdy;
  i128 bcdet = ibdx * icdy - icdx * ibdy;
  i128 cadet = icdx * iady - iadx * icdy;
  i128 abdet = iadx * ibdy - ibdx * iady;
  I256 idet = I256::mul(ialift, bcdet) + I256::mul(iblift, cadet) +
              I256::mul(iclift, abdet);
  return idet.sign;
}

// True when p lies on the closed segment [a, b] (collinear and between).
inline bool on_segment(const Pt& a, const Pt& b, const Pt& p) {
  if (orient2d(a, b, p) != 0) return false;
  i128 dot = (i128)(p.x - a.x) * (b.x - a.x) + (i128)(p.y - a.y) * (b.y - a.y);
  if (dot < 0) return false;
  i128 len2 = (i128)(b.x - a.x) * (b.x - a.x) + (i128)(b.y - a.y) * (b.y - a.y);
  return dot <= len2;
}

// True when p lies strictly inside the open segment (a, b).
inline bool on_open_segment(const Pt& a, const Pt& b, const Pt& p) {
  return on_segment(a, b, p) && p != a && p != b;
}

// Proper crossing test: segments (a,b) and (c,d) intersect in a single
// point interior to both.
inline bool proper_crossing(const Pt& a, const Pt& b, const Pt& c, const Pt& d) {
  int o1 = orient2d(a, b, c), o2 = orient2d(a, b, d);
  int o3 = orient2d(c, d, a), o4 = orient2d(c, d, b);
  return (o1 * o2 < 0) && (o3 * o4 < 0);
}

// Intersection point of properly-crossing segments, rounded to the grid.
inline Pt segment_intersection_rounded(const Pt& a, const Pt& b,
                                       const Pt& c, const Pt& d) {
  // p = a + t*(b-a), t = cross(c-a, d-c) / cross(b-a, d-c)
  i128 num = (i128)(c.x - a.x) * (d.y - c.y) - (i128)(c.y - a.y) * (d.x - c.x);
  i128 den = (i128)(b.x - a.x) * (d.y - c.y) - (i128)(b.y - a.y) * (d.x - c.x);
  // den != 0 for a proper crossing.  Use long double for the final rounding;
  // |num/den| <= 1 so precision is ample.
  long double t = (long double)num / (long double)den;
  long double x = (long double)a.x + t * (long double)(b.x - a.x);
  long double y = (long double)a.y + t * (long double)(b.y - a.y);
  return Pt{(i64)llroundl(x), (i64)llroundl(y)};
}

// Encroachment: vertex p lies inside (or on) the diametral circle of (a,b).
inline bool in_diametral_circle(const Pt& a, const Pt& b, const Pt& p) {
  i128 dot = (i128)(a.x - p.x) * (b.x - p.x) + (i128)(a.y - p.y) * (b.y - p.y);
  return dot < 0;
}

inline double dist(const Pt& a, const Pt& b) {
  double dx = double(a.x - b.x), dy = double(a.y - b.y);
  return std::sqrt(dx * dx + dy * dy);
}

inline i128 dist2(const Pt& a, const Pt& b) {
  return (i128)(a.x - b.x) * (a.x - b.x) + (i128)(a.y - b.y) * (a.y - b.y);
}

struct GeomError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

}  // namespace pg
