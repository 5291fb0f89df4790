// K1' and K2' — sliced-ELL SpMV of the DIA route's operators for Hopper
// (sm_90a).
//
// K1' replaces the TPU kernel padne_tpu/ops/dia.py `_pallas_main` (its
// pallas_call at dia.py:926) with the slot term it carries and the
// diagonal and remainder passes around it (dia.py `dia_matvec_t`):
//
//   y[r, i] = diag[i] * x[r, i] + sum_j A[i, j] * x[r, j]   (f32 accumulation)
//
// for x, y of shape (R, np) f32, any R.  K2' replaces padne_tpu/ops/comp.py
// `_pallas_comp_slab` (pallas_call at comp.py:366) with the remainder and
// diagonal terms of `matvec_slab` around it:
//
//   y[i] = diag64[i] * x[i] + sum_j (hi[i, j] + lo[i, j]) * x[j]   (f64)
//
// for f32 x, where hi is the f32 CG operator and lo its exact f32
// lo-half; f32 x f32 products are exact in f64, so K2' accumulates
// (double)hi*x + (double)lo*x with f64 FMAs.
//
// The format (built by padne_tpu_torch/ops/dia.py `build_sell`) stores
// nonzeros only.  The TPU kernels stream dense 128 x 128 weight blocks on a
// few block offsets because the TPU's matrix unit wants dense tiles and
// Mosaic cannot gather; on the 1M-DoF board about 1% of those entries are
// nonzero, so on this card the dense blocks cost ~50x the bytes.  Instead:
//   * rows are sorted by length within each 128-row block and cut into
//     slices of 32 rows; a slice's entries are stored K-major, slot k of
//     its 32 rows contiguous, padded to its longest row;
//   * part A: an int16 per entry, its column less the first row of its row
//     block (the Hilbert order keeps nearly every entry within that reach),
//     and a value in f32 or bf16;
//   * part B, same slices: int32 columns and f32 values, for the entries
//     farther away and for those a bf16 operator keeps in f32;
//   * a dense diagonal.
//
// What bounds it: bytes.  A call must read every nonzero once (2 B of index
// + 2 or 4 B of value in part A, 8 B in part B, 4 more for K2's lo halves),
// the diagonal and x, and write y; it does two flops per entry and RHS, a
// fraction of a flop per byte.  Design: one warp per slice and chunk of up
// to 4 RHS columns; each lane owns one row and accumulates the chunk's
// columns, so one index and value load serves every column of the chunk (a
// warp per (slice, column) reached 25% of the stored-bytes bound at R = 4
// on level 0, the entry stream re-read per column).  Levels too small to
// give two waves of warps that way are latency-bound (L2-resident), and
// there narrower chunks, down to one column per lane, buy the warps that
// hide the gathers' latency.  A slot's index and value loads are coalesced
// across the warp, the loop over the slice's width is uniform, and a part-A
// column is one add away from its index (no table to load first).  x is
// gathered directly (through L1/L2).  Blocks hold 1-4 warps, fewer when the
// launch would otherwise leave SMs idle (the coarsest level has 11k rows).
// Index arithmetic is 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_info.cuh"

namespace {

constexpr int SLICE = 32;
constexpr int ROW_BLOCK = 128;
constexpr int MAX_WARPS = 4;
constexpr int WARPS_PER_SM = 64;  // resident warps per SM on sm_90

struct Sell {
  const int32_t* perm;      // (np) row at each slice-lane position
  const int64_t* a_ptr;     // (np/32 + 1) entry offsets of part A's slices
  const int16_t* a_idx;     // column less the row block's first row
  const int64_t* b_ptr;     // (np/32 + 1) entry offsets of part B's slices
  const int32_t* b_col;
  int64_t np;
};

__device__ __forceinline__ float widen(float v) { return v; }

// bf16 stored as raw 16-bit patterns: widening is a 16-bit shift.
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// First row of the row block that holds `slice`: part A's column base.
__device__ __forceinline__ int64_t a_base(int64_t slice) {
  return slice * SLICE / ROW_BLOCK * ROW_BLOCK;
}

template <int RC, typename VT>
__global__ void __launch_bounds__(MAX_WARPS * SLICE)
dia_sell_kernel(Sell s, const VT* __restrict__ a_val,
                const float* __restrict__ b_val,
                const float* __restrict__ diag, const float* __restrict__ x,
                int r_total, float* __restrict__ y) {
  const int64_t chunks = (r_total + RC - 1) / RC;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / SLICE) +
      threadIdx.x / SLICE;
  const int lane = threadIdx.x % SLICE;
  if (warp >= (s.np / SLICE) * chunks) return;  // uniform over the warp
  const int64_t slice = warp / chunks;
  const int r0 = static_cast<int>(warp - slice * chunks) * RC;
  const int nr = min(RC, r_total - r0);
  const float* xr = x + r0 * s.np;
  const int64_t base = a_base(slice);
  float acc[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) acc[i] = 0.0f;
  const int64_t a_end = __ldg(s.a_ptr + slice + 1);
#pragma unroll 4
  for (int64_t e = __ldg(s.a_ptr + slice) + lane; e < a_end; e += SLICE) {
    const float v = widen(__ldg(a_val + e));
    const int64_t col = base + __ldg(s.a_idx + e);
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (i < nr) acc[i] = fmaf(v, __ldg(xr + i * s.np + col), acc[i]);
  }
  const int64_t b_end = __ldg(s.b_ptr + slice + 1);
  for (int64_t e = __ldg(s.b_ptr + slice) + lane; e < b_end; e += SLICE) {
    const float v = __ldg(b_val + e);
    const int64_t col = __ldg(s.b_col + e);
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (i < nr) acc[i] = fmaf(v, __ldg(xr + i * s.np + col), acc[i]);
  }
  const int64_t row = __ldg(s.perm + slice * SLICE + lane);
  const float d = __ldg(diag + row);
#pragma unroll
  for (int i = 0; i < RC; ++i)
    if (i < nr)
      y[(r0 + i) * s.np + row] = fmaf(d, __ldg(xr + i * s.np + row), acc[i]);
}

__global__ void __launch_bounds__(MAX_WARPS * SLICE)
comp_sell_kernel(Sell s, const float* __restrict__ a_hi,
                 const float* __restrict__ a_lo,
                 const float* __restrict__ b_hi,
                 const float* __restrict__ b_lo,
                 const double* __restrict__ diag,
                 const float* __restrict__ x, double* __restrict__ y) {
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / SLICE) +
      threadIdx.x / SLICE;
  const int lane = threadIdx.x % SLICE;
  if (slice >= s.np / SLICE) return;
  const int64_t base = a_base(slice);
  double acc = 0.0;
  const int64_t a_end = __ldg(s.a_ptr + slice + 1);
#pragma unroll 4
  for (int64_t e = __ldg(s.a_ptr + slice) + lane; e < a_end; e += SLICE) {
    const double xv = __ldg(x + base + __ldg(s.a_idx + e));
    acc = fma(static_cast<double>(__ldg(a_hi + e)), xv, acc);
    acc = fma(static_cast<double>(__ldg(a_lo + e)), xv, acc);
  }
  const int64_t b_end = __ldg(s.b_ptr + slice + 1);
  for (int64_t e = __ldg(s.b_ptr + slice) + lane; e < b_end; e += SLICE) {
    const double xv = __ldg(x + __ldg(s.b_col + e));
    acc = fma(static_cast<double>(__ldg(b_hi + e)), xv, acc);
    acc = fma(static_cast<double>(__ldg(b_lo + e)), xv, acc);
  }
  const int64_t row = __ldg(s.perm + slice * SLICE + lane);
  y[row] = fma(__ldg(diag + row), static_cast<double>(__ldg(x + row)), acc);
}

// RHS columns per lane: up to 4, halved while the launch would give fewer
// than two full waves of warps.
int rhs_chunk(int64_t slices, int r) {
  const int64_t two_waves = 2 * sm_count() * WARPS_PER_SM;
  int rc = r == 1 ? 1 : r == 2 ? 2 : 4;
  while (rc > 1 && slices * ((r + rc - 1) / rc) < two_waves) rc /= 2;
  return rc;
}

// Warps per block: MAX_WARPS, halved while the grid would give fewer than
// two blocks per SM.
int warps_per_block(int64_t warps) {
  int w = MAX_WARPS;
  while (w > 1 && (warps + w - 1) / w < 2 * sm_count()) w /= 2;
  return w;
}

bool valid(const Sell& s) {
  return s.np > 0 && s.np % ROW_BLOCK == 0;
}

template <int RC, typename VT>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const Sell& s,
            const void* a_val, const float* b_val, const float* diag,
            const float* x, int r, float* y) {
  dia_sell_kernel<RC, VT><<<grid, block, 0, stream>>>(
      s, static_cast<const VT*>(a_val), b_val, diag, x, r, y);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Enqueue on `stream`, do not
// synchronise, return cudaGetLastError() (0 on success).
extern "C" int pg_dia_sell(const int32_t* perm, const int64_t* a_ptr,
                           const int16_t* a_idx, const int64_t* b_ptr,
                           const int32_t* b_col, const void* a_val,
                           int a_bf16, const float* b_val, const float* diag,
                           const float* x, int64_t np_, int r, float* y,
                           void* stream) {
  const Sell s{perm, a_ptr, a_idx, b_ptr, b_col, np_};
  if (!valid(s) || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = rhs_chunk(np_ / SLICE, r);
  const int64_t warps = np_ / SLICE * ((r + rc - 1) / rc);
  const int w = warps_per_block(warps);
  const int64_t blocks = (warps + w - 1) / w;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks)), block(w * SLICE);
  switch (rc + 8 * a_bf16) {
    case 1: launch<1, float>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
    case 2: launch<2, float>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
    case 4: launch<4, float>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
    case 9: launch<1, uint16_t>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
    case 10: launch<2, uint16_t>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
    default: launch<4, uint16_t>(grid, block, st, s, a_val, b_val, diag, x, r, y); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pg_comp_sell(const int32_t* perm, const int64_t* a_ptr,
                            const int16_t* a_idx, const int64_t* b_ptr,
                            const int32_t* b_col, const float* a_hi,
                            const float* a_lo, const float* b_hi,
                            const float* b_lo, const double* diag,
                            const float* x, int64_t np_, double* y,
                            void* stream) {
  const Sell s{perm, a_ptr, a_idx, b_ptr, b_col, np_};
  if (!valid(s)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = np_ / SLICE;
  const int w = warps_per_block(warps);
  comp_sell_kernel<<<static_cast<unsigned>((warps + w - 1) / w), w * SLICE,
                     0, static_cast<cudaStream_t>(stream)>>>(
      s, a_hi, a_lo, b_hi, b_lo, diag, x, y);
  return static_cast<int>(cudaGetLastError());
}
