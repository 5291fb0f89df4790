// K3' — sparse matrix times multivector of the generic ELL route, with the
// V-cycle's elementwise lines fused in, for Hopper (sm_90a).
//
// Replaces both TPU ELL SpMV kernels of padne_tpu/ops/spmv_pallas.py:
// `make_banded_spmv` (K3a, its pallas_call at spmv_pallas.py:146) and
// `make_vmem_spmv` (K3b, pallas_call at :204).  It computes the function of
// the generic route's matvec (padne_tpu/ops/spmv.py `ell_matvec`, the
// einsums of padne_tpu/ops/amg.py `make_vcycle` and cg.py `make_pcg`):
//
//   square:       s[i, r] = diag[i] * x[i, r] + sum_k vals[i, k] * x[cols[i, k], r]
//   rectangular:  s[i, r] =                     sum_k vals[i, k] * x[cols[i, k], r]
//
// (the rectangular form is the AMG prolongation / restriction, where x has
// another row count than y; pass diag = nullptr), and writes
//
//   y = x0 + w * (b - s)      each of x0 (n, R), w (n), b (n, R) may be null
//
// so one launch is the residual b - A x, the damped-Jacobi step
// x0 + w * (b - A x) or the prolongation x0 + P xc, as well as the plain
// product.  x and y are row-major (rows, R) in f32 or f64, any R >= 1.
//
// The TPU variants work around the TPU's missing vector gather: K3a builds a
// one-hot tile per 128 rows (iota == index) and multiplies a 3-block x
// window on the MXU after an RCM banding; K3b keeps all of x resident in
// VMEM.  Hopper gathers directly, so neither is carried over.
//
// What bounds it.  By the count, bytes: a call must read every nonzero once
// (4 B of column + 4 or 8 B of value), the diagonal, x and the epilogue
// operands, and write y, for two flops per nonzero and RHS column.  But the
// operands of every product of the route (at most ~18 MB, on the largest
// level the auto route sends here) fit the 50 MB L2 and stay there between
// the calls of a solve, and most calls are on levels of a few thousand rows:
// what a call waits for is its chain of dependent loads (slice offset ->
// column -> x row -> epilogue operand) and, on small levels, the lack of
// other warps to hide it.  Design, on the format of
// padne_tpu_torch/ops/spmv.py `build_operator`:
//   * nonzeros only: rows sorted by length within windows, slices of 32
//     lanes padded to their own longest lane, stored step-major so a warp
//     reads 32 neighbouring columns and values per step;
//   * `lanes` (a power of two up to 32, chosen per operator at upload)
//     neighbouring lanes share a row and add up with warp shuffles, so a
//     row of 200 entries is 7 steps of 32 lanes instead of 200 steps of one
//     thread, and a 223-row restriction spreads over 223 warps;
//   * a lane takes up to 4 RHS columns of its entry: the column and value
//     are read once per entry, and with R a multiple of the chunk the x row
//     is one aligned 16-byte load (two for f64 x 4); wider R is chunked over
//     blockIdx.y, so no thread divides;
//   * the entry loop runs in groups of 4 steps: four index and value loads
//     (predicated on the slice's end), then four gathers, are in flight
//     per lane before the first FMA;
//   * the epilogue operands of a row are loaded before the entry loop, off
//     the critical chain.
// Offsets into x, y and the entry arrays are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_info.cuh"

namespace {

constexpr int SLICE = 32;
constexpr int MAX_WARPS = 4;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

// RC values of type T as one object that aligned 16-byte (or 8-byte)
// accesses can move.
template <typename T, int RC>
struct alignas(sizeof(T) * RC > 16 ? 16 : sizeof(T) * RC) Pack {
  T v[RC];
};

// out[0..RC) = p[0..nr), zero beyond nr; `vec`: p is aligned for Pack and
// nr == RC.
template <typename T, int RC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int nr,
                                         bool vec, T (&out)[RC]) {
  if (RC > 1 && vec) {
    const Pack<T, RC> pk = *reinterpret_cast<const Pack<T, RC>*>(p);
#pragma unroll
    for (int i = 0; i < RC; ++i) out[i] = pk.v[i];
  } else {
#pragma unroll
    for (int i = 0; i < RC; ++i) out[i] = i < nr ? __ldg(p + i) : T(0);
  }
}

template <typename T, int RC>
__device__ __forceinline__ void store_row(T* __restrict__ p, int nr, bool vec,
                                          const T (&in)[RC]) {
  if (RC > 1 && vec) {
    Pack<T, RC> pk;
#pragma unroll
    for (int i = 0; i < RC; ++i) pk.v[i] = in[i];
    *reinterpret_cast<Pack<T, RC>*>(p) = pk;
  } else {
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (i < nr) p[i] = in[i];
  }
}

struct Op {
  const int32_t* perm;  // (n) row at each sorted position
  const int64_t* ptr;   // (slices + 1) entry offsets
  const int32_t* col;
  int64_t n;
  int64_t slices;
  int lane_shift;       // log2(lanes per row)
};

template <typename T, int RC>
__global__ void __launch_bounds__(MAX_WARPS * SLICE)
ell_sell_kernel(Op op, const T* __restrict__ val, const T* __restrict__ diag,
                const T* __restrict__ x, int r_total, bool vec,
                const T* __restrict__ b, const T* __restrict__ w,
                const T* __restrict__ x0, T* __restrict__ y) {
  const int64_t slice =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / SLICE) +
      threadIdx.x / SLICE;
  if (slice >= op.slices) return;  // uniform over the warp
  const int lane = threadIdx.x % SLICE;
  const int r0 = blockIdx.y * RC;
  const int nr = min(RC, r_total - r0);
  const int64_t e_begin = __ldg(op.ptr + slice);
  const int64_t e_end = __ldg(op.ptr + slice + 1);

  // The lane that writes a row loads what the epilogue needs now, so that
  // these loads overlap the entry loop.
  const int64_t q = (slice * SLICE + lane) >> op.lane_shift;
  const bool writer = (lane & ((1 << op.lane_shift) - 1)) == 0 && q < op.n;
  int64_t out = 0;
  T dv = T(0), wv = T(1);
  T xs[RC], bs[RC], x0s[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) xs[i] = bs[i] = x0s[i] = T(0);
  if (writer) {
    const int64_t row = __ldg(op.perm + q);
    out = row * r_total + r0;
    if (diag != nullptr) {
      dv = __ldg(diag + row);
      load_row<T, RC>(x + out, nr, vec, xs);
    }
    if (b != nullptr) load_row<T, RC>(b + out, nr, vec, bs);
    if (w != nullptr) wv = __ldg(w + row);
    if (x0 != nullptr) load_row<T, RC>(x0 + out, nr, vec, x0s);
  }

  T acc[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i) acc[i] = T(0);
  const T* xr = x + r0;
  // Steps go in groups of UNROLL: the index and value loads of a group are
  // predicated on the slice's end (a dead step reads nothing and multiplies
  // x's row 0 by zero), so a short slice has all its gathers in flight at
  // once, and there is no remainder loop.
  for (int64_t e = e_begin + lane; e < e_end; e += UNROLL * SLICE) {
    int32_t c[UNROLL];
    T v[UNROLL];
    T xv[UNROLL][RC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool live = e + u * SLICE < e_end;
      c[u] = live ? __ldg(op.col + e + u * SLICE) : 0;
      v[u] = live ? __ldg(val + e + u * SLICE) : T(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_row<T, RC>(xr + static_cast<int64_t>(c[u]) * r_total, nr, vec,
                      xv[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < RC; ++i) acc[i] = fma(v[u], xv[u][i], acc[i]);
  }
  // The lanes of a row add up; every lane of the warp takes part (the loop
  // above is uniform: a slice's lanes all hold (e_end - e_begin) / 32 steps).
  for (int off = (1 << op.lane_shift) >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < RC; ++i)
      acc[i] += __shfl_xor_sync(FULL, acc[i], off);
  if (!writer) return;
#pragma unroll
  for (int i = 0; i < RC; ++i) {
    T s = fma(dv, xs[i], acc[i]);
    if (b != nullptr) s = bs[i] - s;
    acc[i] = fma(wv, s, x0s[i]);
  }
  store_row<T, RC>(y + out, nr, vec, acc);
}

// Warps per block: MAX_WARPS, halved while the grid would give fewer than
// two blocks per SM.
int warps_per_block(int64_t warps) {
  int w = MAX_WARPS;
  while (w > 1 && (warps + w - 1) / w < 2 * sm_count()) w /= 2;
  return w;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int RC>
int launch(const Op& op, const void* val, const void* diag, const void* x,
           int r, const void* b, const void* w, const void* x0, void* y,
           cudaStream_t stream) {
  const int chunks = (r + RC - 1) / RC;
  const int wpb = warps_per_block(op.slices * chunks);
  const int64_t blocks = (op.slices + wpb - 1) / wpb;
  if (blocks > 0x7fffffffLL || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // Vector loads and stores of a row's chunk: every chunk full, every row
  // of x, b, x0 and y aligned to the access.
  const size_t access = sizeof(T) * RC > 16 ? 16 : sizeof(T) * RC;
  const bool vec = RC > 1 && r % RC == 0 && aligned(x, access) &&
                   aligned(y, access) && aligned(b, access) &&
                   aligned(x0, access);
  ell_sell_kernel<T, RC>
      <<<dim3(static_cast<unsigned>(blocks), chunks), wpb * SLICE, 0,
         stream>>>(op, static_cast<const T*>(val),
                   static_cast<const T*>(diag), static_cast<const T*>(x), r,
                   vec, static_cast<const T*>(b), static_cast<const T*>(w),
                   static_cast<const T*>(x0), static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rc(const Op& op, const void* val, const void* diag, const void* x,
              int r, const void* b, const void* w, const void* x0, void* y,
              cudaStream_t s) {
  if (r == 1) return launch<T, 1>(op, val, diag, x, r, b, w, x0, y, s);
  if (r == 2) return launch<T, 2>(op, val, diag, x, r, b, w, x0, y, s);
  return launch<T, 4>(op, val, diag, x, r, b, w, x0, y, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  f64 != 0 selects double, else
// float; diag (rectangular form), b, w and x0 may be null.  The columns are
// not checked against x's row count here: `build_operator` does, once.
// Enqueues on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success).
extern "C" int pg_ell_spmv(int f64, const int32_t* perm, const int64_t* ptr,
                           const int32_t* col, const void* val,
                           const void* diag, int lanes, int64_t n,
                           const void* x, int r, const void* b, const void* w,
                           const void* x0, void* y, void* stream) {
  if (n <= 0 || r < 1 || lanes < 1 || lanes > SLICE || (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  int shift = 0;
  while ((1 << shift) < lanes) ++shift;
  const Op op{perm, ptr, col, n, (n * lanes + SLICE - 1) / SLICE, shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_rc<double>(op, val, diag, x, r, b, w, x0, y, s)
             : launch_rc<float>(op, val, diag, x, r, b, w, x0, y, s);
}
