// K1 — block-offset DIA slab SpMV for Hopper (sm_90a).
//
// Replaces the TPU kernel padne_tpu/ops/dia.py `_pallas_main` (its
// pallas_call at dia.py:926) and the slot term it carries (dia.py:866-899).
//
// Computes, for row block rb (128 rows) and right-hand side r,
//
//   y[r, rb*128 + c] = sum_o sum_k x[r, (rb+o)*128 + k] * W[rb, o, k, c]
//                    + sum_e we[rb, e, c] * x[r, tgt[rb, e]*128 + ci[rb, e, c]]
//
// W is (nb, D, 128, 128) in f32 or bf16 (bf16 widens to f32 exactly);
// x and y are (R, np) f32 with np = nb * 128.  Column blocks outside
// [0, nb) contribute nothing (the TPU kernel reads a zero halo there).
//
// What bounds it: the slab stream.  Every W element is read once per call
// and used for R fused multiply-adds, so at the main path's R <= 8 it is
// bandwidth-bound on W (4 or 2 bytes per element).  Design for that, kept
// simple on purpose:
//   * one 128-thread block per 128-row block; thread c owns output column
//     c, so each k-step reads one contiguous W row (coalesced);
//   * per offset, the (RC, 128) x slice is staged in shared memory and read
//     as a broadcast; no TPU-style (g + 2*dmax)*128 window is staged (at
//     dmax 32 that window exceeds shared memory);
//   * the slot term is a direct gather (the TPU one-hot dot is a workaround);
//   * true f32 FMAs only: no TF32, no tensor cores in this version;
//   * RHS columns are processed RC at a time (grid.y chunks), so register
//     use is bounded for any R.
// W offsets are computed in 64 bits: nb*D*128*128 passes 2^31 at the
// sizes the solver runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 128;
constexpr int MAX_D = 32;

struct Offsets {
  int v[MAX_D];
};

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

// bf16 stored as raw 16-bit patterns: widening is a 16-bit shift.
__device__ __forceinline__ float load_w(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <int RC, typename WT>
__global__ void __launch_bounds__(B)
dia_slab_kernel(const float* __restrict__ x, int64_t np_,
                const WT* __restrict__ w, int d, Offsets offs, int r_total,
                const int* __restrict__ tgt, const int* __restrict__ ci,
                const float* __restrict__ we, int e_slots,
                float* __restrict__ y) {
  const int64_t nb = np_ / B;
  const int64_t rb = blockIdx.x;
  const int r0 = blockIdx.y * RC;
  const int c = threadIdx.x;
  __shared__ float xs[RC][B];

  float acc[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) acc[r] = 0.0f;

  for (int di = 0; di < d; ++di) {
    const int64_t cb = rb + offs.v[di];
    if (cb < 0 || cb >= nb) continue;  // uniform over the block
    __syncthreads();                   // previous slice fully consumed
#pragma unroll
    for (int r = 0; r < RC; ++r)
      xs[r][c] = (r0 + r < r_total) ? x[(r0 + r) * np_ + cb * B + c] : 0.0f;
    __syncthreads();
    const WT* wp = w + ((rb * d + di) * B) * B + c;
#pragma unroll 8
    for (int k = 0; k < B; ++k) {
      const float wv = load_w(wp + k * B);
#pragma unroll
      for (int r = 0; r < RC; ++r) acc[r] = fmaf(xs[r][k], wv, acc[r]);
    }
  }

  for (int e = 0; e < e_slots; ++e) {
    const int64_t s = rb * e_slots + e;
    const int64_t col = static_cast<int64_t>(tgt[s]) * B + ci[s * B + c];
    const float wv = we[s * B + c];
#pragma unroll
    for (int r = 0; r < RC; ++r)
      if (r0 + r < r_total) acc[r] = fmaf(wv, x[(r0 + r) * np_ + col], acc[r]);
  }

#pragma unroll
  for (int r = 0; r < RC; ++r)
    if (r0 + r < r_total) y[(r0 + r) * np_ + rb * B + c] = acc[r];
}

template <int RC>
void launch(dim3 grid, cudaStream_t stream, const float* x, int64_t np_,
            const void* w, int w_bf16, int d, const Offsets& offs, int r,
            const int* tgt, const int* ci, const float* we, int e,
            float* y) {
  if (w_bf16)
    dia_slab_kernel<RC, uint16_t><<<grid, B, 0, stream>>>(
        x, np_, static_cast<const uint16_t*>(w), d, offs, r, tgt, ci, we, e,
        y);
  else
    dia_slab_kernel<RC, float><<<grid, B, 0, stream>>>(
        x, np_, static_cast<const float*>(w), d, offs, r, tgt, ci, we, e, y);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
extern "C" int pg_dia_slab(const float* x, int64_t np_, const void* w,
                           int w_bf16, int d, const int* offs, int r,
                           const int* tgt, const int* ci, const float* we,
                           int e, float* y, void* stream) {
  if (d < 1 || d > MAX_D || np_ <= 0 || np_ % B || r < 1 || e < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets o;
  for (int i = 0; i < d; ++i) o.v[i] = offs[i];
  const int rc = r <= 1 ? 1 : r <= 2 ? 2 : r <= 4 ? 4 : 8;
  const dim3 grid(static_cast<unsigned>(np_ / B), (r + rc - 1) / rc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rc) {
    case 1: launch<1>(grid, s, x, np_, w, w_bf16, d, o, r, tgt, ci, we, e, y); break;
    case 2: launch<2>(grid, s, x, np_, w, w_bf16, d, o, r, tgt, ci, we, e, y); break;
    case 4: launch<4>(grid, s, x, np_, w, w_bf16, d, o, r, tgt, ci, we, e, y); break;
    default: launch<8>(grid, s, x, np_, w, w_bf16, d, o, r, tgt, ci, we, e, y); break;
  }
  return static_cast<int>(cudaGetLastError());
}
