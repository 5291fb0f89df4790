// K2 — compensated (f64-exact) slab residual for Hopper (sm_90a).
//
// Replaces the TPU kernel padne_tpu/ops/comp.py `_pallas_comp_slab` (its
// pallas_call at comp.py:366).
//
// Computes the main-slab part of y = A64 @ x for f32 x, where the f64
// operator is split into an f32 hi slab W and its exact f32 lo-half W_lo
// (A64 = W + W_lo entrywise):
//
//   y[rb*128 + c] = sum_o sum_k (W + W_lo)[rb, o, k, c] * x[(rb+o)*128 + k]
//
// The TPU has no f64, so the JAX kernel builds this from f32 error-free
// transforms (Dekker two-product, Knuth two-sum tree down to 8 sublane
// partials).  Hopper has native f64, and an f32 x f32 product is exact in
// f64, so this kernel accumulates (double)W*x + (double)W_lo*x in f64 and
// writes one f64 vector; the caller adds the remainder, the diagonal and
// the tail in f64 (padne_tpu_torch/ops/comp.py `matvec_slab`).  Error:
// f64 rounding of the sums only, ~1e-16 of sum |A||x| per row.
//
// What bounds it: the two slab streams (8 bytes per W element) with R = 1
// and two f64 FMAs per element: bandwidth-bound.  Same layout as K1: one
// 128-thread block per row block, thread c owns column c (coalesced W
// rows), the 128-entry x slice of each offset staged in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int B = 128;
constexpr int MAX_D = 32;

struct Offsets {
  int v[MAX_D];
};

__global__ void __launch_bounds__(B)
comp_slab_kernel(const float* __restrict__ x, int64_t np_,
                 const float* __restrict__ w, const float* __restrict__ w_lo,
                 int d, Offsets offs, double* __restrict__ y) {
  const int64_t nb = np_ / B;
  const int64_t rb = blockIdx.x;
  const int c = threadIdx.x;
  __shared__ double xs[B];
  double acc = 0.0;
  for (int di = 0; di < d; ++di) {
    const int64_t cb = rb + offs.v[di];
    if (cb < 0 || cb >= nb) continue;  // uniform over the block
    __syncthreads();
    xs[c] = static_cast<double>(x[cb * B + c]);
    __syncthreads();
    const int64_t base = ((rb * d + di) * B) * B + c;
    const float* wp = w + base;
    const float* lp = w_lo + base;
#pragma unroll 8
    for (int k = 0; k < B; ++k) {
      acc = fma(static_cast<double>(__ldg(wp + k * B)), xs[k], acc);
      acc = fma(static_cast<double>(__ldg(lp + k * B)), xs[k], acc);
    }
  }
  y[rb * B + c] = acc;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Enqueues on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
extern "C" int pg_comp_slab(const float* x, int64_t np_, const float* w,
                            const float* w_lo, int d, const int* offs,
                            double* y, void* stream) {
  if (d < 1 || d > MAX_D || np_ <= 0 || np_ % B)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets o;
  for (int i = 0; i < d; ++i) o.v[i] = offs[i];
  comp_slab_kernel<<<static_cast<unsigned>(np_ / B), B, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, np_, w, w_lo, d, o, y);
  return static_cast<int>(cudaGetLastError());
}
