// K3 — ELL sparse matrix times multivector for Hopper (sm_90a).
//
// Replaces both TPU ELL SpMV kernels of padne_tpu/ops/spmv_pallas.py:
// `make_banded_spmv` (K3a, its pallas_call at spmv_pallas.py:146) and
// `make_vmem_spmv` (K3b, pallas_call at :204).  It computes the function
// of the generic ELL route's matvec (padne_tpu/ops/spmv.py `ell_matvec`,
// the einsums of padne_tpu/ops/amg.py `make_vcycle` and cg.py `make_pcg`):
//
//   square:       y[i, r] = diag[i] * x[i, r] + sum_k vals[k, i] * x[cols[k, i], r]
//   rectangular:  y[i, r] =                     sum_k vals[k, i] * x[cols[k, i], r]
//
// (the rectangular form is the AMG prolongation / restriction, where x has
// another row count than y; pass diag = nullptr).  x and y are row-major
// (rows, R) in f32 or f64, any R >= 1.  ELL padding entries carry a zero
// value and point at the row itself (square) or at row 0 (rectangular), so
// they gather a valid x row and add nothing.
//
// Layout: cols/vals are stored K-major, (K, n) — the transposed ELL arrays,
// laid out once at upload by padne_tpu_torch/ops/spmv.py `to_kmajor` — so
// that the 32 rows of a warp read slot k of cols and vals from 32
// neighbouring addresses.  The rectangular form does not check that cols
// index rows of x: the caller checks once at upload (ops/amg.py
// `make_vcycle`).
//
// The TPU variants work around the TPU's missing vector gather: K3a builds a
// one-hot tile per 128 rows (iota == index) and multiplies a 3-block x
// window on the MXU after an RCM banding; K3b keeps all of x resident in
// VMEM.  Hopper gathers directly, so neither is carried over.
//
// What bounds it: bytes.  Each call must move cols (4 B) + vals + diag + x +
// y (4 or 8 B each): (4 + s) * K * n + s * n + s * nx * R + s * n * R bytes,
// over the 3.35 TB/s HBM peak; it does 2 * K * n * R + 2 * n * R flops, a
// fraction of a flop per byte.  Design, simple on purpose: one thread per
// output element (row i, RHS column r), r fastest, so R threads of a row
// share the broadcast cols/vals loads and gather R neighbouring x values;
// for R = 1 this is the classic one-thread-per-row ELL kernel with fully
// coalesced cols/vals loads.  All index products are 64-bit (levels reach
// millions of rows, and n * R and K * n pass 2^31 there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ diag, const T* __restrict__ x,
                int64_t n, int k, int r, T* __restrict__ y) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= n * r) return;
  const int64_t i = t / r;
  const int64_t c = t - i * r;
  T acc = T(0);
  for (int s = 0; s < k; ++s) {
    const int64_t e = static_cast<int64_t>(s) * n + i;
    const int64_t j = __ldg(cols + e);
    acc = fma(__ldg(vals + e), __ldg(x + j * r + c), acc);
  }
  if (diag != nullptr) acc = fma(__ldg(diag + i), __ldg(x + t), acc);
  y[t] = acc;
}

template <typename T>
int launch(const int* cols, const void* vals, const void* diag,
           const void* x, int64_t n, int k, int r, void* y,
           cudaStream_t stream) {
  const int64_t total = n * r;
  const int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ell_spmv_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      cols, static_cast<const T*>(vals), static_cast<const T*>(diag),
      static_cast<const T*>(x), n, k, r, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  f64 != 0 selects double, else
// float; diag may be null (rectangular form).  Enqueues on `stream`, does
// not synchronise, returns cudaGetLastError() (0 on success).
extern "C" int pg_ell_spmv(int f64, const int* cols, const void* vals,
                           const void* diag, const void* x, int64_t n, int k,
                           int r, void* y, void* stream) {
  if (n <= 0 || k < 1 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(cols, vals, diag, x, n, k, r, y, s)
             : launch<float>(cols, vals, diag, x, n, k, r, y, s);
}
