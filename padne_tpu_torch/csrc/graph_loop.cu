// L1 — the CG loop's exit at convergence on the card: one CUDA WHILE
// conditional node a solve, for Hopper (sm_90a).
//
// L1 has no Pallas counterpart: it is what XLA lowers the JAX package's
// `jax.lax.while_loop` to (padne_tpu/ops/cg.py:270, :448, :589), the loop
// whose `cond` runs on the device and ends a dispatch the moment it turns
// false.  padne_tpu_torch/ops/cg.py captures ONE CG iteration into a CUDA
// graph with torch; this file builds the graph a solve launches around it:
//
//   [loop_begin] -> WHILE(handle) { iteration (child graph) -> [loop_cond] }
//
//   loop_begin: handle = go && k < kmax; the flag (go, k) for the host.
//               False on entry runs no iteration, as `cond` false on entry
//               does in JAX.
//   loop_cond:  after each iteration, from the device scalars it has just
//               written: handle = go && k < kmax; flag = (go, k, ran + 1).
//
// k < kmax is always part of the test, so a faulty go cannot hang the card.
// ran counts the iterations the card ran, for the host to hold against k.
// What bounds L1: nothing of its own — two one-thread kernels of a few
// scalars each; the iteration it wraps is the work.  Its design point is
// the host: one launch and one read a solve instead of one of each an
// iteration.
//
// Plain C interface (bound with ctypes from padne_tpu_torch/kernels.py); no
// PyTorch headers.  Every entry point returns a cudaError_t (0 on success)
// and records the name of the CUDA call that failed (pg_loop_failed_call).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

thread_local const char* g_failed = "";

#define PG_TRY(call)                             \
  do {                                           \
    const cudaError_t rc_ = (call);              \
    if (rc_ != cudaSuccess) {                    \
      g_failed = #call;                          \
      return static_cast<int>(rc_);              \
    }                                            \
  } while (0)

__global__ void loop_begin(cudaGraphConditionalHandle handle, const bool* go,
                           const int64_t* k, const int64_t* kmax,
                           int64_t* flag) {
  const int64_t kk = *k;
  const bool g = *go;
  flag[0] = g;
  flag[1] = kk;
  cudaGraphSetConditional(handle, g && kk < *kmax ? 1u : 0u);
}

__global__ void loop_cond(cudaGraphConditionalHandle handle, const bool* go,
                          const int64_t* k, const int64_t* kmax,
                          int64_t* flag) {
  const int64_t kk = *k;
  const bool g = *go;
  flag[0] = g;
  flag[1] = kk;
  flag[2] += 1;
  cudaGraphSetConditional(handle, g && kk < *kmax ? 1u : 0u);
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

cudaKernelNodeParams one_thread(void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return p;
}

int build(Loop* lp, cudaGraph_t iteration, const bool* go, const int64_t* k,
          const int64_t* kmax, int64_t* flag, cudaStream_t stream) {
  PG_TRY(cudaGraphCreate(&lp->graph, 0));
  cudaGraphConditionalHandle handle;
  PG_TRY(cudaGraphConditionalHandleCreate(&handle, lp->graph, 0, 0));

  void* begin_args[] = {&handle, &go, &k, &kmax, &flag};
  const cudaKernelNodeParams bp =
      one_thread(reinterpret_cast<void*>(loop_begin), begin_args);
  cudaGraphNode_t begin;
  PG_TRY(cudaGraphAddKernelNode(&begin, lp->graph, nullptr, 0, &bp));

  cudaGraphNodeParams wp = {};
  wp.type = cudaGraphNodeTypeConditional;
  wp.conditional.handle = handle;
  wp.conditional.type = cudaGraphCondTypeWhile;
  wp.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  PG_TRY(cudaGraphAddNode(&node, lp->graph, &begin, nullptr, 1, &wp));
#else
  PG_TRY(cudaGraphAddNode(&node, lp->graph, &begin, 1, &wp));
#endif
  cudaGraph_t body = wp.conditional.phGraph_out[0];

  // The iteration is cloned into the body: its kernels keep the addresses
  // the capture gave them, so the caller keeps the captured graph's memory
  // pool alive as long as this loop.
  cudaGraphNode_t child;
  PG_TRY(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, iteration));
  void* cond_args[] = {&handle, &go, &k, &kmax, &flag};
  const cudaKernelNodeParams cp =
      one_thread(reinterpret_cast<void*>(loop_cond), cond_args);
  cudaGraphNode_t cond;
  PG_TRY(cudaGraphAddKernelNode(&cond, body, &child, 1, &cp));

  PG_TRY(cudaGraphInstantiate(&lp->exec, lp->graph, 0));
  PG_TRY(cudaGraphUpload(lp->exec, stream));
  return 0;
}

void release(Loop* lp) {
  if (lp->exec) cudaGraphExecDestroy(lp->exec);
  if (lp->graph) cudaGraphDestroy(lp->graph);
  delete lp;
}

}  // namespace

// The loop around one captured iteration (a cudaGraph_t, which is cloned):
// go (bool), k and kmax (int64) are the iteration's device scalars, flag
// (int64[3]: go, k, iterations ran) a device buffer of the caller's.
// Instantiates and uploads on `stream`; *out receives the loop's handle.
extern "C" int pg_loop_create(void* iteration, const void* go, const void* k,
                              const void* kmax, void* flag, void* stream,
                              void** out) {
  *out = nullptr;
  Loop* lp = new Loop;
  const int rc = build(lp, static_cast<cudaGraph_t>(iteration),
                       static_cast<const bool*>(go),
                       static_cast<const int64_t*>(k),
                       static_cast<const int64_t*>(kmax),
                       static_cast<int64_t*>(flag),
                       static_cast<cudaStream_t>(stream));
  if (rc != 0) {
    release(lp);
    return rc;
  }
  *out = lp;
  return 0;
}

// One solve's loop: the graph launched on `stream` (asynchronous).
extern "C" int pg_loop_launch(void* loop, void* stream) {
  PG_TRY(cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                         static_cast<cudaStream_t>(stream)));
  return 0;
}

extern "C" void pg_loop_destroy(void* loop) {
  if (loop) release(static_cast<Loop*>(loop));
}

// The CUDA runtime's and the driver's versions (e.g. 12080).
extern "C" int pg_cuda_versions(int* runtime, int* driver) {
  PG_TRY(cudaRuntimeGetVersion(runtime));
  PG_TRY(cudaDriverGetVersion(driver));
  return 0;
}

extern "C" const char* pg_loop_failed_call() { return g_failed; }

extern "C" const char* pg_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
