// L1 — a CG call as one graph launch on the card, around one CUDA WHILE
// conditional node, for Hopper (sm_90a).
//
// L1 has no Pallas counterpart: it is what XLA lowers the JAX package's
// `jax.lax.while_loop` to (padne_tpu/ops/cg.py:270, :448, :589), the loop
// whose `cond` runs on the device and ends a dispatch the moment it turns
// false, with the call's init before it and its finish after it in one
// jitted function.  padne_tpu_torch/ops/cg.py captures the three parts of a
// CG call with torch, each into a CUDA graph of its own (one memory pool for
// the three); this file builds the graph a call launches from them:
//
//   prologue (child graph) -> [loop_begin]
//     -> WHILE(handle) { iteration (child graph) -> [loop_cond] }
//     -> epilogue (child graph)
//
//   prologue:   b projected, the state with its first preconditioner
//               application, the target from the device scalar tol, go and
//               k = 0, written into the buffers the iteration reads.
//   loop_begin: handle = go && k < kmax; the flag (go, k) for the host.
//               False on entry runs no iteration, as `cond` false on entry
//               does in JAX.
//   loop_cond:  after each iteration, from the device scalars it has just
//               written: handle = go && k < kmax; flag = (go, k, ran + 1).
//   epilogue:   the true residual, x projected and the residual norms, into
//               output buffers the host copies out.
//
// k < kmax is always part of the test, so a faulty go cannot hang the card.
// kmax is a device scalar the host writes before each launch, as it writes
// tol and copies b in: nothing of one call is baked into the graph.  ran
// counts the iterations the card ran, for the host to hold against k; the
// host reads the flag once, after the whole graph.  What bounds L1: nothing
// of its own — two one-thread kernels of a few scalars each; the parts it
// wraps are the work.  Its design point is the host: one launch and one
// read a CG call, where the host would otherwise launch the prologue's and
// the epilogue's kernels one by one and read go every iteration.
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

int build(Loop* lp, cudaGraph_t prologue, cudaGraph_t iteration,
          cudaGraph_t epilogue, const bool* go, const int64_t* k,
          const int64_t* kmax, int64_t* flag, cudaStream_t stream) {
  PG_TRY(cudaGraphCreate(&lp->graph, 0));
  cudaGraphConditionalHandle handle;
  PG_TRY(cudaGraphConditionalHandleCreate(&handle, lp->graph, 0, 0));

  // The three parts are cloned into the graph: their kernels keep the
  // addresses the captures gave them, so the caller keeps the captured
  // graphs' memory pool alive as long as this loop.
  cudaGraphNode_t pro;
  PG_TRY(cudaGraphAddChildGraphNode(&pro, lp->graph, nullptr, 0, prologue));
  void* begin_args[] = {&handle, &go, &k, &kmax, &flag};
  const cudaKernelNodeParams bp =
      one_thread(reinterpret_cast<void*>(loop_begin), begin_args);
  cudaGraphNode_t begin;
  PG_TRY(cudaGraphAddKernelNode(&begin, lp->graph, &pro, 1, &bp));

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

  cudaGraphNode_t child;
  PG_TRY(cudaGraphAddChildGraphNode(&child, body, nullptr, 0, iteration));
  void* cond_args[] = {&handle, &go, &k, &kmax, &flag};
  const cudaKernelNodeParams cp =
      one_thread(reinterpret_cast<void*>(loop_cond), cond_args);
  cudaGraphNode_t cond;
  PG_TRY(cudaGraphAddKernelNode(&cond, body, &child, 1, &cp));

  cudaGraphNode_t epi;
  PG_TRY(cudaGraphAddChildGraphNode(&epi, lp->graph, &node, 1, epilogue));

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

// One CG call's graph from its three captured parts (a cudaGraph_t each,
// cloned): go (bool) and k (int64) are the state's device scalars, which
// the prologue writes; kmax (int64) the call's device scalar, which the host
// writes; flag (int64[3]: go, k, iterations ran) a device buffer of the
// caller's.  Instantiates and uploads on `stream`; *out receives the loop's
// handle.
extern "C" int pg_loop_create(void* prologue, void* iteration, void* epilogue,
                              const void* go, const void* k, const void* kmax,
                              void* flag, void* stream, void** out) {
  *out = nullptr;
  Loop* lp = new Loop;
  const int rc = build(lp, static_cast<cudaGraph_t>(prologue),
                       static_cast<cudaGraph_t>(iteration),
                       static_cast<cudaGraph_t>(epilogue),
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

// One CG call: the graph launched on `stream` (asynchronous).
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
