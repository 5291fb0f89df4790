// What the launch heuristics of the kernels ask of the device.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Streaming multiprocessors of the current device, read once (the port
// drives one card).
inline int64_t sm_count() {
  static const int64_t count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return static_cast<int64_t>(n > 0 ? n : 1);
  }();
  return count;
}
