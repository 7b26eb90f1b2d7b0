// device.cuh: what a launch needs to know of the card, looked up once.
#pragma once

#include <cuda_runtime.h>

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// queried at the first launch and kept.
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count > 0 ? count : 1;
}
