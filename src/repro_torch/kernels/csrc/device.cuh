// device.cuh: what a launch needs to know of the card, looked up once for
// each device.
#pragma once

#include <cuda_runtime.h>

// Devices whose properties a launch keeps; past them it queries each time.
constexpr int kMaxDevices = 64;

// The device a launch goes to: the caller makes the tensors' device current.
inline int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// Streaming multiprocessors of device `dev` (132 on an H100 SXM), queried
// at its first launch and kept.
inline int sm_count(int dev) {
  static int count[kMaxDevices] = {};
  const bool kept = dev >= 0 && dev < kMaxDevices;
  int c = kept ? count[dev] : 0;
  if (c == 0) {
    cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    if (kept) count[dev] = c;
  }
  return c > 0 ? c : 1;
}

inline int sm_count() { return sm_count(current_device()); }
