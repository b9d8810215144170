// Shared declarations for the kernels of wealy_tpu_torch (built by _build.py
// with nvcc for sm_90a into one shared library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WEALY_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

// the card's SM count (the first query's answer, kept for the process)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}
