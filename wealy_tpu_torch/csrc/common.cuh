// Shared declarations for the kernels of wealy_tpu_torch (built by _build.py
// with nvcc for sm_90a into one shared library with a plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WEALY_API extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;
