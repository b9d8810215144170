// K6: row-wise LayerNorm over the last axis, bf16 or f32 in and out.
//
// Replaces the TPU kernel wealy_tpu/ops/layer_norm.py::_ln_kernel (launched
// by _ln_fwd_impl, public fused_layer_norm). For each row of D values it
// computes, in f32 and in two passes over registers as the TPU kernel does
// (layer_norm.py:27-33): the mean mu; then the mean of (x - mu)^2 (biased
// variance, not E[x^2] - mu^2); then y = (x - mu) * rsqrt(var + eps) *
// scale + bias, written in x's dtype. scale and bias are f32 (D,).
//
// What bounds it on an H100: device memory. Each row is read once and
// written once, about 8 f32 operations per element: at (64, 1500, 384) bf16
// that is 147 MB, about 44 us at 3.35 TB/s, against 0.3 GFLOP (about 4.4 us
// on the FP32 cores). Design: one warp per row, 8 rows per block; each lane
// loads its share of the row with 16-byte accesses (8 bf16 or 4 f32 values,
// neighbouring lanes on neighbouring addresses) into registers, and the two
// reductions are warp shuffles, so only x and y cross device memory. At the
// repo's widths a lane holds 12-40 values on average (D = 384, 512, 1280 in bf16). The
// TPU wrapper pads the rows to ROW_BLOCK = 512; here the grid covers any row
// count, and a warp past the last row leaves. A row whose width is not a
// multiple of the 16-byte access, or a misaligned input, takes the same
// kernel with one-element accesses.
//
// Limits: D <= kMaxD (the wrapper raises above), so a lane holds at most 64
// values in registers.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxD = 2048;
constexpr int kWarps = 8;  // rows per block

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// EPV consecutive values of one access, to and from f32 registers
template <typename T, int EPV>
struct Access;

template <>
struct Access<float, 1> {
  __device__ static void load(const float* p, float* f) { f[0] = p[0]; }
  __device__ static void store(float* p, const float* f) { p[0] = f[0]; }
};

template <>
struct Access<bf16, 1> {
  __device__ static void load(const bf16* p, float* f) { f[0] = __bfloat162float(p[0]); }
  __device__ static void store(bf16* p, const float* f) { p[0] = __float2bfloat16_rn(f[0]); }
};

template <>
struct Access<float, 4> {
  __device__ static void load(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Access<bf16, 8> {
  __device__ static void load(const bf16* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  __device__ static void store(bf16* p, const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// one warp per row; lane l takes accesses l, l + 32, ... (EPV values each),
// at most VPL of them
template <typename T, int EPV, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
    ln_kernel(const T* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ bias, T* __restrict__ out, long long rows, int D,
              float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves
  const int n_access = D / EPV;
  const T* xr = x + row * D;
  T* yr = out + row * D;

  float v[VPL][EPV];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int a = lane + i * 32;
    if (a < n_access) {
      Access<T, EPV>::load(xr + a * EPV, v[i]);
#pragma unroll
      for (int e = 0; e < EPV; ++e) sum += v[i][e];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + i * 32 < n_access) {
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float c = v[i][e] - mu;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int a = lane + i * 32;
    if (a < n_access) {
      float y[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const int j = a * EPV + e;
        y[e] = (v[i][e] - mu) * rstd * __ldg(scale + j) + __ldg(bias + j);
      }
      Access<T, EPV>::store(yr + a * EPV, y);
    }
  }
}

// the smallest VPL (a power of 2) that covers per_lane accesses
template <typename T, int EPV, int VPL>
cudaError_t launch(int per_lane, const T* x, const float* scale, const float* bias, T* out,
                   long long rows, int D, float eps, cudaStream_t stream) {
  if constexpr (VPL * EPV * 32 < kMaxD) {
    if (per_lane > VPL) {
      return launch<T, EPV, VPL * 2>(per_lane, x, scale, bias, out, rows, D, eps, stream);
    }
  }
  const long long blocks = (rows + kWarps - 1) / kWarps;
  ln_kernel<T, EPV, VPL><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      x, scale, bias, out, rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, const void* bias, void* out,
                     long long rows, int D, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  if (aligned && D % kVec == 0) {
    return launch<T, kVec, 1>((D / kVec + 31) / 32, xt, s, b, o, rows, D, eps, stream);
  }
  return launch<T, 1, 1>((D + 31) / 32, xt, s, b, o, rows, D, eps, stream);
}

}  // namespace

// x, out: contiguous (rows, D), bf16 when is_bf16 else f32; scale, bias: f32 (D,).
WEALY_API int wealy_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                               long long rows, int D, int is_bf16, float eps, void* stream) {
  if (rows <= 0 || D <= 0 || D > kMaxD || (rows + kWarps - 1) / kWarps > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<bf16>(x, scale, bias, out, rows, D, eps, s);
  return dispatch<float>(x, scale, bias, out, rows, D, eps, s);
}
