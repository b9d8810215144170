// K6: row-wise LayerNorm over the last axis, bf16 or f32 in and out.
//
// Replaces the TPU kernel wealy_tpu/ops/layer_norm.py::_ln_kernel (launched
// by _ln_fwd_impl, public fused_layer_norm). For each row of D values it
// computes, in f32 and in two passes over registers or shared memory as the
// TPU kernel does (layer_norm.py:27-33): the mean mu; then the mean of
// (x - mu)^2 (biased variance, not E[x^2] - mu^2); then y = (x - mu) *
// rsqrt(var + eps) * scale + bias, written in x's dtype. scale and bias are
// f32 (D,).
//
// What bounds it on an H100: device memory. Each row is read once and
// written once, about 8 f32 operations per element: at (64, 1500, 384) bf16
// that is 147 MB, about 44 us at 3.35 TB/s, against 0.3 GFLOP (about 4.4 us
// on the FP32 cores). So the design keeps the stream of 16-byte loads full
// and moves nothing but x and y through device memory:
//
// - Row route (a lane holds at most kRowValues values). A persistent grid,
//   as many blocks as stay resident on the card's SMs; each warp walks
//   groups of 32 / lanes rows by a grid stride, `lanes` lanes a row, each
//   lane `per_lane` accesses of `vec` values (neighbouring lanes on
//   neighbouring addresses). The wrapper's plan (ops/layer_norm.py::
//   launch_plan) splits a row evenly where it can: D = 384 bf16 is 16 lanes
//   x 3 accesses of 8 (two rows a warp), D = 1280 bf16 32 x 5, and the
//   registers are sized to that share. A warp issues the next group's loads
//   into a second register buffer before it reduces the current group, so a
//   group's two dependent shuffle reductions and its stores overlap the
//   next group's loads. Each lane loads its columns of scale and bias once,
//   with 16-byte loads, and keeps them in registers for every row it walks.
//   Loads and stores carry the streaming (evict-first) hint: every byte of x
//   and y is touched once.
// - Block route (wider rows, up to kMaxD). A persistent grid of blocks that
//   each walk rows by a grid stride, one row at a time: the row is staged in
//   shared memory as it is loaded (the mean's pass), then read back for the
//   variance and the output; the two sums are block reductions in a fixed
//   order.
//
// The fused entry (wealy_add_layer_norm) adds a second input, the addend,
// to x first: the sum, in f32 and rounded once to x's dtype (PyTorch's
// x + addend), is written out as the new residual stream (sums) and is the
// row the LayerNorm reads. Each route then carries one more input stream
// and one more output stream (the addend loaded beside x, the sums stored
// before the row's reductions), at 8 bytes an element in bf16 against the
// plain entry's 4: a Whisper block's residual add and the LayerNorm that
// reads its sum in one pass.
//
// A width that no even split covers, or a pointer off a 16-byte boundary,
// takes the same routes with one element per access (vec = 1), the last
// accesses of a row guarded. The TPU wrapper pads the rows to ROW_BLOCK =
// 512; here the grid covers any row count. No atomics: a repeat is
// bit-equal.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kRowValues = 40;       // a lane's values on the row route (ROW_VALUES)
constexpr int kRowWarps = 4;         // warps a block on the row route
constexpr int kBlockThreads = 256;   // threads a block on the block route (BLOCK_THREADS)
constexpr int kMaxD = 32768;         // the block route's widest row: 128 KB of f32 staged (MAX_D)
constexpr size_t kDefaultSmem = 48 * 1024;

// Access<T, EPV>: EPV consecutive values of one access: a streaming load of
// the raw bits, their f32 values, f32 values rounded into raw bits (pack),
// and streaming stores of raw bits (put) or of f32 values (store)
template <typename T, int EPV>
struct Access;

template <>
struct Access<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return __ldcs(p); }
  __device__ static void unpack(const Raw& r, float* f) { f[0] = r; }
  __device__ static Raw pack(const float* f) { return f[0]; }
  __device__ static void put(float* p, const Raw& r) { __stcs(p, r); }
  __device__ static void store(float* p, const float* f) { put(p, pack(f)); }
};

template <>
struct Access<bf16, 1> {
  using Raw = unsigned short;
  __device__ static Raw load(const bf16* p) {
    return __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static void unpack(const Raw& r, float* f) {
    f[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  __device__ static Raw pack(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
  __device__ static void put(bf16* p, const Raw& r) {
    __stcs(reinterpret_cast<unsigned short*>(p), r);
  }
  __device__ static void store(bf16* p, const float* f) { put(p, pack(f)); }
};

template <>
struct Access<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldcs(reinterpret_cast<const float4*>(p)); }
  __device__ static void unpack(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static Raw pack(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
  __device__ static void put(float* p, const Raw& r) { __stcs(reinterpret_cast<float4*>(p), r); }
  __device__ static void store(float* p, const float* f) { put(p, pack(f)); }
};

template <>
struct Access<bf16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const bf16* p) { return __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ static void unpack(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the lower half of a word is the earlier value
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static Raw pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static void put(bf16* p, const Raw& r) { __stcs(reinterpret_cast<uint4*>(p), r); }
  __device__ static void store(bf16* p, const float* f) { put(p, pack(f)); }
};

// r <- r + q: EPV sums in f32, each rounded once to T (PyTorch's x + addend)
template <typename T, int EPV>
__device__ inline void add_into(typename Access<T, EPV>::Raw& r,
                                const typename Access<T, EPV>::Raw& q) {
  using A = Access<T, EPV>;
  float a[EPV], b[EPV];
  A::unpack(r, a);
  A::unpack(q, b);
#pragma unroll
  for (int e = 0; e < EPV; ++e) a[e] += b[e];
  r = A::pack(a);
}

// EPV values of scale or bias from column c (16-byte loads where EPV >= 4:
// the plan gives vec > 1 only to 16-byte-aligned weights)
template <int EPV>
__device__ inline void load_weights(const float* __restrict__ w, int c, float* f) {
  if constexpr (EPV % 4 == 0) {
#pragma unroll
    for (int k = 0; k < EPV / 4; ++k) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(w + c) + k);
      f[4 * k] = t.x;
      f[4 * k + 1] = t.y;
      f[4 * k + 2] = t.z;
      f[4 * k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < EPV; ++e) f[e] = __ldg(w + c + e);
  }
}

// sum over the `lanes` lanes of a row (lanes a power of 2, aligned in the
// warp): xor shuffles below `lanes` stay inside the row's lanes
__device__ inline float row_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Row route: warp w walks row groups w, w + stride, ...; lane l works on
// row (group * 32 / lanes + l / lanes), accesses l % lanes + i * lanes for
// i < APL (those at or past D / EPV hold no column). kAdd: the row is x +
// addend, written to sums before its statistics
template <typename T, int EPV, int APL, bool kAdd>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows(const T* __restrict__ x, const T* __restrict__ addend,
            const float* __restrict__ scale, const float* __restrict__ bias,
            T* __restrict__ sums, T* __restrict__ out, long long rows, int D, int lanes,
            float eps) {
  using A = Access<T, EPV>;
  using Raw = typename A::Raw;
  const int lane = threadIdx.x & 31;
  const int sub = lane / lanes;  // the lane's row within its group
  const int j = lane % lanes;    // the lane's place within its row
  const int per_group = 32 / lanes;
  const int n_access = D / EPV;
  const long long groups = (rows + per_group - 1) / per_group;
  const long long stride = static_cast<long long>(gridDim.x) * kRowWarps;
  long long g = static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  if (g >= groups) return;  // the whole warp leaves

  float s[APL][EPV], b[APL][EPV];  // the lane's columns of scale and bias, for every row
#pragma unroll
  for (int i = 0; i < APL; ++i) {
    const int a = j + i * lanes;
    if (a < n_access) {
      load_weights<EPV>(scale, a * EPV, s[i]);
      load_weights<EPV>(bias, a * EPV, b[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) s[i][e] = b[i][e] = 0.f;
    }
  }

  // a group's loads of x into r and of the addend into q (zeros past the
  // row's end or the last row)
  auto load_group = [&](Raw(&r)[APL], Raw(&q)[APL], long long grp) {
    const long long row = grp * per_group + sub;
#pragma unroll
    for (int i = 0; i < APL; ++i) {
      const int a = j + i * lanes;
      const bool in = row < rows && a < n_access;
      r[i] = in ? A::load(x + row * D + a * EPV) : Raw{};
      if constexpr (kAdd) q[i] = in ? A::load(addend + row * D + a * EPV) : Raw{};
    }
  };
  // the sum (kAdd), statistics and output of the group held in r (and q)
  auto finish_group = [&](Raw(&r)[APL], const Raw(&q)[APL], long long grp) {
    const long long row = grp * per_group + sub;
    if constexpr (kAdd) {
#pragma unroll
      for (int i = 0; i < APL; ++i) {
        add_into<T, EPV>(r[i], q[i]);  // zeros where no column
        const int a = j + i * lanes;
        if (row < rows && a < n_access) A::put(sums + row * D + a * EPV, r[i]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < APL; ++i) {
      float v[EPV];
      A::unpack(r[i], v);
#pragma unroll
      for (int e = 0; e < EPV; ++e) sum += v[e];  // zeros where no column
    }
    const float mu = row_sum(sum, lanes) / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < APL; ++i) {
      if (j + i * lanes < n_access) {
        float v[EPV];
        A::unpack(r[i], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          const float c = v[e] - mu;
          sq += c * c;
        }
      }
    }
    const float rstd = rsqrtf(row_sum(sq, lanes) / static_cast<float>(D) + eps);
    if (row >= rows) return;
#pragma unroll
    for (int i = 0; i < APL; ++i) {
      const int a = j + i * lanes;
      if (a < n_access) {
        float v[EPV], y[EPV];
        A::unpack(r[i], v);
#pragma unroll
        for (int e = 0; e < EPV; ++e) y[e] = (v[e] - mu) * rstd * s[i][e] + b[i][e];
        A::store(out + row * D + a * EPV, y);
      }
    }
  };

  // two register buffers: the next group's loads go out before this
  // group's reductions
  Raw r0[APL], r1[APL], q0[APL], q1[APL];  // q0, q1 unused without kAdd
  load_group(r0, q0, g);
  while (true) {
    long long next = g + stride;
    if (next < groups) load_group(r1, q1, next);
    finish_group(r0, q0, g);
    if (next >= groups) break;
    g = next;
    next = g + stride;
    if (next < groups) load_group(r0, q0, next);
    finish_group(r1, q1, g);
    if (next >= groups) break;
    g = next;
  }
}

// sum over the block, in a fixed order; `part` holds one value a warp
__device__ inline float block_sum(float v, float* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kBlockThreads / 32; ++w) t += part[w];
  __syncthreads();  // part is free for the next sum
  return t;
}

// Block route: block k walks rows k, k + gridDim.x, ...; thread t takes
// accesses t, t + kBlockThreads, ... of the row, staged in shared memory
// (each thread reads back only what it wrote). kAdd: the row is x +
// addend, written to sums as it is staged
template <typename T, int EPV, bool kAdd>
__global__ void __launch_bounds__(kBlockThreads)
    ln_block(const T* __restrict__ x, const T* __restrict__ addend,
             const float* __restrict__ scale, const float* __restrict__ bias,
             T* __restrict__ sums, T* __restrict__ out, long long rows, int D, float eps) {
  using A = Access<T, EPV>;
  using Raw = typename A::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  Raw* stage = reinterpret_cast<Raw*>(smem);
  __shared__ float part[kBlockThreads / 32];
  const int n_access = D / EPV;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * D;
    T* yr = out + row * D;
    float sum = 0.f;
#pragma unroll 4
    for (int a = threadIdx.x; a < n_access; a += kBlockThreads) {
      Raw r = A::load(xr + a * EPV);
      if constexpr (kAdd) {
        add_into<T, EPV>(r, A::load(addend + row * D + a * EPV));
        A::put(sums + row * D + a * EPV, r);
      }
      stage[a] = r;
      float v[EPV];
      A::unpack(r, v);
#pragma unroll
      for (int e = 0; e < EPV; ++e) sum += v[e];
    }
    const float mu = block_sum(sum, part) / static_cast<float>(D);
    float sq = 0.f;
    for (int a = threadIdx.x; a < n_access; a += kBlockThreads) {
      float v[EPV];
      A::unpack(stage[a], v);
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        const float c = v[e] - mu;
        sq += c * c;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, part) / static_cast<float>(D) + eps);
    for (int a = threadIdx.x; a < n_access; a += kBlockThreads) {
      float v[EPV], sc[EPV], bi[EPV], y[EPV];
      A::unpack(stage[a], v);
      load_weights<EPV>(scale, a * EPV, sc);
      load_weights<EPV>(bias, a * EPV, bi);
#pragma unroll
      for (int e = 0; e < EPV; ++e) y[e] = (v[e] - mu) * rstd * sc[e] + bi[e];
      A::store(yr + a * EPV, y);
    }
  }
}

// blocks of `kernel` resident on the card at once (SMs x blocks an SM),
// asked once per kernel and shared-memory size
template <typename K>
long long resident_blocks(K kernel, int threads, size_t smem) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  return static_cast<long long>(per_sm) * sm_count();
}

struct Args {
  const void* x;
  const void* addend;  // the fused entry's second input, else null
  const float* scale;
  const float* bias;
  void* sums;  // the fused entry's sums, else null
  void* out;
  long long rows;
  int D;
  int lanes;
  float eps;
  cudaStream_t stream;
};

template <typename T, int EPV, int APL, bool kAdd>
cudaError_t launch_rows(const Args& p) {
  static long long resident = resident_blocks(ln_rows<T, EPV, APL, kAdd>, kRowWarps * 32, 0);
  const long long groups = (p.rows + 32 / p.lanes - 1) / (32 / p.lanes);
  const long long need = (groups + kRowWarps - 1) / kRowWarps;
  const unsigned blocks = static_cast<unsigned>(need < resident ? need : resident);
  ln_rows<T, EPV, APL, kAdd><<<blocks, kRowWarps * 32, 0, p.stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.addend), p.scale, p.bias,
      static_cast<T*>(p.sums), static_cast<T*>(p.out), p.rows, p.D, p.lanes, p.eps);
  return cudaGetLastError();
}

// the row route at per_lane accesses a lane, if APL... holds it
template <typename T, int EPV, bool kAdd, int... APL>
cudaError_t launch_rows_of(int per_lane, const Args& p) {
  cudaError_t err = cudaErrorInvalidValue;
  ((per_lane == APL && (err = launch_rows<T, EPV, APL, kAdd>(p), true)) || ...);
  return err;
}

template <typename T, int EPV, bool kAdd>
cudaError_t launch_block(const Args& p) {
  const size_t smem = static_cast<size_t>(p.D) * sizeof(T);
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(ln_block<T, EPV, kAdd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long resident = resident_blocks(ln_block<T, EPV, kAdd>, kBlockThreads, smem);
  const unsigned blocks = static_cast<unsigned>(p.rows < resident ? p.rows : resident);
  ln_block<T, EPV, kAdd><<<blocks, kBlockThreads, smem, p.stream>>>(
      static_cast<const T*>(p.x), static_cast<const T*>(p.addend), p.scale, p.bias,
      static_cast<T*>(p.sums), static_cast<T*>(p.out), p.rows, p.D, p.eps);
  return cudaGetLastError();
}

template <typename T, bool kAdd>
cudaError_t dispatch(int route, int vec, int per_lane, const Args& p) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec != 1 && vec != kVec) return cudaErrorInvalidValue;
  if (route == 1) return vec == 1 ? launch_block<T, 1, kAdd>(p) : launch_block<T, kVec, kAdd>(p);
  if (route != 0 || p.lanes < 1 || p.lanes > 32 || (p.lanes & (p.lanes - 1)) != 0 ||
      static_cast<long long>(p.lanes) * per_lane * vec < p.D || per_lane * vec > kRowValues) {
    return cudaErrorInvalidValue;
  }
  // the shares a lane may take, as ROW_ACCESSES in ops/layer_norm.py
  if (vec == 1) return launch_rows_of<T, 1, kAdd, 1, 2, 4, 8, 16, 24>(per_lane, p);
  if constexpr (kVec == 8) {
    return launch_rows_of<T, 8, kAdd, 1, 2, 3, 4, 5>(per_lane, p);
  } else {
    return launch_rows_of<T, 4, kAdd, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10>(per_lane, p);
  }
}

template <bool kAdd>
int run(const Args& p, int is_bf16, int route, int vec, int per_lane) {
  if (p.rows <= 0 || p.D <= 0 || p.D > kMaxD || vec < 1 || p.D % vec != 0) {
    return cudaErrorInvalidValue;
  }
  if (is_bf16) return dispatch<bf16, kAdd>(route, vec, per_lane, p);
  return dispatch<float, kAdd>(route, vec, per_lane, p);
}

}  // namespace

// x, out: contiguous (rows, D), bf16 when is_bf16 else f32; scale, bias: f32
// (D,). The plan (ops/layer_norm.py::launch_plan): route 0 (rows: `lanes`
// lanes a row, `per_lane` accesses a lane) or 1 (a block a row), `vec`
// values an access (16 bytes, or 1).
WEALY_API int wealy_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                               long long rows, int D, int is_bf16, float eps, int route, int vec,
                               int lanes, int per_lane, void* stream) {
  const Args p{x, nullptr, static_cast<const float*>(scale), static_cast<const float*>(bias),
               nullptr, out, rows, D, lanes, eps, static_cast<cudaStream_t>(stream)};
  return run<false>(p, is_bf16, route, vec, per_lane);
}

// The fused entry: sums = x + addend (x's dtype, one rounding) and out =
// the LayerNorm of sums, in one pass. x, addend, sums, out: contiguous
// (rows, D) of one dtype; the rest as wealy_layer_norm (the plan's vec 16
// bytes only where all six pointers are 16-byte aligned).
WEALY_API int wealy_add_layer_norm(const void* x, const void* addend, const void* scale,
                                   const void* bias, void* sums, void* out, long long rows,
                                   int D, int is_bf16, float eps, int route, int vec, int lanes,
                                   int per_lane, void* stream) {
  const Args p{x,    addend, static_cast<const float*>(scale), static_cast<const float*>(bias),
               sums, out,    rows, D, lanes, eps, static_cast<cudaStream_t>(stream)};
  return run<true>(p, is_bf16, route, vec, per_lane);
}
