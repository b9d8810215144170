// Decode attention: one query row a (batch, head) against a K/V of Tk rows
// (Tq = 1), the Whisper decoder's incremental step.
//
// Replaces no TPU kernel: the JAX package leaves the step's attention to XLA
// (wealy_tpu/models/whisper/model.py, the decode-layout branch). It was added
// because the port's plain path for that branch (MultiHeadAttention.forward,
// now ops/decode_attention.py::_reference_decode_attention) upcasts the
// whole K/V to f32 and runs two f32 matrix-vector products: at large-v3-turbo
// width and B = 16 the held cross K/V alone is 983 MB a step in f32.
//
// Computes exactly the plain path's softmax: q (B, 1, H, 64) in bf16 times
// `scale` rounded to bf16; scores q.k in f32 against k (pre-scaled); the
// softmax in f32 over the valid positions; the probabilities rounded to bf16
// before the product with v (the JAX model's astype), accumulated in f32; the
// output rounded to bf16, (B, H, 64) = (B, 1, H * 64). K and V are read in
// the decode layout (B, H, Tk, 64) in their storage dtype, bf16 or float8
// e4m3, and upcast in registers. With `pos` (a (1,) int64 device index, the
// self-attention cache) only positions [0, pos] are valid and read, so no
// shape depends on the position and the step stays capturable in a CUDA
// graph; without it (the held cross K/V) all Tk are.
//
// What bounds it on an H100: device memory. Each K and V byte is used once
// for one multiply-add (2 operations a bf16 byte, against the card's 295):
// at turbo, B = 16 the cross K/V is 123 MB a layer in bf16, 37 us at 3.35
// TB/s. The design streams K and V once in 16-byte loads, keeps every SM busy
// and keeps the rounding of the probabilities exact:
//
// - A block of 128 threads owns kChunk = 256 positions of one (b, h): 8 lanes
//   a row, 8 values a lane, 16 rows a pass, all 16 passes' loads issued
//   before the first product (streaming, evict-first). The Tk axis is split
//   over blocks (flash-decoding): at turbo, B = 16 the cross attention runs
//   6 x 320 blocks.
// - Rounding p to bf16 needs the row's global max and sum before any p is
//   formed, so a split row takes two kernels: decode_attn_scores_kernel
//   writes each chunk's f32 scores (1.9 MB a layer at turbo, B = 16: about
//   1% of the K/V bytes, mostly served from L2) and its (max, sum of exp);
//   decode_attn_kernel combines the row's statistics, forms p rounded to
//   bf16, multiplies V and writes its chunk's f32 partial output, and the
//   last block of a row to finish (an atomic ticket) sums the partials in
//   chunk order and writes the bf16 row. The ticket is reset by the scores
//   kernel, so nothing is cleared between calls.
// - A row of at most kChunk positions (the self-attention cache at
//   max_len <= 256) takes decode_attn_kernel alone: one block a row keeps
//   its scores in shared memory.
//
// Sums run in a fixed order (no floating-point atomics): a repeat is
// bit-equal.
#include <cuda_fp8.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kDh = 64;                          // head width (HEAD_DIM)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                        // lanes a row, 8 values each
constexpr int kRowsPerWarp = 32 / kLanes;        // 4
constexpr int kRowsPerPass = kThreads / kLanes;  // 16
constexpr int kChunk = 256;                      // positions a block (CHUNK)
constexpr int kPasses = kChunk / kRowsPerPass;   // 16
constexpr int kStatsFloats = 2;                  // (max, sum of exp) a chunk
constexpr int kMaxSplit = 128;                   // chunks a row: Tk <= 32768 (MAX_TK)

typedef __nv_fp8_e4m3 f8;

// Row<T>: 8 consecutive values of one row: a streaming load of their raw
// bits and their f32 values
template <typename T>
struct Row;

template <>
struct Row<bf16> {
  using Raw = uint4;
  __device__ static Raw load(const bf16* p) { return __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ static void unpack(const Raw& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <>
struct Row<f8> {
  using Raw = uint2;
  __device__ static Raw load(const f8* p) { return __ldcs(reinterpret_cast<const uint2*>(p)); }
  __device__ static void unpack(const Raw& r, float* f) {
    const __nv_fp8x2_storage_t* s = reinterpret_cast<const __nv_fp8x2_storage_t*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __nv_cvt_fp8x2_to_halfraw2(s[i], __NV_E4M3);
      const float2 x = __half22float2(h);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// valid positions of the row: [0, pos] of a cache, else all Tk
__device__ __forceinline__ int valid_rows(const long long* pos, int tk) {
  if (pos == nullptr) return tk;
  const long long p = *pos + 1;
  return p < 1 ? 1 : (p > tk ? tk : static_cast<int>(p));
}

// this thread's row of a pass, and the 8 values (columns g * 8 ...) it takes
__device__ __forceinline__ int pass_row(int pass) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return pass * kRowsPerPass + warp * kRowsPerWarp + lane / kLanes;
}

// the 16 passes' raw values of rows [t0, t0 + kChunk) of `x` (decode layout,
// row bh), rows at or past n left zero
template <typename T>
__device__ __forceinline__ void load_chunk(const T* x, int bh, int tk, int t0, int n,
                                           typename Row<T>::Raw (&buf)[kPasses]) {
  const int g = threadIdx.x & (kLanes - 1);
  const T* base = x + static_cast<size_t>(bh) * tk * kDh + g * 8;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int t = t0 + pass_row(i);
    buf[i] = typename Row<T>::Raw{};
    if (t < n) buf[i] = Row<T>::load(base + static_cast<size_t>(t) * kDh);
  }
}

// scores of rows [t0, t0 + kChunk) into sc (shared, kChunk floats): q
// rounded to bf16 after the scale, the dot product in f32; -inf at or past n
template <typename T>
__device__ void chunk_scores(const bf16* q, const T* k, float scale, int bh, int tk, int t0,
                             int n, float* sc) {
  const int g = threadIdx.x & (kLanes - 1);
  float qs[8];
  Row<bf16>::unpack(*reinterpret_cast<const uint4*>(q + static_cast<size_t>(bh) * kDh + g * 8),
                    qs);
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[j] = round_bf16(qs[j] * scale);
  typename Row<T>::Raw buf[kPasses];
  load_chunk<T>(k, bh, tk, t0, n, buf);
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    float kf[8];
    Row<T>::unpack(buf[i], kf);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(qs[j], kf[j], s);
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 4);
    const int r = pass_row(i);
    if (g == 0) sc[r] = t0 + r < n ? s : -INFINITY;
  }
}

// (max, sum of exp(s - max)) of the kChunk scores in sc, in every thread
// (0 for a chunk with no valid row); red holds kWarps floats
__device__ float2 chunk_stats(const float* sc, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < kChunk; i += kThreads) m = fmaxf(m, sc[i]);
#pragma unroll
  for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float s = 0.f;
  if (m != -INFINITY)
    for (int i = threadIdx.x; i < kChunk; i += kThreads) s += expf(sc[i] - m);
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return make_float2(m, s);
}

// a split row's first pass: the chunk's scores and statistics; the row's
// ticket reset by its first chunk
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_scores_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                              const long long* __restrict__ pos, float scale, int tk,
                              int n_split, float* __restrict__ scores,
                              float2* __restrict__ stats, unsigned* __restrict__ tickets) {
  __shared__ float sc[kChunk];
  __shared__ float red[kWarps];
  const int split = blockIdx.x, bh = blockIdx.y, t0 = split * kChunk;
  const int n = valid_rows(pos, tk);
  chunk_scores<T>(q, k, scale, bh, tk, t0, n, sc);
  __syncthreads();
  const float2 st = chunk_stats(sc, red);
  float* row = scores + (static_cast<size_t>(bh) * n_split + split) * kChunk;
  for (int i = threadIdx.x; i < kChunk; i += kThreads) row[i] = sc[i];
  if (threadIdx.x == 0) {
    stats[bh * n_split + split] = st;
    if (split == 0) tickets[bh] = 0;
  }
}

// the probabilities of a chunk and its share of p.v; kSingle: the whole row
// in this block (its scores computed here), else the row's second pass
template <typename T, bool kSingle>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const long long* __restrict__ pos, float scale,
                       int tk, int n_split, const float* __restrict__ scores,
                       const float2* __restrict__ stats, unsigned* __restrict__ tickets,
                       float* __restrict__ partial, bf16* __restrict__ out) {
  __shared__ float sc[kChunk];
  __shared__ float red[kWarps];
  __shared__ float acc_w[kWarps][kDh];
  __shared__ float2 row_stats[kSingle ? 1 : kMaxSplit];
  __shared__ bool last;
  const int split = blockIdx.x, bh = blockIdx.y, t0 = split * kChunk;
  const int n = valid_rows(pos, tk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane & (kLanes - 1);
  typename Row<T>::Raw buf[kPasses];
  float m, s;
  if (kSingle) {
    chunk_scores<T>(q, k, scale, bh, tk, t0, n, sc);
    __syncthreads();
    const float2 st = chunk_stats(sc, red);
    m = st.x;
    s = st.y;
    load_chunk<T>(v, bh, tk, t0, n, buf);
  } else {
    load_chunk<T>(v, bh, tk, t0, n, buf);  // in flight while the row's statistics combine
    const float* row = scores + (static_cast<size_t>(bh) * n_split + split) * kChunk;
    for (int i = threadIdx.x; i < kChunk; i += kThreads) sc[i] = row[i];
    for (int i = threadIdx.x; i < n_split; i += kThreads) row_stats[i] = stats[bh * n_split + i];
    __syncthreads();
    m = -INFINITY;
    for (int i = 0; i < n_split; ++i) m = fmaxf(m, row_stats[i].x);
    s = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float2 st = row_stats[i];
      if (st.x != -INFINITY) s += st.y * expf(st.x - m);
    }
  }
  for (int i = threadIdx.x; i < kChunk; i += kThreads)
    sc[i] = t0 + i < n ? round_bf16(expf(sc[i] - m) / s) : 0.f;
  __syncthreads();
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    float vf[8];
    Row<T>::unpack(buf[i], vf);
    const float p = sc[pass_row(i)];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(p, vf[j], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j] += __shfl_xor_sync(FULL, acc[j], 8);
    acc[j] += __shfl_xor_sync(FULL, acc[j], 16);
  }
  if (lane < kLanes) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_w[warp][g * 8 + j] = acc[j];
  }
  __syncthreads();
  const int d = threadIdx.x;
  float o = 0.f;
  if (d < kDh) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_w[w][d];
  }
  if (kSingle) {
    if (d < kDh) out[static_cast<size_t>(bh) * kDh + d] = __float2bfloat16_rn(o);
    return;
  }
  if (d < kDh) partial[(static_cast<size_t>(bh) * n_split + split) * kDh + d] = o;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[bh], 1u) == static_cast<unsigned>(n_split - 1);
  __syncthreads();
  if (!last || d >= kDh) return;
  __threadfence();
  float sum = 0.f;
  for (int i = 0; i < n_split; ++i)
    sum += __ldcg(&partial[(static_cast<size_t>(bh) * n_split + i) * kDh + d]);
  out[static_cast<size_t>(bh) * kDh + d] = __float2bfloat16_rn(sum);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const long long* pos, void* out,
                   float* workspace, int batch_heads, int tk, float scale, cudaStream_t stream) {
  const int n_split = (tk + kChunk - 1) / kChunk;
  const bf16* qb = static_cast<const bf16*>(q);
  const T* kb = static_cast<const T*>(k);
  const T* vb = static_cast<const T*>(v);
  bf16* ob = static_cast<bf16*>(out);
  const dim3 grid(n_split, batch_heads);
  if (n_split == 1) {
    decode_attn_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        qb, kb, vb, pos, scale, tk, 1, nullptr, nullptr, nullptr, nullptr, ob);
    return cudaGetLastError();
  }
  // workspace: scores (bh, n_split, kChunk), stats (bh, n_split) float2,
  // partial outputs (bh, n_split, kDh), tickets (bh)
  const size_t rows = static_cast<size_t>(batch_heads) * n_split;
  float* scores = workspace;
  float2* stats = reinterpret_cast<float2*>(scores + rows * kChunk);
  float* partial = reinterpret_cast<float*>(stats + rows);
  unsigned* tickets = reinterpret_cast<unsigned*>(partial + rows * kDh);
  decode_attn_scores_kernel<T><<<grid, kThreads, 0, stream>>>(qb, kb, pos, scale, tk, n_split,
                                                              scores, stats, tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T, false><<<grid, kThreads, 0, stream>>>(
      qb, kb, vb, pos, scale, tk, n_split, scores, stats, tickets, partial, ob);
  return cudaGetLastError();
}

// floats of workspace a call at (batch_heads, tk) needs, 0 for one kernel
// (ops/decode_attention.py::workspace_floats)
long long workspace_floats(int batch_heads, int tk) {
  const long long n_split = (tk + kChunk - 1) / kChunk;
  if (n_split <= 1) return 0;
  const long long rows = static_cast<long long>(batch_heads) * n_split;
  return rows * (kChunk + kStatsFloats + kDh) + batch_heads;
}

}  // namespace

// q (B, 1, H, 64) bf16; k, v (B, H, tk, 64) in `kv_kind` (0 bf16, 1 float8
// e4m3); pos a (1,) int64 device index or null; out (B, H, 64) bf16
WEALY_API int wealy_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                     void* out, void* workspace, int batch_heads, int tk,
                                     int head_dim, int kv_kind, float scale, void* stream) {
  if (head_dim != kDh || batch_heads <= 0 || batch_heads > 65535 || tk <= 0 ||
      tk > kMaxSplit * kChunk)
    return cudaErrorInvalidValue;
  if (workspace_floats(batch_heads, tk) > 0 && workspace == nullptr)
    return cudaErrorInvalidValue;
  const long long* p = static_cast<const long long*>(pos);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_kind == 0) return launch<bf16>(q, k, v, p, out, ws, batch_heads, tk, scale, s);
  if (kv_kind == 1) return launch<f8>(q, k, v, p, out, ws, batch_heads, tk, scale, s);
  return cudaErrorInvalidValue;
}
