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
// TB/s. The design is one launch a call that reads K and V once, keeps a
// row ahead of them in flight, and keeps the rounding of the probabilities
// exact:
//
// - A block of 128 threads owns kChunk = 256 positions of a row: 8 lanes a
//   position, 8 values a lane, 16 positions a pass. Its K chunk goes to
//   registers (16 streaming 16-byte loads a thread) and its V chunk to
//   shared memory (cp.async, 16 bytes a copy), both issued together, so V
//   is in flight while the scores form. (On an H100 at turbo's cross shape,
//   B = 16: one bulk copy of each chunk onto an mbarrier, 0.0546 ms with a
//   cluster a row and 0.0585 with the walk below; K through shared memory
//   by cp.async as well, 0.0531; this form, 0.0500.)
// - Rounding p to bf16 needs the row's global max and sum before any p is
//   formed. A row of Tk positions is one thread-block cluster of
//   ceil(Tk / kChunk) blocks, at most kMaxSplit = 8 (the portable cluster
//   size; Tk <= 2048, every Whisper shape: 1500 audio frames, caches of at
//   most 448), launched with the cluster size as a launch attribute. Each
//   block keeps its chunk's scores in shared memory and publishes its
//   (max, sum of exp); after a cluster barrier every block reads the row's
//   statistics from its peers' shared memory (distributed shared memory) in
//   rank order, forms p and multiplies its V chunk, and writes its 64-float
//   share of the output into rank 0's shared memory; after a second cluster
//   barrier (which also keeps every peer's shared memory alive until all
//   reads of it are done) rank 0 sums the shares in rank order and writes
//   the bf16 row. Nothing goes through device memory but K, V, q and the
//   output. A row of at most kChunk positions (the 224-position self cache)
//   is a cluster of one block: no cluster barrier, its own statistics.
// - The grid holds as many clusters as fit on the card at once (at most one
//   a row); a cluster takes rows y, y + clusters, ... and each block issues
//   the next row's K loads as soon as this row's scores are formed, and its
//   V copies as soon as this row's product is done. At turbo, B = 16 (320
//   rows of 6 blocks; in bf16 128 registers a thread, so 4 blocks an SM)
//   that is at most 132 x 4 / 6 = 88 clusters.
//
// Sums run in a fixed order (no floating-point atomics): a repeat is
// bit-equal, and the lane mapping and sum orders are those of the two-launch
// design it replaced (scores and statistics per chunk, statistics combined
// in chunk order, shares summed in chunk order), so its outputs are too.
#include <cooperative_groups.h>
#include <cuda_fp8.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;
constexpr int kDh = 64;                          // head width (HEAD_DIM)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 8;                        // lanes a row, 8 values each
constexpr int kRowsPerWarp = 32 / kLanes;        // 4
constexpr int kRowsPerPass = kThreads / kLanes;  // 16
constexpr int kChunk = 256;                      // positions a block (CHUNK)
constexpr int kPasses = kChunk / kRowsPerPass;   // 16
constexpr int kMaxSplit = 8;                     // blocks a cluster: Tk <= 2048 (MAX_TK)

typedef __nv_fp8_e4m3 f8;

// Row<T>: 8 consecutive values of one row: their raw bits and their f32
// values
template <typename T>
struct Row;

template <>
struct Row<bf16> {
  using Raw = uint4;
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

// this thread's 8 values of row bh of q
__device__ __forceinline__ uint4 q_values(const bf16* q, int bh) {
  const int g = threadIdx.x & (kLanes - 1);
  return *reinterpret_cast<const uint4*>(q + static_cast<size_t>(bh) * kDh + g * 8);
}

// this thread's values of the chunk's rows [t0, t0 + kChunk) of row bh of
// k, one pass each (streaming loads; zero at or past the chunk's `rows`)
template <typename T>
__device__ __forceinline__ void load_k(typename Row<T>::Raw (&buf)[kPasses], const T* k, int bh,
                                       int tk, int t0, int rows) {
  using Raw = typename Row<T>::Raw;
  const int g = threadIdx.x & (kLanes - 1);
  const T* base = k + (static_cast<size_t>(bh) * tk + t0) * kDh + g * 8;
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = pass_row(i);
    buf[i] = Raw{};
    if (r < rows) buf[i] = __ldcs(reinterpret_cast<const Raw*>(base + r * kDh));
  }
}

// the chunk's `rows` rows of row bh of v into vs (shared memory) as 16-byte
// cp.async copies by every thread, one commit group
template <typename T>
__device__ __forceinline__ void copy_v(T* vs, const T* v, int bh, int tk, int t0, int rows) {
  const int pieces = rows * kDh * static_cast<int>(sizeof(T)) / 16;
  const char* src = reinterpret_cast<const char*>(v + (static_cast<size_t>(bh) * tk + t0) * kDh);
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(vs));
  for (int i = threadIdx.x; i < pieces; i += kThreads)
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;" ::"r"(dst + 16 * i),
                 "l"(src + 16 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// scores of the chunk's rows into sc (kChunk floats): q (this thread's
// values) rounded to bf16 after the scale, the dot product in f32 against
// the K values; -inf at or past rows
template <typename T>
__device__ void chunk_scores(const uint4& q, const typename Row<T>::Raw (&kv)[kPasses],
                             float scale, int rows, float* sc) {
  const int g = threadIdx.x & (kLanes - 1);
  float qs[8];
  Row<bf16>::unpack(q, qs);
#pragma unroll
  for (int j = 0; j < 8; ++j) qs[j] = round_bf16(qs[j] * scale);
#pragma unroll
  for (int i = 0; i < kPasses; ++i) {
    const int r = pass_row(i);
    float kf[8];
    Row<T>::unpack(kv[i], kf);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(qs[j], kf[j], s);
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    s += __shfl_xor_sync(FULL, s, 4);
    if (g == 0) sc[r] = r < rows ? s : -INFINITY;
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

// one block a chunk of a row, one cluster (gridDim.x blocks, rank =
// blockIdx.x) a row at a time: rows blockIdx.y, blockIdx.y + gridDim.y, ...
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const long long* __restrict__ pos, float scale,
                       int tk, int batch_heads, bf16* __restrict__ out) {
  __shared__ __align__(16) T vs[kChunk * kDh];
  __shared__ float sc[kChunk];
  __shared__ float red[kWarps];
  __shared__ float acc_w[kWarps][kDh];
  __shared__ float2 stats;                  // this chunk's (max, sum), read by the cluster
  __shared__ float2 row_stats[kMaxSplit];   // the cluster's, in rank order
  __shared__ float shares[kMaxSplit][kDh];  // rank 0's: each rank's share of the output
  const int n_split = gridDim.x, split = blockIdx.x, t0 = split * kChunk;
  const int rows = min(max(valid_rows(pos, tk) - t0, 0), kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane & (kLanes - 1);
  const int d = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  typename Row<T>::Raw kv[kPasses];
  load_k<T>(kv, k, blockIdx.y, tk, t0, rows);
  copy_v<T>(vs, v, blockIdx.y, tk, t0, rows);
  uint4 qv = q_values(q, blockIdx.y);
  for (int bh = blockIdx.y; bh < batch_heads; bh += gridDim.y) {
    const int next = bh + gridDim.y;
    chunk_scores<T>(qv, kv, scale, rows, sc);
    __syncthreads();
    if (next < batch_heads) {  // the next row's K and q in flight from here
      load_k<T>(kv, k, next, tk, t0, rows);
      qv = q_values(q, next);
    }
    const float2 st = chunk_stats(sc, red);
    float m = st.x, s = st.y;
    if (n_split > 1) {
      if (threadIdx.x == 0) stats = st;
      cluster.sync();
      if (threadIdx.x < n_split)
        row_stats[threadIdx.x] = *cluster.map_shared_rank(&stats, threadIdx.x);
      __syncthreads();
      m = -INFINITY;
      for (int i = 0; i < n_split; ++i) m = fmaxf(m, row_stats[i].x);
      s = 0.f;
      for (int i = 0; i < n_split; ++i) {
        const float2 r = row_stats[i];
        if (r.x != -INFINITY) s += r.y * expf(r.x - m);
      }
    }
    for (int i = threadIdx.x; i < kChunk; i += kThreads)
      sc[i] = i < rows ? round_bf16(expf(sc[i] - m) / s) : 0.f;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kPasses; ++i) {
      const int r = pass_row(i);
      typename Row<T>::Raw raw{};
      if (r < rows) raw = *reinterpret_cast<const typename Row<T>::Raw*>(vs + r * kDh + g * 8);
      float vf[8];
      Row<T>::unpack(raw, vf);
      const float p = sc[r];
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
    if (next < batch_heads) copy_v<T>(vs, v, next, tk, t0, rows);  // vs read: the next V
    float o = 0.f;
    if (d < kDh) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += acc_w[w][d];
    }
    if (n_split == 1) {
      if (d < kDh) out[static_cast<size_t>(bh) * kDh + d] = __float2bfloat16_rn(o);
      continue;
    }
    if (d < kDh) cluster.map_shared_rank(&shares[0][0], 0)[split * kDh + d] = o;
    cluster.sync();
    if (split == 0 && d < kDh) {
      float sum = 0.f;
      for (int i = 0; i < n_split; ++i) sum += shares[i][d];
      out[static_cast<size_t>(bh) * kDh + d] = __float2bfloat16_rn(sum);
    }
  }
}

// the clusters of `config` that fit on the card at once, asked once a
// device and cluster size (0 where the query fails)
template <typename T>
int resident_clusters(const cudaLaunchConfig_t& config, int n_split) {
  static int known[16][kMaxSplit + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int* slot = dev < 16 ? &known[dev][n_split] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, decode_attn_kernel<T>, &config) != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch below reports its own
    return 0;
  }
  if (slot != nullptr) *slot = n;
  return n;
}

// one launch: grid (n_split, clusters) in clusters of n_split blocks, as
// many clusters as fit at once and at most one a row
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const long long* pos, void* out,
                   int batch_heads, int tk, float scale, cudaStream_t stream) {
  const int n_split = (tk + kChunk - 1) / kChunk;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_split, 1);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const int fit = resident_clusters<T>(config, n_split);
  config.gridDim.y = fit > 0 && fit < batch_heads ? fit : batch_heads;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, decode_attn_kernel<T>, static_cast<const bf16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, scale, tk, batch_heads, static_cast<bf16*>(out));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// q (B, 1, H, 64) bf16; k, v (B, H, tk, 64) in `kv_kind` (0 bf16, 1 float8
// e4m3); pos a (1,) int64 device index or null; out (B, H, 64) bf16
WEALY_API int wealy_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                     void* out, int batch_heads, int tk, int head_dim,
                                     int kv_kind, float scale, void* stream) {
  if (head_dim != kDh || batch_heads <= 0 || batch_heads > 65535 || tk <= 0 ||
      tk > kMaxSplit * kChunk)
    return cudaErrorInvalidValue;
  const long long* p = static_cast<const long long*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_kind == 0) return launch<bf16>(q, k, v, p, out, batch_heads, tk, scale, s);
  if (kv_kind == 1) return launch<f8>(q, k, v, p, out, batch_heads, tk, scale, s);
  return cudaErrorInvalidValue;
}
