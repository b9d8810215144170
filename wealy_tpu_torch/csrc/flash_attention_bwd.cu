// K5a / K5b: non-causal multi-head attention backward (the Whisper encoder's
// self-attention under training), recomputing the probabilities from the
// forward's row log-sum-exp (FlashAttention-2 split).
//
// Replaces the TPU kernel wealy_tpu/ops/flash_attention.py::_dq_kernel (K5a)
// and wealy_tpu/ops/flash_attention.py::_dkv_kernel (K5b), both launched by
// _flash_mha_bwd_impl (the custom_vjp backward of flash_mha). They compute
// what those compute, the gradient of the exact softmax attention
// out = softmax(scale * q k^T) v:
//   p     = exp(scale * q.k - lse)              (f32, lse from K2's forward)
//   dp    = g . v^T                              (f32 accumulate)
//   delta = rowsum(g * out)                      (f32; equals rowsum(p * dp))
//   ds    = p * (dp - delta) * scale             (f32)
//   dq    = bf16(ds) . k,  dk = bf16(ds)^T . q,  dv = bf16(p)^T . g
// with f32 accumulators and the TPU kernels' roundings of p and ds to bf16
// before their products. Ragged keys (key >= tk) get p = 0; ragged query
// rows (row >= tq) contribute nothing to dk/dv and are not written.
//
// What bounds it on an H100: the tensor cores. Per head the backward runs
// five T x T x Dh products (K5a: S, dP, dQ; K5b: S^T, dP^T, dV, dK, i.e.
// S and dP are recomputed in each kernel), about 2.5x the forward's FLOPs,
// against 8 x T x Dh x 2 bytes of q/k/v/out/g/dq/dk/dv. As in K2, K and V of
// one head (192 KB each in bf16 at T=1500) do not fit in shared memory
// beside the query tiles, so the TPU design's resident K/V per head does not
// carry over: both kernels stream 64-row tiles. The TPU's dK/dV scratch
// carried across a sequential grid axis does not carry over either (blocks
// run in no order here): K5b gives each block a 64-key range and loops over
// the query tiles inside the block, accumulating dK and dV in f32 WMMA
// fragments. Every output element is written by one block after a fixed
// order of adds, with no atomics, so repeated calls are bit-equal.
//
// Products run on the tensor cores through WMMA 16x16x16 bf16 fragments
// with f32 accumulators (4 warps per block, 16 rows each), as in K2; the
// elementwise p/ds pass goes through shared memory because WMMA fragments
// have an opaque layout. No cp.async/TMA pipelining and no wgmma yet.
//
// Layout: q, k, v, out, g, dq, dk and dv are read and written in the
// natural (B, T, H, Dh) layout (row stride H*Dh), like K2; lse and delta
// are f32 (B, H, Tq). K5a writes delta (each block for its own rows) and K5b
// reads it, so K5a must run first on the same stream.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;       // head dim (every published Whisper size)
constexpr int BT = 64;       // rows per tile: 64 queries (K5a) or 64 keys (K5b)
constexpr int WARPS = BT / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = DH + 8;  // bf16 row stride of the 64-row q/k/v/g tiles (144 B)
constexpr int LDF = BT + 4;  // f32 row stride of a warp's 16 x 64 tiles
constexpr int LDB = BT + 8;  // bf16 row stride of a warp's 16 x 64 tiles

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct SmemDq {
  bf16 q[BT * LDH];
  bf16 g[BT * LDH];
  bf16 k[BT * LDH];
  bf16 v[BT * LDH];
  float s[WARPS][16 * LDF];   // scores, then the warp's dQ rows
  float dp[WARPS][16 * LDF];
  bf16 ds[WARPS][16 * LDB];
  float lse[BT];
  float delta[BT];
};

struct SmemDkv {
  bf16 k[BT * LDH];
  bf16 v[BT * LDH];
  bf16 q[BT * LDH];
  bf16 g[BT * LDH];
  float s[WARPS][16 * LDF];   // transposed scores, then the warp's dK rows
  float dp[WARPS][16 * LDF];  // transposed dP, then the warp's dV rows
  bf16 p[WARPS][16 * LDB];
  bf16 ds[WARPS][16 * LDB];
  float lse[BT];
  float delta[BT];
};

// rows [t0, t0+64) of one head into a (64, LDH) shared tile, zeros past t_len
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int t0, int t_len,
                                          size_t row_stride) {
  for (int idx = threadIdx.x; idx < BT * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8);
    const int c = idx % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < t_len) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(t0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c * 8) = val;
  }
}

// C (16 x 64) = A (16 x 64, four row-major fragments) . B^T, B a 64 x 64
// shared tile stored [n][k] (i.e. B^T column-major), into f32 `out` (LDF)
__device__ __forceinline__ void product_nt(float* out, const FragA* a, const bf16* b) {
#pragma unroll
  for (int n = 0; n < BT / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDF, wmma::mem_row_major);
  }
}

// acc (16 x 64, four fragments) += A (16 x 64 bf16 in shared, LDB) . B, B a
// 64 x 64 shared tile stored [k][n] row-major (LDH)
__device__ __forceinline__ void accumulate_nn(FragC* acc, const bf16* a, const bf16* b) {
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      FragA af;
      FragBRow bf;
      wmma::load_matrix_sync(af, a + kk * 16, LDB);
      wmma::load_matrix_sync(bf, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
}

// the warp's 16 accumulated rows -> bf16 rows [t0 + 16 * warp, ...) of dst,
// rows >= t_len skipped; `buf` is the warp's f32 (16, LDF) scratch
__device__ __forceinline__ void store_rows(bf16* dst, const FragC* acc, float* buf, int t0,
                                           int t_len, size_t row_stride) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    wmma::store_matrix_sync(buf + n * 16, acc[n], LDF, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int t = t0 + warp * 16 + r;
  if (t < t_len) {
    bf16* row = dst + static_cast<size_t>(t) * row_stride + c0;
#pragma unroll
    for (int j = 0; j < 32; ++j) row[j] = __float2bfloat16(buf[r * LDF + c0 + j]);
  }
  __syncwarp();
}

// K5a: one block per (b, h, 64-query tile); streams the key tiles
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ out,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int tq, int tk,
                    int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(smem_raw);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * row_stride + h * DH;
  const size_t koff = static_cast<size_t>(b) * tk * row_stride + h * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * tq;

  load_tile(sm.q, q + qoff, q0, tq, row_stride);
  load_tile(sm.g, g + qoff, q0, tq, row_stride);
  if (threadIdx.x < BT) {  // thread i: delta and lse of query row q0 + i
    const int t = q0 + threadIdx.x;
    float d = 0.f, l = 0.f;
    if (t < tq) {
      const bf16* orow = out + qoff + static_cast<size_t>(t) * row_stride;
      const bf16* grow = g + qoff + static_cast<size_t>(t) * row_stride;
      for (int j = 0; j < DH; ++j) d += __bfloat162float(grow[j]) * __bfloat162float(orow[j]);
      l = lse[stat + t];
      delta[stat + t] = d;
    }
    sm.delta[threadIdx.x] = d;
    sm.lse[threadIdx.x] = l;
  }
  __syncthreads();

  FragA qf[DH / 16], gf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(gf[kk], sm.g + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC acc[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  // elementwise pass: lane pair (2r, 2r+1) owns row r, columns [c0, c0+32)
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const bool row_valid = q0 + warp * 16 + r < tq;
  const float lse_r = sm.lse[warp * 16 + r];
  const float delta_r = sm.delta[warp * 16 + r];
  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  bf16* ds_w = sm.ds[warp];

  for (int k0 = 0; k0 < tk; k0 += BT) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile(sm.k, k + koff, k0, tk, row_stride);
    load_tile(sm.v, v + koff, k0, tk, row_stride);
    __syncthreads();

    product_nt(s_w, qf, sm.k);   // S  (16 x 64 keys) = Q_w . K^T
    product_nt(dp_w, gf, sm.v);  // dP (16 x 64 keys) = G_w . V^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      float ds = 0.f;
      if (row_valid && k0 + c < tk) {
        const float p = expf(s_w[r * LDF + c] * scale - lse_r);
        ds = p * (dp_w[r * LDF + c] - delta_r) * scale;
      }
      ds_w[r * LDB + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_nn(acc, ds_w, sm.k);  // dQ_w += dS_w . K
  }
  store_rows(dq + qoff, acc, s_w, q0, tq, row_stride);
}

// K5b: one block per (b, h, 64-key tile); loops over the query tiles
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int tq, int tk, int heads,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(smem_raw);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * row_stride + h * DH;
  const size_t koff = static_cast<size_t>(b) * tk * row_stride + h * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * tq;

  load_tile(sm.k, k + koff, k0, tk, row_stride);
  load_tile(sm.v, v + koff, k0, tk, row_stride);
  __syncthreads();
  FragA kf[DH / 16], vf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sm.k + warp * 16 * LDH + kk * 16, LDH);
    wmma::load_matrix_sync(vf[kk], sm.v + warp * 16 * LDH + kk * 16, LDH);
  }
  FragC acc_dk[DH / 16], acc_dv[DH / 16];
#pragma unroll
  for (int n = 0; n < DH / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  // elementwise pass: lane pair (2r, 2r+1) owns key row r, query columns [c0, c0+32)
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  float* s_w = sm.s[warp];
  float* dp_w = sm.dp[warp];
  bf16* p_w = sm.p[warp];
  bf16* ds_w = sm.ds[warp];

  for (int q0 = 0; q0 < tq; q0 += BT) {
    __syncthreads();  // the previous tile's Q/G/statistics are no longer read
    load_tile(sm.q, q + qoff, q0, tq, row_stride);
    load_tile(sm.g, g + qoff, q0, tq, row_stride);
    if (threadIdx.x < BT) {
      const int t = q0 + threadIdx.x;
      sm.lse[threadIdx.x] = t < tq ? lse[stat + t] : 0.f;
      sm.delta[threadIdx.x] = t < tq ? delta[stat + t] : 0.f;
    }
    __syncthreads();

    product_nt(s_w, kf, sm.q);   // S^T  (16 keys x 64 queries) = K_w . Q^T
    product_nt(dp_w, vf, sm.g);  // dP^T (16 keys x 64 queries) = V_w . G^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = c0 + j;
      float p = 0.f, ds = 0.f;
      if (q0 + c < tq) {
        p = expf(s_w[r * LDF + c] * scale - sm.lse[c]);
        ds = p * (dp_w[r * LDF + c] - sm.delta[c]) * scale;
      }
      p_w[r * LDB + c] = __float2bfloat16(p);
      ds_w[r * LDB + c] = __float2bfloat16(ds);
    }
    __syncwarp();
    accumulate_nn(acc_dv, p_w, sm.g);   // dV_w += P^T_w . G
    accumulate_nn(acc_dk, ds_w, sm.q);  // dK_w += dS^T_w . Q
  }
  store_rows(dk + koff, acc_dk, s_w, k0, tk, row_stride);
  store_rows(dv + koff, acc_dv, dp_w, k0, tk, row_stride);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// K5a. q/out/g/dq (batch, tq, heads, 64), k/v (batch, tk, heads, 64), bf16 and
// contiguous; lse (batch, heads, tq) f32 from wealy_flash_mha_fwd; writes dq
// and delta (batch, heads, tq) f32.
WEALY_API int wealy_flash_mha_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* out, const void* g, const void* lse,
                                     void* delta, void* dq, int batch, int tq, int tk,
                                     int heads, int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(SmemDq));
  cudaError_t err = set_smem(flash_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BT - 1) / BT, heads, batch);
  flash_bwd_dq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<bf16*>(dq), tq,
      tk, heads, scale);
  return cudaGetLastError();
}

// K5b. Shapes as K5a; delta as K5a wrote it (launch K5a first on `stream`);
// writes dk and dv (batch, tk, heads, 64) bf16.
WEALY_API int wealy_flash_mha_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int tq, int tk, int heads,
                                      int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(SmemDkv));
  cudaError_t err = set_smem(flash_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + BT - 1) / BT, heads, batch);
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk,
      heads, scale);
  return cudaGetLastError();
}
