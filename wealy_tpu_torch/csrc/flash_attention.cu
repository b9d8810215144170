// K2: non-causal multi-head attention forward (the Whisper encoder's
// self-attention), online softmax tiled over the keys.
//
// Replaces the TPU kernel wealy_tpu/ops/flash_attention.py::_mha_kernel
// (launched by _flash_mha_fwd_impl, public flash_mha). Computes exactly the
// softmax of _reference_mha: scores q.k in f32, times `scale`, softmax in
// f32, probabilities cast to bf16 before the PV product (f32 accumulate),
// division by the row sum after PV. The TPU kernel's constant shift of -24
// and score clamp at 60 are not carried over: the running row max is exact.
//
// What bounds it on an H100: at T=1500, Dh=64 the two products are
// 2 x T^2 x Dh MACs per head against 4 x T x Dh x 2 bytes of q/k/v/out, so it
// is compute-bound (about 750 bf16 FLOP per byte); the (T, T) score matrix
// never reaches device memory. K and V of one head are 192 KB each in bf16,
// which do not both fit in 227 KB of shared memory, so instead of the TPU
// kernel's resident K/V the block streams 64-key tiles through shared
// memory and keeps a running max and row sum per query row (flash
// attention). Products run on the tensor cores through WMMA 16x16x16 bf16
// fragments with f32 accumulators; the rescaling of the output rows goes
// through shared memory because WMMA fragments have an opaque layout.
// This first version has no cp.async/TMA pipelining and no wgmma.
//
// With a non-null `lse` the kernel also writes each query row's
// log-sum-exp of the scaled scores, f32 (B, H, Tq): the softmax statistic
// that the backward kernels K5a/K5b (flash_attention_bwd.cu) recompute the
// probabilities from. Inference passes null and writes nothing more.
//
// Layout: q, k, v and out are read and written in the natural
// (B, T, H, Dh) layout (row stride H*Dh), as the TPU kernel does. The
// ragged key tail (1500 is not a multiple of 64) is zero-filled in shared
// memory and masked to -inf before the softmax; ragged query rows are
// computed on zeros and not written.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int DH = 64;        // head dim (every published Whisper size)
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = DH + 8;   // bf16 row stride of the q/k/v tiles (144 B)
constexpr int LDP = BK + 8;   // bf16 row stride of the probability tile
constexpr int LDS = BK + 4;   // f32 row stride of the score / output tiles (BK == DH)

struct Smem {
  bf16 q[BQ * LDH];
  bf16 k[BK * LDH];
  bf16 v[BK * LDH];
  bf16 p[WARPS][16 * LDP];
  float s[WARPS][16 * LDS];  // scores, then the tile's PV product
  float o[WARPS][16 * LDS];  // running (unnormalised) output rows
};

// rows [t0, t0+64) of one head into a (64, LDH) shared tile, zeros past t_len
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int t0, int t_len,
                                          size_t row_stride) {
  for (int idx = threadIdx.x; idx < 64 * (DH / 8); idx += THREADS) {
    const int r = idx / (DH / 8);
    const int c = idx % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < t_len) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(t0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + c * 8) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ lse, int tq, int tk, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const bf16* qb = q + static_cast<size_t>(b) * tq * row_stride + h * DH;
  const bf16* kb = k + static_cast<size_t>(b) * tk * row_stride + h * DH;
  const bf16* vb = v + static_cast<size_t>(b) * tk * row_stride + h * DH;

  float* s_w = sm.s[warp];
  float* o_w = sm.o[warp];
  bf16* p_w = sm.p[warp];

  load_tile(sm.q, qb, q0, tq, row_stride);
  for (int i = lane; i < 16 * LDS; i += 32) o_w[i] = 0.f;
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LDH + kk * 16, LDH);
  }

  // softmax bookkeeping: lane pair (2r, 2r+1) owns row r, columns [c0, c0+32)
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  float m_i = -INFINITY;
  float l_i = 0.f;

  for (int k0 = 0; k0 < tk; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile(sm.k, kb, k0, tk, row_stride);
    load_tile(sm.v, vb, k0, tk, row_stride);
    __syncthreads();

    // S (16 x BK) = Q_w (16 x DH) . K^T; K stored [key][d] is K^T in column-major
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + n * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax update for row r
    float sv[32];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + c0 + j;
      const float x = key < tk ? s_w[r * LDS + c0 + j] * scale : -INFINITY;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_i, tmax);  // finite: every tile holds a valid key
    const float alpha = expf(m_i - m_new); // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(sv[j] - m_new);
      psum += p;
      p_w[r * LDP + c0 + j] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();

    // PV (16 x DH) = P_w (16 x BK) . V (BK x DH), into the score buffer
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_w + kk * 16, LDP);
        wmma::load_matrix_sync(vf, sm.v + kk * 16 * LDH + n * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      o_w[r * LDS + c0 + j] = o_w[r * LDS + c0 + j] * alpha + s_w[r * LDS + c0 + j];
    }
    __syncwarp();
  }

  const int t = q0 + warp * 16 + r;
  if (t < tq) {
    bf16* dst = out + (static_cast<size_t>(b) * tq + t) * row_stride + h * DH + c0;
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[j] = __float2bfloat16(o_w[r * LDS + c0 + j] / l_i);
    if (lse != nullptr && c0 == 0) {
      lse[(static_cast<size_t>(b) * heads + h) * tq + t] = m_i + logf(l_i);
    }
  }
}

}  // namespace

// q (batch, tq, heads, head_dim), k/v (batch, tk, heads, head_dim), out like q;
// all bf16 and contiguous; head_dim must be 64. lse: null, or f32
// (batch, heads, tq) for the row log-sum-exp.
WEALY_API int wealy_flash_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int tq, int tk, int heads,
                                  int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), tq, tk, heads, scale);
  return cudaGetLastError();
}
