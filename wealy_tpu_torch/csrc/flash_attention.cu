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
// What bounds it on an H100: the tensor cores. At T = 1500, Dh = 64 the two
// products are 2 x T^2 x Dh MACs per head against 4 x T x Dh x 2 bytes of
// q/k/v/out, about 750 bf16 FLOP per byte, far above the card's 295; the
// (T, T) score matrix never reaches device memory. K and V of one head are
// 192 KB each in bf16, which do not both fit in 227 KB of shared memory, so
// instead of the TPU kernel's resident K/V the block streams 64-key tiles
// and keeps a running max and row sum per query row (flash attention). At
// head dim 64 the softmax's exp2 per score costs about as much issue time
// as that score's share of the two products, so the design keeps the
// tensor cores busy while the exponentials run:
//
// - One block owns one (b, h) and 64 query rows: one consumer warpgroup
//   (128 threads) and one producer warp. Its Q tile is loaded once by TMA
//   and stays resident as the wgmma A operand, from shared memory. Four
//   blocks fit an SM (at most 96 registers a thread, 50 KB of shared memory
//   each), so one block's softmax runs while the others' products do. On an
//   H100 this was faster than two consumer warpgroups sharing each K/V tile
//   (at two blocks per SM ptxas caps them at 96 registers), than three ring
//   stages at three blocks per SM, and than one warpgroup issuing the next
//   tile's S before its softmax (ptxas serialises wgmma whose accumulators
//   are read while another runs).
// - K and V arrive as 64 x 64 bf16 tiles through a ring of NST stages, by
//   TMA (cp.async.bulk.tensor) from 3-D tensor maps over (batch, T,
//   heads * 64) that zero-fill rows past T, so the ragged last tile of one
//   batch never reads the next batch's rows; one full and one empty
//   mbarrier per stage; one producer warp issues every load.
// - S = Q.K^T is an m64n64k16 wgmma with K as the K-major B operand. The
//   online softmax runs on the accumulator registers (layout in hopper.cuh):
//   keys >= Tk set to -inf by index (in the last tile only), the row max
//   across the quad of threads that share a row, exp2 with scale * log2 e
//   folded into one FMA, the row-sum and the rescale of the f32 O
//   accumulator by alpha in registers (skipped by a warp whose rows all
//   kept their max). P is packed
//   to bf16 register A fragments, and O += P.V reads V as the MN-major
//   (transposed) B operand from the same swizzled tile. S, P and O never
//   reach shared memory; there is no __syncthreads in the loop.
// - Epilogue: O / l rounded to bf16, staged in shared memory and written as
//   16-byte stores; query rows >= Tq are not written.
//
// With a non-null `lse` the kernel also writes each query row's
// log-sum-exp of the scaled scores, m + log(l), f32 (B, H, Tq): the softmax
// statistic that the backward kernels K5a/K5b (flash_attention_bwd.cu)
// recompute the probabilities from. Inference passes null and writes
// nothing more.
//
// Layout: q, k, v and out are read and written in the natural (B, T, H, Dh)
// layout (row stride H*Dh), as the TPU kernel does, from 16-byte aligned
// bases (TMA). The building blocks (mbarriers, TMA, descriptors, wgmma,
// tensor maps) are in hopper.cuh, shared with K5a/K5b.
#include "hopper.cuh"

namespace {

constexpr int NST = 2;                   // stages of the K/V ring
constexpr int CONSUMERS = WG;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp

struct SmemFwd {
  bf16 q[TILE];        // the resident A operand (1024-byte aligned, swizzled by TMA)
  bf16 k[NST][TILE];   // the ring
  bf16 v[NST][TILE];
  bf16 out[BT * LDO];  // O in bf16, staged for 16-byte stores
  uint64_t full[NST], empty[NST], res;
};

__device__ __forceinline__ float ex2(float x) {  // 2^x (MUFU), flushing subnormals to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the online softmax of one score tile (keys [key0, key0 + 64)) on the
// accumulator registers: s becomes p = 2^(s * scale2 - m) with keys >= tk
// at 0, m the updated running row max of s * scale2 (log2 units), alpha
// its rescale of the earlier terms; l (this thread's partial row sums) is
// rescaled and takes the new p. Only the last tile can hold keys >= tk.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int key0, int tk,
                                               float scale2) {
  const int lane = threadIdx.x % 32;
  float mx[2] = {-INFINITY, -INFINITY};
  if (key0 + BT > tk) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (key0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= tk) s[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {  // the four threads of a quad share a row
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
    mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
    const float m_new = fmaxf(m[hi], mx[hi] * scale2);  // finite: every tile holds a key
    alpha[hi] = ex2(m[hi] - m_new);  // 0 on the first tile (m = -inf)
    m[hi] = m_new;
    l[hi] *= alpha[hi];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(fmaf(s[i], scale2, -m[(i % 4) / 2]));
    l[(i % 4) / 2] += s[i];
  }
}

// one block per (b, h, 64-query tile); streams the key tiles
__global__ void __launch_bounds__(THREADS, 4)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                 float* __restrict__ lse, int tq, int tk, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemFwd& sm = *reinterpret_cast<SmemFwd*>(align1024(smem_raw));
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int n_tiles = (tk + BT - 1) / BT;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_init(&sm.res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues every load
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&sm.res, TILE_BYTES);
      tma_load(sm.q, &q_map, &sm.res, h * DH, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % NST;
        if (j >= NST) mbar_wait(&sm.empty[s], ((j / NST) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &k_map, &sm.full[s], h * DH, j * BT, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h * DH, j * BT, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const float scale2 = scale * LOG2E;

  float o[32], s[32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t pf[BT / 16][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = s[i] = 0.f;
  const uint64_t q_desc = desc(sm.q, DESC_K_MAJOR);
  mbar_wait(&sm.res, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NST;
    mbar_wait(&sm.full[st], (j / NST) & 1);
    const uint64_t k_desc = desc(sm.k[st], DESC_K_MAJOR);
    wg_fence();
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {  // S = Q . K^T
      wgmma_ss(s, q_desc + kk * K_STEP, k_desc + kk * K_STEP, kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);

    online_softmax(s, m, l, alpha, j * BT, tk, scale2);
    // O's rescale, skipped by a warp whose rows all kept their max (after
    // the first tiles, most do); alpha is 0 on the first tile
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i % 4) / 2];
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) a_fragment(pf[kk], s, kk);

    const uint64_t vt_desc = desc(sm.v[st], DESC_MN_MAJOR);
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs(o, pf[kk], vt_desc + kk * MN_STEP);  // O += P.V
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(&sm.empty[st]);
  }

  // epilogue: the quad's row sums, O / l, lse = m + log(l)
  const int r0 = (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    const int t = q0 + r0 + 8 * hi;
    if (lse != nullptr && lane % 4 == 0 && t < tq) {
      lse[(static_cast<size_t>(b) * heads + h) * tq + t] = (m[hi] + log2f(l[hi])) / LOG2E;
    }
    l[hi] = 1.f / l[hi];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] *= l[(i % 4) / 2];
  stage_rows(sm.out, o, tid);
  named_sync<1, CONSUMERS>();
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  store_rows<CONSUMERS>(out + static_cast<size_t>(b) * tq * row_stride + h * DH, sm.out, q0, tq,
                        row_stride, tid);
}

}  // namespace

// q (batch, tq, heads, head_dim), k/v (batch, tk, heads, head_dim), out like q;
// all bf16, contiguous, 16-byte aligned; head_dim must be 64. lse: null, or
// f32 (batch, heads, tq) for the row log-sum-exp.
WEALY_API int wealy_flash_mha_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int batch, int tq, int tk, int heads,
                                  int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  // a runtime call first: it makes the device's primary context current on
  // this thread, and the driver's tensor-map encoder needs one
  const int smem = static_cast<int>(sizeof(SmemFwd)) + 1024;
  cudaError_t err = set_smem(flash_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = tile_map(&qm, q, batch, tq, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&km, k, batch, tk, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&vm, v, batch, tk, heads)) != cudaSuccess) return err;
  dim3 grid((tq + BT - 1) / BT, heads, batch);
  flash_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(out), static_cast<float*>(lse), tq, tk, heads, scale);
  return cudaGetLastError();
}
