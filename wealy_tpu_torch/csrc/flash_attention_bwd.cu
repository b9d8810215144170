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
//   delta = rowsum(p * dp) / rowsum(p)           (f32, over every key)
//   ds    = p * (dp - delta) * scale / rowsum(p) (f32)
//   dq    = bf16(ds) . k,  dk = bf16(ds)^T . q,  dv = bf16(p)^T . g
// with f32 accumulators and the TPU kernels' roundings of p and ds to bf16
// before their products. Ragged keys (key >= tk) get p = 0; ragged query
// rows (row >= tq) contribute nothing to dk/dv and are not written. delta
// is summed from p and dp as the TPU kernels sum it, not read off the bf16
// forward output (rowsum(g * out)): in a row whose softmax is nearly
// one-hot, dp - delta cancels below out's rounding. The division by
// rowsum(p) (1 but for the f32 rounding of lse, about 1e-6 at |lse| near
// 75) keeps that cancellation exact too; the TPU kernels normalise p by
// its sum the same way.
//
// What bounds it on an H100: the tensor cores. Per head, K5a runs five
// T x T x 64 products (S and dP twice: once to sum delta, once to form ds;
// then dQ) and K5b four (S^T, dP^T, dV, dK): S and dP are recomputed in
// each kernel so that every output element is written by one block after a
// fixed order of adds, with no atomics, and repeated calls are bit-equal.
// The bytes (q/k/v/g in, dq/dk/dv out, 64-wide rows) are small beside that
// work at T = 1500, so the design is about keeping the tensor cores fed:
//
// - Every product is a Hopper warpgroup MMA (wgmma.mma_async, m64n64k16 or
//   m64n32k16, bf16 in, f32 accumulate). One consumer warpgroup (128 threads) owns a
//   64-row tile: 64 queries in K5a, 64 keys in K5b. Its own tile (Q and G in
//   K5a, K and V in K5b) is the A operand, read from shared memory; the
//   streamed tile is always B, from shared memory. dQ (K5a), dK and dV (K5b)
//   stay in f32 registers across the whole loop.
// - The elementwise pass runs on the accumulator registers (the layout is
//   in hopper.cuh), so each thread masks by its values' key and query
//   indices, computes p = exp2(s * scale * log2 e - lse * log2 e) and ds,
//   packs them to bf16 and hands them straight to the next wgmma as its
//   register A operand (dS.K in K5a; P^T.G and dS^T.Q in K5b: K5b computes
//   S^T and dP^T, whose rows are keys, so no transpose is needed). Nothing
//   of S, dP, p or ds goes to shared memory. K5a sweeps the key tiles
//   twice: the first sums rowsum(p) and rowsum(p * dp) (a thread's partial
//   sums, then across the four threads of a quad that share a row), the
//   second forms ds and dQ; dQ's accumulator lives only in the second, which
//   keeps K5a within 128 registers a thread, so three blocks fit an SM. K5b
//   takes each query tile in two halves of 32 columns (m64n32 products for
//   S^T and dP^T): with dK and dV resident that keeps it at 128 registers,
//   like K5a, and one half's elementwise pass overlaps the other blocks'
//   products. Within a block, p is computed while dP's products still run,
//   and ds while dV's run.
// - The streamed 64 x 64 bf16 tiles (K and V in K5a, Q and G in K5b) arrive
//   through a ring of NST stages filled by TMA (cp.async.bulk.tensor), one
//   full and one empty mbarrier per stage, driven by a producer warp while
//   the consumer warpgroup computes on the previous stage; K5a's producer
//   streams the key tiles twice through the same ring. The tensor maps are
//   3-D, (batch, T, heads * 64), built on the host with
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
//   library does not link libcuda) and passed as __grid_constant__
//   parameters; rows past T within a batch are zero-filled by TMA, so the
//   ragged last tile of one batch never reads the next batch's rows. The
//   128-byte swizzle puts one 64-wide bf16 row in one swizzle line; every
//   wgmma descriptor uses the same swizzle, K-major for Q.K^T-style products
//   and MN-major (transposed B) for dS.K, P^T.G and dS^T.Q. K5b's per-column
//   lse and delta travel in the same stage, written by the producer lanes.
// - Both kernels stage their bf16 results in shared memory and write them
//   out as 16-byte stores. The building blocks (mbarriers, TMA, descriptors,
//   wgmma, tensor maps) are in hopper.cuh, shared with K2.
//
// Layout: q, k, v, g, dq, dk and dv are read and written in the natural
// (B, T, H, Dh) layout (row stride H*Dh), like K2, from 16-byte aligned
// bases (TMA); lse and delta are f32 (B, H, Tq). K5a writes delta (each
// block for its own rows) and K5b reads it, so K5a must run first on the
// same stream.
#include "hopper.cuh"

namespace {

constexpr int NST = 2;                   // stages of the streamed-tile ring
constexpr int CONSUMERS = WG;            // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp

struct SmemDq {
  bf16 q[TILE];        // resident A operands (1024-byte aligned, swizzled by TMA)
  bf16 g[TILE];
  bf16 k[NST][TILE];   // the ring
  bf16 v[NST][TILE];
  bf16 out[BT * LDO];  // dQ in bf16, staged for 16-byte stores
  uint64_t full[NST], empty[NST], res;
};

struct SmemDkv {
  bf16 k[TILE];
  bf16 v[TILE];
  bf16 q[NST][TILE];
  bf16 g[NST][TILE];
  bf16 dk[BT * LDO];
  bf16 dv[BT * LDO];
  float lse[NST][BT];    // per query column, times log2 e
  float delta[NST][BT];
  uint64_t full[NST], empty[NST], res;
};

__device__ __forceinline__ void consumer_sync() { named_sync<1, CONSUMERS>(); }

// ---- K5a ----------------------------------------------------------------

// S = Q . K^T and dP = G . V^T for one streamed key tile (keys [key0,
// key0 + 64)) on the accumulators, then p = 2^(s * scale2 - lse2) on s,
// keys >= tk at 0; p is computed while dP's products still run
__device__ __forceinline__ void scores_tile(const bf16* k_tile, const bf16* v_tile,
                                            uint64_t q_desc, uint64_t g_desc, float (&s)[32],
                                            float (&dp)[32], int key0, int tk, float scale2,
                                            const float (&lse2)[2]) {
  const uint64_t k_desc = desc(k_tile, DESC_K_MAJOR);
  const uint64_t v_desc = desc(v_tile, DESC_K_MAJOR);
  wg_fence();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {  // S = Q . K^T
    wgmma_ss(s, q_desc + kk * K_STEP, k_desc + kk * K_STEP, kk > 0);
  }
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {  // dP = G . V^T
    wgmma_ss(dp, g_desc + kk * K_STEP, v_desc + kk * K_STEP, kk > 0);
  }
  wg_commit();
  wg_wait<1>();  // S is ready; dP is still running
  fence_regs(s);
  const int col = key0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool valid = col + 8 * (i / 4) + (i % 2) < tk;
    s[i] = valid ? exp2f(fmaf(s[i], scale2, -lse2[(i % 4) / 2])) : 0.f;
  }
  wg_wait<0>();
  fence_regs(dp);
}

// one block per (b, h, 64-query tile); streams the key tiles twice
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map, const float* __restrict__ lse,
                    float* __restrict__ delta, bf16* __restrict__ dq, int tq, int tk, int heads,
                    float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemDq& sm = *reinterpret_cast<SmemDq*>(align1024(smem_raw));
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
      mbar_expect_tx(&sm.res, 2 * TILE_BYTES);
      tma_load(sm.q, &q_map, &sm.res, h * DH, q0, b);
      tma_load(sm.g, &g_map, &sm.res, h * DH, q0, b);
      for (int j = 0; j < 2 * n_tiles; ++j) {  // two sweeps over the key tiles
        const int s = j % NST;
        const int key0 = (j % n_tiles) * BT;
        if (j >= NST) mbar_wait(&sm.empty[s], ((j / NST) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.k[s], &k_map, &sm.full[s], h * DH, key0, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h * DH, key0, b);
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * row_stride + h * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * tq;

  // this thread's accumulator rows: r0 and r0 + 8
  const int r0 = (tid / 32) * 16 + lane / 4;
  float lse2[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int t = q0 + r0 + 8 * hi;
    lse2[hi] = t < tq ? lse[stat + t] * LOG2E : 0.f;
  }
  const float scale2 = scale * LOG2E;
  const uint64_t q_desc = desc(sm.q, DESC_K_MAJOR);
  const uint64_t g_desc = desc(sm.g, DESC_K_MAJOR);
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  mbar_wait(&sm.res, 0);

  // first sweep: rowsum(p) and rowsum(p * dp) over every key, this
  // thread's columns, then across the quad of threads that share a row
  float ps[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NST;
    mbar_wait(&sm.full[st], (j / NST) & 1);
    scores_tile(sm.k[st], sm.v[st], q_desc, g_desc, s, dp, j * BT, tk, scale2, lse2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dl[(i % 4) / 2] = fmaf(s[i], dp[i], dl[(i % 4) / 2]);
      ps[(i % 4) / 2] += s[i];
    }
    mbar_arrive(&sm.empty[st]);
  }
  // delta = rowsum(p * dp) / rowsum(p): the forward's lse is rounded to
  // f32, so rowsum(p) = 1 only to about 1e-6 at |lse| near 75, and in a
  // nearly one-hot row dp - delta would keep that much of dp; ds takes the
  // same factor (dsc = scale / rowsum(p))
  float dsc[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    dl[hi] += __shfl_xor_sync(0xffffffffu, dl[hi], 1);
    dl[hi] += __shfl_xor_sync(0xffffffffu, dl[hi], 2);
    ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 1);
    ps[hi] += __shfl_xor_sync(0xffffffffu, ps[hi], 2);
    dl[hi] /= ps[hi];
    dsc[hi] = scale / ps[hi];
    const int t = q0 + r0 + 8 * hi;
    if (lane % 4 == 0 && t < tq) delta[stat + t] = dl[hi];
  }

  // second sweep: ds = p * (dp - delta) * scale / rowsum(p), dQ += dS . K
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int j = n_tiles; j < 2 * n_tiles; ++j) {
    const int st = j % NST;
    mbar_wait(&sm.full[st], (j / NST) & 1);
    scores_tile(sm.k[st], sm.v[st], q_desc, g_desc, s, dp, (j - n_tiles) * BT, tk, scale2, lse2);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dl[(i % 4) / 2]) * dsc[(i % 4) / 2];
    uint32_t ds[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) a_fragment(ds[kk], s, kk);

    const uint64_t kt_desc = desc(sm.k[st], DESC_MN_MAJOR);
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_rs(acc, ds[kk], kt_desc + kk * MN_STEP);  // dQ += dS.K
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_regs(ds);
    mbar_arrive(&sm.empty[st]);
  }

  stage_rows(sm.out, acc, tid);
  consumer_sync();
  store_rows<CONSUMERS>(dq + qoff, sm.out, q0, tq, row_stride, tid);
}

// ---- K5b ----------------------------------------------------------------

// one block per (b, h, 64-key tile); streams the query tiles
__global__ void __launch_bounds__(THREADS, 3)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap g_map, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int tq, int tk, int heads, float scale) {
  extern __shared__ unsigned char smem_raw[];
  SmemDkv& sm = *reinterpret_cast<SmemDkv*>(align1024(smem_raw));
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int n_tiles = (tq + BT - 1) / BT;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * tq;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 32);  // every producer lane: its lse/delta stores
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_init(&sm.res, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp
    const int lane = threadIdx.x - CONSUMERS;
    if (lane == 0) {
      mbar_expect_tx(&sm.res, 2 * TILE_BYTES);
      tma_load(sm.k, &k_map, &sm.res, h * DH, k0, b);
      tma_load(sm.v, &v_map, &sm.res, h * DH, k0, b);
    }
    // lane l carries query rows l and l + 32 of the next tile's lse and
    // delta in registers, loaded while it waits for a free stage
    float next_lse[2], next_delta[2];
    auto fetch = [&](int j) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int t = j * BT + lane + 32 * part;
        next_lse[part] = t < tq ? lse[stat + t] * LOG2E : 0.f;
        next_delta[part] = t < tq ? delta[stat + t] : 0.f;
      }
    };
    fetch(0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NST;
      if (j >= NST) mbar_wait(&sm.empty[s], ((j / NST) & 1) ^ 1);
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        sm.lse[s][lane + 32 * part] = next_lse[part];
        sm.delta[s][lane + 32 * part] = next_delta[part];
      }
      if (lane == 0) {
        mbar_expect_tx(&sm.full[s], 2 * TILE_BYTES);
        tma_load(sm.q[s], &q_map, &sm.full[s], h * DH, j * BT, b);
        tma_load(sm.g[s], &g_map, &sm.full[s], h * DH, j * BT, b);
      } else {
        mbar_arrive(&sm.full[s]);
      }
      if (j + 1 < n_tiles) fetch(j + 1);
    }
    return;
  }

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const size_t koff = static_cast<size_t>(b) * tk * row_stride + h * DH;
  // this thread's accumulator rows (keys): r0 and r0 + 8
  const int r0 = (tid / 32) * 16 + lane / 4;
  const bool key_ok[2] = {k0 + r0 < tk, k0 + r0 + 8 < tk};
  const float scale2 = scale * LOG2E;

  // S^T and dP^T cover 32 query columns at a time (m64n32 products): with
  // dK and dV resident that keeps a thread at 128 registers, so three
  // blocks fit an SM
  float acc_dk[32], acc_dv[32], s[16], dp[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
  const uint64_t k_desc = desc(sm.k, DESC_K_MAJOR);
  const uint64_t v_desc = desc(sm.v, DESC_K_MAJOR);
  mbar_wait(&sm.res, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NST;
    mbar_wait(&sm.full[st], (j / NST) & 1);
    // this thread's query columns come in pairs (c, c + 1), c = 8 i + 2 (lane % 4)
    const int cq = 2 * (lane % 4);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {  // query columns [32 half, 32 half + 32) of the tile
      const int c0 = 32 * half;
      const uint64_t q_desc = desc(sm.q[st] + c0 * DH, DESC_K_MAJOR);
      const uint64_t g_desc = desc(sm.g[st] + c0 * DH, DESC_K_MAJOR);
      wg_fence();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // S^T = K . Q^T
        wgmma_ss32(s, k_desc + kk * K_STEP, q_desc + kk * K_STEP, kk > 0);
      }
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {  // dP^T = V . G^T
        wgmma_ss32(dp, v_desc + kk * K_STEP, g_desc + kk * K_STEP, kk > 0);
      }
      wg_commit();
      wg_wait<1>();  // S^T is ready; dP^T is still running
      fence_regs(s);

      // p^T on the accumulator registers, masked by key and query
      const float* lse_s = sm.lse[st] + c0;
      const float* delta_s = sm.delta[st] + c0;
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        const int c = cq + 8 * grp;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * grp + e;
          const bool valid = key_ok[e / 2] && j * BT + c0 + c + (e % 2) < tq;
          s[i] = valid ? exp2f(fmaf(s[i], scale2, -(e % 2 ? l2.y : l2.x))) : 0.f;
        }
      }
      uint32_t pf[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_fragment(pf[kk], s, kk);
      const uint64_t gt_desc = desc(sm.g[st], DESC_MN_MAJOR) + 2 * half * MN_STEP;
      wg_fence();
      fence_regs(acc_dv);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs(acc_dv, pf[kk], gt_desc + kk * MN_STEP);  // dV += P^T.G
      wg_commit();

      // ds^T while dV's products run
      wg_wait<1>();  // dP^T is ready
      fence_regs(dp);
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        const int c = cq + 8 * grp;
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * grp + e;
          dp[i] = s[i] * (dp[i] - (e % 2 ? d2.y : d2.x)) * scale;
        }
      }
      uint32_t dsf[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_fragment(dsf[kk], dp, kk);
      const uint64_t qt_desc = desc(sm.q[st], DESC_MN_MAJOR) + 2 * half * MN_STEP;
      wg_fence();
      fence_regs(acc_dk);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) wgmma_rs(acc_dk, dsf[kk], qt_desc + kk * MN_STEP);  // dK += dS^T.Q
      wg_commit();
      wg_wait<0>();  // before the next half rewrites s, dp and the fragments
      fence_regs(acc_dv);
      fence_regs(acc_dk);
    }
    mbar_arrive(&sm.empty[st]);
  }

  stage_rows(sm.dk, acc_dk, tid);
  stage_rows(sm.dv, acc_dv, tid);
  consumer_sync();
  store_rows<CONSUMERS>(dk + koff, sm.dk, k0, tk, row_stride, tid);
  store_rows<CONSUMERS>(dv + koff, sm.dv, k0, tk, row_stride, tid);
}

}  // namespace

// K5a. q/g/dq (batch, tq, heads, 64), k/v (batch, tk, heads, 64), bf16,
// contiguous, 16-byte aligned; lse (batch, heads, tq) f32 from
// wealy_flash_mha_fwd; writes dq and delta (batch, heads, tq) f32.
WEALY_API int wealy_flash_mha_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                                     const void* lse, void* delta, void* dq, int batch, int tq,
                                     int tk, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  // a runtime call first: it makes the device's primary context current on
  // this thread (autograd's device thread may have none yet), and the
  // driver's tensor-map encoder needs one
  const int smem = static_cast<int>(sizeof(SmemDq)) + 1024;
  cudaError_t err = set_smem(flash_bwd_dq_kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, gm;
  if ((err = tile_map(&qm, q, batch, tq, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&km, k, batch, tk, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&vm, v, batch, tk, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&gm, g, batch, tq, heads)) != cudaSuccess) return err;
  dim3 grid((tq + BT - 1) / BT, heads, batch);
  flash_bwd_dq_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, gm, static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<bf16*>(dq), tq, tk, heads, scale);
  return cudaGetLastError();
}

// K5b. Shapes as K5a; delta as K5a wrote it (launch K5a first on `stream`);
// writes dk and dv (batch, tk, heads, 64) bf16.
WEALY_API int wealy_flash_mha_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* g, const void* lse, const void* delta,
                                      void* dk, void* dv, int batch, int tq, int tk, int heads,
                                      int head_dim, float scale, void* stream) {
  if (head_dim != DH || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  // a runtime call first: it makes the device's primary context current on
  // this thread (autograd's device thread may have none yet), and the
  // driver's tensor-map encoder needs one
  const int smem = static_cast<int>(sizeof(SmemDkv)) + 1024;
  cudaError_t err = set_smem(flash_bwd_dkv_kernel, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm, gm;
  if ((err = tile_map(&qm, q, batch, tq, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&km, k, batch, tk, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&vm, v, batch, tk, heads)) != cudaSuccess) return err;
  if ((err = tile_map(&gm, g, batch, tq, heads)) != cudaSuccess) return err;
  dim3 grid((tk + BT - 1) / BT, heads, batch);
  flash_bwd_dkv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, gm, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, heads, scale);
  return cudaGetLastError();
}
