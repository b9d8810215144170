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
// rows (row >= tq) contribute nothing to dk/dv and are not written. delta is
// read off the bf16 forward output (the TPU kernels sum p * dp over every
// key instead): the two differ by out's rounding, which shows only in rows
// whose softmax is nearly one-hot, where dp - delta cancels below it.
//
// What bounds it on an H100: the tensor cores. Per head, K5a runs three
// T x T x 64 products (S, dP, dQ) and K5b four (S^T, dP^T, dV, dK): S and dP
// are recomputed in each kernel so that every output element is written by
// one block after a fixed order of adds, with no atomics, and repeated calls
// are bit-equal. The bytes (q/k/v/out/g in, dq/dk/dv out, 64-wide rows) are
// small beside that work at T = 1500, so the design is about keeping the
// tensor cores fed:
//
// - Every product is a Hopper warpgroup MMA (wgmma.mma_async, m64n64k16 or
//   m64n32k16, bf16 in, f32 accumulate). One consumer warpgroup (128 threads) owns a
//   64-row tile: 64 queries in K5a, 64 keys in K5b. Its own tile (Q and G in
//   K5a, K and V in K5b) is the A operand, read from shared memory; the
//   streamed tile is always B, from shared memory. dQ (K5a), dK and dV (K5b)
//   stay in f32 registers across the whole loop.
// - The elementwise pass runs on the accumulator registers. The wgmma
//   accumulator layout is fixed (thread t of warp w holds rows 16w + t/4 and
//   +8, columns 8i + 2(t%4) and +1), so each thread masks by its values' key
//   and query indices, computes p = exp2(s * scale * log2 e - lse * log2 e)
//   and ds, packs them to bf16 and hands them straight to the next wgmma as
//   its register A operand (dS.K in K5a; P^T.G and dS^T.Q in K5b: K5b
//   computes S^T and dP^T, whose rows are keys, so no transpose is needed).
//   Nothing of S, dP, p or ds goes to shared memory. K5b takes each query
//   tile in two halves of 32 columns (m64n32 products for S^T and dP^T):
//   with dK and dV resident that keeps it at 128 registers a thread, like
//   K5a, so three blocks fit an SM, and one half's elementwise pass overlaps
//   the other blocks' products. Within a block, p is computed while dP's
//   products still run, and ds while dV's run.
// - The streamed 64 x 64 bf16 tiles (K and V in K5a, Q and G in K5b) arrive
//   through a ring of NST stages filled by TMA (cp.async.bulk.tensor), one
//   full and one empty mbarrier per stage, driven by a producer warp while
//   the consumer warpgroup computes on the previous stage. The tensor maps
//   are 3-D, (batch, T, heads * 64), built on the host with
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
//   library does not link libcuda) and passed as __grid_constant__
//   parameters; rows past T within a batch are zero-filled by TMA, so the
//   ragged last tile of one batch never reads the next batch's rows. The
//   128-byte swizzle puts one 64-wide bf16 row in one swizzle line; every
//   wgmma descriptor uses the same swizzle, K-major for Q.K^T-style products
//   and MN-major (transposed B) for dS.K, P^T.G and dS^T.Q. K5b's per-column
//   lse and delta travel in the same stage, written by the producer lanes.
// - K5a computes delta with 16-byte loads, eight lanes per row and a
//   shuffle sum; both kernels stage their bf16 results in shared memory and
//   write them out as 16-byte stores.
//
// Layout: q, k, v, out, g, dq, dk and dv are read and written in the
// natural (B, T, H, Dh) layout (row stride H*Dh), like K2, from 16-byte
// aligned bases (TMA); lse and delta are f32 (B, H, Tq). K5a writes delta
// (each block for its own rows) and K5b reads it, so K5a must run first on
// the same stream.
#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int DH = 64;                         // head dim (every published Whisper size)
constexpr int BT = 64;                         // rows per tile: 64 queries (K5a) or keys (K5b)
constexpr int NST = 2;                         // stages of the streamed-tile ring
constexpr int CONSUMERS = 128;                 // one warpgroup
constexpr int THREADS = CONSUMERS + 32;        // + the producer warp
constexpr int TILE = BT * DH;                  // bf16 elements of a tile
constexpr uint32_t TILE_BYTES = TILE * 2;      // 8 KB: one TMA box
constexpr int LDO = DH + 8;                    // bf16 row stride of the output staging tile
constexpr float LOG2E = 1.4426950408889634f;

struct SmemDq {
  bf16 q[TILE];        // resident A operands (1024-byte aligned, swizzled by TMA)
  bf16 g[TILE];
  bf16 k[NST][TILE];   // the ring
  bf16 v[NST][TILE];
  bf16 out[BT * LDO];  // dQ in bf16, staged for 16-byte stores
  float delta[BT];
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

// ---- PTX wrappers -------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// returns once the phase of parity `parity` has completed; a phase that does
// not complete within about 10 s (a fault of the pipeline) traps rather than
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one 64 x 64 bf16 box at (column c0, row c1, batch c2) of a 3-D tensor map
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {  // the consumer warpgroup alone
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most `N` committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of `d` across the asynchronous MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptors for a 64 x 64 bf16 tile written by TMA
// with the 128-byte swizzle (1024-byte aligned): 8-row groups 1024 bytes
// apart. K-major: the operand's K runs along the 128-byte row, and the k-th
// 16-wide slice starts 32 bytes further. MN-major (transposed B): K runs
// down the rows, and the k-th slice starts 16 rows (2048 bytes) further.
// Both byte offsets are set to 1024 in the MN-major form (only the 8-row
// group stride is read when N is one swizzle line).
constexpr uint64_t DESC_K_MAJOR = (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
                                  (uint64_t(1) << 62);
constexpr uint64_t DESC_MN_MAJOR = (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
                                   (uint64_t(1) << 62);

__device__ __forceinline__ uint64_t desc(const bf16* tile, uint64_t kind) {
  return kind | static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4);
}
constexpr uint64_t K_STEP = 32 >> 4;    // descriptor step of one k-slice, K-major
constexpr uint64_t MN_STEP = 2048 >> 4;  // MN-major

#define WG_D32                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OUT(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 f32) (+)= A . B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 32 f32) (+)= A . B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A . B, A (64 x 16 bf16) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the k-th 16-column slice of a 64-row accumulator as a register A operand
// (the accumulator's layout of columns 16k..16k+15 is the A fragment's)
template <int N>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&d)[N], int k) {
  a[0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);
  a[1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);
  a[2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);
  a[3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// the accumulator (64 x 64 f32) as bf16 into a (64, LDO) staging tile
__device__ __forceinline__ void stage_rows(bf16* st, const float (&d)[32]) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(st + r0 * LDO + c) = pack_bf16(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * LDO + c) = pack_bf16(d[4 * i + 2], d[4 * i + 3]);
  }
}

// rows [t0, t0 + 64) of one head from the staging tile, rows >= t_len skipped
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* st, int t0, int t_len,
                                           size_t row_stride) {
#pragma unroll
  for (int it = 0; it < BT * DH / 8 / CONSUMERS; ++it) {
    const int idx = threadIdx.x + CONSUMERS * it;
    const int r = idx / (DH / 8);
    const int c = idx % (DH / 8);
    if (t0 + r < t_len) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(t0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * LDO + c * 8);
    }
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]);
    const float2 w = __bfloat1622float2(y[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// ---- K5a ----------------------------------------------------------------

// one block per (b, h, 64-query tile); streams the key tiles
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap g_map, const bf16* __restrict__ out,
                    const bf16* __restrict__ g, const float* __restrict__ lse,
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues every load
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(&sm.res, 2 * TILE_BYTES);
      tma_load(sm.q, &q_map, &sm.res, h * DH, q0, b);
      tma_load(sm.g, &g_map, &sm.res, h * DH, q0, b);
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
  const size_t row_stride = static_cast<size_t>(heads) * DH;
  const size_t qoff = static_cast<size_t>(b) * tq * row_stride + h * DH;
  const size_t stat = (static_cast<size_t>(b) * heads + h) * tq;

  // delta = rowsum(g * out): eight lanes per row, one 16-byte chunk each
#pragma unroll
  for (int it = 0; it < BT * 8 / CONSUMERS; ++it) {
    const int r = tid / 8 + (CONSUMERS / 8) * it;
    const int c = tid % 8;
    const int t = q0 + r;
    float d = 0.f;
    if (t < tq) {
      const size_t at = qoff + static_cast<size_t>(t) * row_stride + c * 8;
      d = dot8(__ldg(reinterpret_cast<const uint4*>(g + at)),
               __ldg(reinterpret_cast<const uint4*>(out + at)));
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (c == 0) {
      sm.delta[r] = d;
      if (t < tq) delta[stat + t] = d;
    }
  }
  consumer_sync();

  // this thread's accumulator rows: r0 and r0 + 8
  const int r0 = (tid / 32) * 16 + lane / 4;
  float lse2[2], dl[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int t = q0 + r0 + 8 * hi;
    lse2[hi] = t < tq ? lse[stat + t] * LOG2E : 0.f;
    dl[hi] = sm.delta[r0 + 8 * hi];
  }
  const float scale2 = scale * LOG2E;

  float acc[32], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = s[i] = dp[i] = 0.f;
  const uint64_t q_desc = desc(sm.q, DESC_K_MAJOR);
  const uint64_t g_desc = desc(sm.g, DESC_K_MAJOR);
  mbar_wait(&sm.res, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % NST;
    mbar_wait(&sm.full[st], (j / NST) & 1);
    const uint64_t k_desc = desc(sm.k[st], DESC_K_MAJOR);
    const uint64_t v_desc = desc(sm.v[st], DESC_K_MAJOR);
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

    // p, then ds, on the accumulator registers, masked by key
    const int key0 = j * BT + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool valid = key0 + 8 * (i / 4) + (i % 2) < tk;
      s[i] = valid ? exp2f(fmaf(s[i], scale2, -lse2[(i % 4) / 2])) : 0.f;
    }
    wg_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = s[i] * (dp[i] - dl[(i % 4) / 2]) * scale;
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
    mbar_arrive(&sm.empty[st]);
  }

  stage_rows(sm.out, acc);
  consumer_sync();
  store_rows(dq + qoff, sm.out, q0, tq, row_stride);
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
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

  stage_rows(sm.dk, acc_dk);
  stage_rows(sm.dv, acc_dv);
  consumer_sync();
  store_rows(dk + koff, sm.dk, k0, tk, row_stride);
  store_rows(dv + koff, sm.dv, k0, tk, row_stride);
}

// ---- host ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (batch, t, heads * 64) bf16 tensor as 64 x 64 boxes with the 128-byte
// swizzle; rows past t read as zeros
cudaError_t tile_map(CUtensorMap* map, const void* base, int batch, int t, int heads) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return cudaErrorMisalignedAddress;
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * DH;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * static_cast<cuuint64_t>(t)};
  const cuuint32_t box[3] = {DH, BT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// K5a. q/out/g/dq (batch, tq, heads, 64), k/v (batch, tk, heads, 64), bf16,
// contiguous, 16-byte aligned; lse (batch, heads, tq) f32 from
// wealy_flash_mha_fwd; writes dq and delta (batch, heads, tq) f32.
WEALY_API int wealy_flash_mha_bwd_dq(const void* q, const void* k, const void* v,
                                     const void* out, const void* g, const void* lse,
                                     void* delta, void* dq, int batch, int tq, int tk,
                                     int heads, int head_dim, float scale, void* stream) {
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
      qm, km, vm, gm, static_cast<const bf16*>(out), static_cast<const bf16*>(g),
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
