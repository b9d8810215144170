// K3: transformer MLP forward, gelu(x @ W1 + b1) @ W2 + b2, bf16 in and out.
//
// Replaces the TPU kernel wealy_tpu/ops/fused_mlp.py::_mlp_kernel
// (launched by _mlp_fwd_impl, public fused_mlp). Same numerics as
// _reference_mlp: both products take bf16 operands and accumulate in f32,
// b1 and b2 are added in f32, the exact GELU (erff) runs in f32 and its
// result is rounded to bf16 before the second product. The
// Abramowitz-Stegun erf of the TPU kernel existed only because Mosaic has no
// erf; CUDA has erff.
//
// What bounds it on an H100: the tensor cores. At N = 6000 rows, D = 1280
// the two products are 2 x N x D x 4D MACs (157 GFLOP per call, 159 us at
// the 989 TFLOP/s bf16 peak) against 26 MB of weights and 2 x 61 MB of bf16
// hidden state (about 37 us of device memory). The TPU design keeps W1 and
// W2 resident in VMEM; at turbo width they do not fit in shared memory, so
// this version runs two GEMMs and the (N, 4D) bf16 hidden state goes
// through device memory (mostly L2 at small N): GEMM 1 with a bias + GELU
// epilogue, GEMM 2 with a bias epilogue.
//
// The GEMM (C = epilogue(A . W^T + bias), A (M, K) and W (N, K) both
// K-major: x or the hidden state, and the weights in torch's nn.Linear
// layout):
//
// - A block owns a 128 x 128 tile of C: two consumer warpgroups of 64 rows
//   each, every k-step one m64n128k16 wgmma per 16 columns of K with both
//   operands read from shared memory, f32 accumulators in registers (64 a
//   thread), and one producer warp.
// - A and W arrive as 128 x 64 bf16 boxes (one 128-byte swizzle line a row,
//   the layout wgmma's K-major descriptor reads) by TMA from 2-D tensor
//   maps, through a ring of 3 or 4 stages (32 KB each, one full and one
//   empty mbarrier per stage) that the producer warp keeps full; rows of A
//   past M (the ragged last tile) and rows of W past N read as zeros. Each
//   warpgroup keeps one k-step's wgmma in flight while it waits for the
//   next stage, and frees a stage once the products that read it are done.
// - GEMM 1 keeps three stages (98 KB of shared memory, at most 112
//   registers a thread), so two blocks share an SM and one block's GELU
//   epilogue overlaps the other's products; GEMM 2 (K four times as long)
//   keeps four stages at one block an SM. setmaxnreg does not pay here:
//   the 64 accumulators a thread fit in either budget.
// - The epilogue runs on the accumulator registers: bias (and GELU) in f32,
//   packed to bf16, staged in the ring's shared memory (free once both
//   warpgroups' products are done), and written out as 16-byte stores,
//   rows >= M and columns >= N masked.
// - Tiles are handed out in groups of 8 row tiles, column tile by column
//   tile, so that a band of A rows and the W tiles they meet stay in L2.
// - The tensor maps of the weights, and of x and the hidden state, are
//   cached on the host by (pointer, shape): an encoding costs microseconds
//   of host time a call, which set the time of small calls in K2 and K5.
//
// d_model and d_ff must be multiples of 64 (one swizzle line of K); the row
// count is free. The building blocks (mbarriers, TMA, descriptors, wgmma,
// tensor maps) are in hopper.cuh, shared with K2 and K5a/K5b.
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                    // rows of C a block (two warpgroups)
constexpr int BN = 128;                    // columns of C a block
constexpr int BK = 64;                     // K a stage: one 128-byte swizzle line
constexpr int GROUP_M = 8;                 // row tiles a raster group
constexpr int CONSUMERS = 2 * WG;          // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
constexpr int LDS = BN + 8;                // bf16 row stride of the staging tile
constexpr uint32_t STAGE_BYTES = (BM + BN) * BK * 2;

// the ring: NST stages of an A and a W box
template <int NST>
struct SmemMlp {
  bf16 a[NST][BM * BK];  // 16 KB a stage, 1024-byte aligned
  bf16 b[NST][BN * BK];
  uint64_t full[NST], empty[NST];
  static_assert(sizeof(bf16) * NST * BM * BK >= sizeof(bf16) * BM * LDS,
                "the staging tile lives in the ring's A slots");
};

// GEMM 1 (the GELU epilogue, K = d_model) runs three stages at two blocks an
// SM, so that one block's epilogue overlaps the other's products; GEMM 2
// (K = 4 d_model) four stages at one block an SM: on an H100 the deeper ring
// ran GEMM 2 faster at d_model 1280, and GEMM 1 no faster
template <bool GELU>
struct Config {
  static constexpr int NST = GELU ? 3 : 4;
  static constexpr int BLOCKS = GELU ? 2 : 1;  // blocks an SM
};

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// C (M, N) = epilogue(A (M, K) . W^T + bias), W (N, K); K a multiple of BK
template <bool GELU>
__global__ void __launch_bounds__(THREADS, Config<GELU>::BLOCKS)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                bf16* __restrict__ C, int M, int N, int K) {
  constexpr int NST = Config<GELU>::NST;
  extern __shared__ unsigned char smem_raw[];
  SmemMlp<NST>& sm = *reinterpret_cast<SmemMlp<NST>*>(align1024(smem_raw));

  // grouped raster: GROUP_M row tiles sweep every column tile together
  const int tiles_m = (M + BM - 1) / BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (static_cast<int>(blockIdx.x) / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = static_cast<int>(blockIdx.x) % per_group;
  const int m0 = (first_m + in_group % group_m) * BM;
  const int n0 = (in_group / group_m) * BN;
  const int k_tiles = K / BK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues every load
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % NST;
        if (kt >= NST) mbar_wait(&sm.empty[s], ((kt / NST) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], STAGE_BYTES);
        tma_load_2d(sm.a[s], &a_map, &sm.full[s], kt * BK, m0);
        tma_load_2d(sm.b[s], &w_map, &sm.full[s], kt * BK, n0);
      }
    }
    return;
  }

  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % NST;
    mbar_wait(&sm.full[s], (kt / NST) & 1);
    const uint64_t da = desc(sm.a[s] + wg * 64 * BK, DESC_K_MAJOR);  // this warpgroup's rows
    const uint64_t dw = desc(sm.b[s], DESC_K_MAJOR);
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_ss128(acc, da + kk * K_STEP, dw + kk * K_STEP, 1);
    wg_commit();
    wg_wait<1>();  // the previous k-step's products are done: free its stage
    fence_regs(acc);
    if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % NST]);
  }
  wg_wait<0>();
  fence_regs(acc);

  // epilogue: every product of both warpgroups is done, so the ring is free
  named_sync<1, CONSUMERS>();
  bf16* st = sm.a[0];  // (BM, LDS) bf16
  const int lane = tid % 32;
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * (lane % 4);
    const int gc = n0 + c;
    const float bias0 = gc < N ? bias[gc] : 0.f;
    const float bias1 = gc + 1 < N ? bias[gc + 1] : 0.f;
    float v0 = acc[4 * i] + bias0, v1 = acc[4 * i + 1] + bias1;
    float v2 = acc[4 * i + 2] + bias0, v3 = acc[4 * i + 3] + bias1;
    if (GELU) {
      v0 = gelu(v0);
      v1 = gelu(v1);
      v2 = gelu(v2);
      v3 = gelu(v3);
    }
    *reinterpret_cast<uint32_t*>(st + r0 * LDS + c) = pack_bf16(v0, v1);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * LDS + c) = pack_bf16(v2, v3);
  }
  named_sync<1, CONSUMERS>();
#pragma unroll
  for (int it = 0; it < BM * BN / 8 / CONSUMERS; ++it) {
    const int idx = threadIdx.x + CONSUMERS * it;
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    if (m0 + r < M && n0 + c < N) {
      *reinterpret_cast<uint4*>(C + static_cast<size_t>(m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(st + r * LDS + c);
    }
  }
}

// host: tensor maps cached by everything they encode
struct MapEntry {
  const void* base;
  int rows, cols;
  CUtensorMap map;
};
constexpr int kMapCache = 32;
MapEntry g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mutex;

cudaError_t cached_map(CUtensorMap* out, const void* base, int rows, int cols) {
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.base == base && e.rows == rows && e.cols == cols) {
      *out = e.map;
      return cudaSuccess;
    }
  }
  // a runtime call first: it makes the device's primary context current on
  // this thread (autograd's device thread may have none), and the driver's
  // tensor-map encoder needs one
  cudaError_t err = cudaFree(nullptr);
  if (err != cudaSuccess) return err;
  MapEntry e{base, rows, cols, {}};
  if ((err = matrix_map(&e.map, base, rows, cols, 128)) != cudaSuccess) return err;
  g_maps[g_map_next] = e;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  *out = e.map;
  return cudaSuccess;
}

template <bool GELU>
cudaError_t launch_gemm(const void* a, const void* w, const void* bias, void* c, int M, int N,
                        int K, cudaStream_t s) {
  CUtensorMap am, wm;
  cudaError_t err;
  if ((err = cached_map(&am, a, M, K)) != cudaSuccess) return err;
  if ((err = cached_map(&wm, w, N, K)) != cudaSuccess) return err;
  const int blocks = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int smem = static_cast<int>(sizeof(SmemMlp<Config<GELU>::NST>)) + 1024;
  mlp_gemm_kernel<GELU><<<blocks, THREADS, smem, s>>>(am, wm, static_cast<const float*>(bias),
                                                       static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

template <bool GELU>
cudaError_t prepare() {
  const int smem = static_cast<int>(sizeof(SmemMlp<Config<GELU>::NST>)) + 1024;
  cudaError_t err = set_smem(mlp_gemm_kernel<GELU>, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(mlp_gemm_kernel<GELU>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// the kernels' attributes, set once for each device
cudaError_t prepare_device() {
  static bool done[64] = {};
  static std::mutex mutex;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  if (dev < 64 && done[dev]) return cudaSuccess;
  if ((err = prepare<true>()) != cudaSuccess) return err;
  if ((err = prepare<false>()) != cudaSuccess) return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

}  // namespace

// x (rows, d_model) bf16; w1 (d_ff, d_model) bf16; b1 (d_ff) f32;
// w2 (d_model, d_ff) bf16; b2 (d_model) f32; hidden (rows, d_ff) bf16 scratch;
// out (rows, d_model) bf16; bf16 bases 16-byte aligned. Both GEMMs go on
// `stream`, in order.
WEALY_API int wealy_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* hidden, void* out, int rows, int d_model,
                              int d_ff, void* stream) {
  if (rows <= 0 || d_model <= 0 || d_ff <= 0 || d_model % BK || d_ff % BK) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_device();
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_gemm<true>(x, w1, b1, hidden, rows, d_ff, d_model, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<false>(hidden, w2, b2, out, rows, d_model, d_ff, s);
}
