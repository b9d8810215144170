// Hopper building blocks shared by the attention kernels K2
// (flash_attention.cu) and K5a/K5b (flash_attention_bwd.cu), and by the MLP
// kernel K3 (fused_mlp.cu): mbarriers, TMA tile loads through 3-D (and, for
// K3, 2-D) tensor maps, wgmma descriptors for 128-byte swizzled bf16 tiles
// of 64-element rows, the wgmma products, and the staging of a 64-row
// accumulator for 16-byte stores. sm_90a only.
//
// The tiles: a 64 x 64 bf16 box (64 rows of one head, 128 bytes each) of a
// (batch, T, heads * 64) tensor, loaded by TMA with the 128-byte swizzle
// into a 1024-byte aligned slot; rows past T within a batch read as zeros.
// The wgmma accumulator layout (m64nN, f32) is fixed: thread t of warp w of
// the warpgroup holds rows 16w + t/4 and 16w + t/4 + 8, columns 8i + 2(t%4)
// and +1, as d[4i], d[4i+1] (first row) and d[4i+2], d[4i+3] (second row).
#pragma once

#include <cuda.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int DH = 64;                     // head dim (every published Whisper size)
constexpr int BT = 64;                     // rows of a tile (one TMA box)
constexpr int TILE = BT * DH;              // bf16 elements of a tile
constexpr uint32_t TILE_BYTES = TILE * 2;  // 8 KB
constexpr int WG = 128;                    // threads of a warpgroup
constexpr int LDO = DH + 8;                // bf16 row stride of an output staging tile
constexpr float LOG2E = 1.4426950408889634f;

// ---- mbarriers and TMA --------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after every mbar_init of a block, before the __syncthreads that publishes them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
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

// one box at (column c0, row c1) of a 2-D tensor map
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// a named barrier (ID >= 1; 0 is __syncthreads) over COUNT threads
template <int ID, int COUNT>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(COUNT) : "memory");
}

// ---- wgmma --------------------------------------------------------------

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// returns once at most `N` committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of `d` across the asynchronous
// MMAs (and keeps a register A operand in its registers until here)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
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

// d (64 x 128 f32) (+)= A . B, A (64 x 16) and B (128 x 16) K-major in shared
// memory: the GEMM tile of K3 (fused_mlp.cu). The accumulator layout is the
// m64n64 one continued: d[4i..4i+3] hold columns 8i + 2(t%4) and +1, i < 16.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
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

// ---- epilogue -----------------------------------------------------------

// the accumulator (64 x 64 f32) as bf16 into a (64, LDO) staging tile;
// `tid` is the thread's index in its warpgroup
__device__ __forceinline__ void stage_rows(bf16* st, const float (&d)[32], int tid) {
  const int lane = tid % 32;
  const int r0 = (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * (lane % 4);
    *reinterpret_cast<uint32_t*>(st + r0 * LDO + c) = pack_bf16(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(st + (r0 + 8) * LDO + c) = pack_bf16(d[4 * i + 2], d[4 * i + 3]);
  }
}

// rows [t0, t0 + 64) of one head from the staging tile as 16-byte stores by
// NT threads (`tid` in [0, NT)), rows >= t_len skipped
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* st, int t0, int t_len,
                                           size_t row_stride, int tid) {
#pragma unroll
  for (int it = 0; it < BT * DH / 8 / NT; ++it) {
    const int idx = tid + NT * it;
    const int r = idx / (DH / 8);
    const int c = idx % (DH / 8);
    if (t0 + r < t_len) {
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(t0 + r) * row_stride + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * LDO + c * 8);
    }
  }
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
// swizzle; rows past t read as zeros. The driver's encoder needs a current
// context: make a runtime call (it makes the device's primary context
// current on this thread) before the first one.
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

// a (rows, cols) row-major bf16 matrix as boxes of box_rows x 64 columns
// (one 128-byte swizzle line a row) with the 128-byte swizzle; rows and
// columns past the matrix read as zeros. cols must be a multiple of 8 (a
// 16-byte row pitch). Needs a current context, as tile_map.
cudaError_t matrix_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 8 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
