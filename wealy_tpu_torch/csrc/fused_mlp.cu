// K3: transformer MLP forward, gelu(x @ W1 + b1) @ W2 + b2, bf16 in and out.
//
// Replaces the TPU kernel wealy_tpu/ops/fused_mlp.py::_mlp_kernel
// (launched by _mlp_fwd_impl, public fused_mlp). Same numerics as
// _reference_mlp: both products accumulate in f32, b1 and b2 are added in
// f32, the exact GELU (erff) runs in f32 and its result is rounded to bf16
// before the second product. The Abramowitz-Stegun erf of the TPU kernel
// existed only because Mosaic has no erf; CUDA has erff.
//
// What bounds it on an H100: the tensor cores. At N = 6000 rows, D = 1280 the
// two products are 2 x N x D x 4D MACs (157 GFLOP per call) against
// about 26 MB of weights and 2 x 61 MB of bf16 hidden state. The TPU design
// keeps W1 and W2 resident in VMEM; at turbo width they are 26 MB and do not
// fit in shared memory, so this version runs two tiled GEMMs and the
// (N, 4D) bf16 hidden state goes through device memory (mostly L2 for
// small N). GEMM 1 has a bias + GELU epilogue, GEMM 2 a bias epilogue.
//
// The GEMM: 64 x 64 output tile per block of 4 warps (32 x 32 each, 2 x 2
// WMMA 16x16x16 bf16 fragments, f32 accumulators), K stepped by 32 through
// shared memory, no cp.async/TMA pipelining and no wgmma yet. Weights are
// taken in torch's nn.Linear layout (out_features, in_features), which is
// exactly the column-major B operand. Rows are ragged-masked; d_model and
// d_ff must be multiples of 64.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int LDA = BK + 8;  // bf16 row stride of the A tile (80 B)
constexpr int LDB = BK + 8;  // bf16 row stride of the W tile, stored [n][k]
constexpr int LDC = BN + 4;  // f32 row stride of the epilogue tile

// C (M, N) = epilogue(A (M, K) @ W^T + bias), W (N, K) row-major
template <bool GELU>
__global__ void __launch_bounds__(THREADS)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const float* __restrict__ bias, bf16* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BN * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += THREADS) {
      const int r = idx / (BK / 8);
      const int c = idx % (BK / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) {
        val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m0 + r) * K + k0 + c * 8);
      }
      *reinterpret_cast<uint4*>(As + r * LDA + c * 8) = val;
    }
    for (int idx = threadIdx.x; idx < BN * (BK / 8); idx += THREADS) {
      const int r = idx / (BK / 8);
      const int c = idx % (BK / 8);
      *reinterpret_cast<uint4*>(Bs + r * LDB + c * 8) =
          *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n0 + r) * K + k0 + c * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn + j * 16) * LDB + kk * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx % BN;
    if (m0 + r < M) {
      float x = Cs[r * LDC + c] + bias[n0 + c];
      if (GELU) x = 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
      C[static_cast<size_t>(m0 + r) * N + n0 + c] = __float2bfloat16(x);
    }
  }
}

}  // namespace

// x (rows, d_model) bf16; w1 (d_ff, d_model) bf16; b1 (d_ff) f32;
// w2 (d_model, d_ff) bf16; b2 (d_model) f32; hidden (rows, d_ff) bf16 scratch;
// out (rows, d_model) bf16. Both GEMMs go on `stream`, in order.
WEALY_API int wealy_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* hidden, void* out, int rows, int d_model,
                              int d_ff, void* stream) {
  if (rows <= 0 || d_model % BN || d_ff % BN) {  // BN is a multiple of BK
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + BM - 1) / BM;
  gemm_bias_kernel<true><<<dim3(d_ff / BN, row_blocks), THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<bf16*>(hidden), rows, d_ff, d_model);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gemm_bias_kernel<false><<<dim3(d_model / BN, row_blocks), THREADS, 0, s>>>(
      static_cast<const bf16*>(hidden), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), rows, d_model, d_ff);
  return cudaGetLastError();
}
