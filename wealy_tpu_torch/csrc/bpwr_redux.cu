// K4: chunk-set "bpwr" reduction (best pairs without replacement), f32.
//
// Replaces the TPU kernel wealy_tpu/ops/pallas_redux.py::_bpwr_kernel
// (launched by _bpwr_redux_impl, public bpwr_block_redux). For each
// (query q, candidate b) pair it reduces the s1 x s2 tile of chunk-pair
// distances d[q, b] to one song distance, as ops/redux.py::_bpwr does:
// the tile is read transposed when s2 < s1 (so rows are the smaller side);
// n rounds each take the minimum mn of the live entries (1e12 when none is
// live), select the live entries <= mn, and knock out every row and column
// whose live minimum is <= mn; the result is sum(selected) / max(count, eps).
// An entry is live while its row and its column are: chunk exclusions
// (qvalid, cvalid) only ever remove whole rows and columns, so liveness is
// one flag per row and per column, read from the validity masks in-kernel,
// with no exclusion fill written into d. A pair with no valid entry gives 0.
//
// Numerics: the selected entries are added along each row from column 0,
// then the row sums from row 0, one f32 rounding per add, with no FMA (there
// is no multiply). ops/redux.py::ordered_selected_mean adds in the same
// order, so the kernel is bit-equal to its plain version, and two calls on
// the same input give the same bits (no atomics, a fixed order). The rank
// passes of parallel/similarity.py compare scores of two passes with ==.
//
// What bounds it on an H100: not device memory. At the evaluate block
// (Q = B = 222, s1 = s2 = 18) the tile is read once, 64 MB, about 19 us at
// 3.35 TB/s. The knockout is about n * s1 * s2 compares per pair, each round
// reading the whole live tile twice (row pass, column pass) from shared
// memory: 2 * 18 * 324 loads for each of 49,284 pairs, about 575 M loads,
// with 18 of a warp's 32 lanes busy at s = 18. So it is bound by shared-
// memory loads and instruction throughput, about ten times the memory floor. The
// plain version instead makes n round trips of the whole tensor through
// device memory. Design: one warp per pair; the tile lives in shared memory
// with an odd row pitch (the row pass, one row per lane, is free of bank
// conflicts; the column pass reads consecutive words); row and column minima
// go through shared memory, the global minimum through warp shuffles; the
// warps of a block take consecutive candidates of one query, so their tile
// reads fall on neighbouring addresses of the (Q*s1, B*s2) distance matrix,
// which is read through its strides without a copy.
//
// Limits: max(s1, s2) <= 128 (the wrapper raises above). Above 48 KB of
// shared memory per block (one warp at s > ~100) the launch asks for more.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxSide = 128;
constexpr int kMaxWarps = 8;
constexpr size_t kDefaultSmem = 48 * 1024;

// shared memory of one warp: tile (rows x pitch), row and column minima (f32),
// then the per-entry selected flags and the row and column live flags (bytes)
__host__ __device__ inline size_t warp_bytes(int rows, int cols) {
  const size_t pitch = static_cast<size_t>(cols | 1);
  const size_t floats = rows * pitch + rows + cols;
  const size_t bytes = static_cast<size_t>(rows) * cols + rows + cols;
  return (floats * sizeof(float) + bytes + 15) & ~static_cast<size_t>(15);
}

__global__ void bpwr_kernel(const float* __restrict__ d, const uint8_t* __restrict__ qvalid,
                            const uint8_t* __restrict__ cvalid, float* __restrict__ out, int Q,
                            int B, int s1o, int s2o, long long sq, long long sb, long long si,
                            long long sj, int n_rounds, float eps, float inf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool swap = s2o < s1o;
  const int rows = swap ? s2o : s1o;  // the smaller side
  const int cols = swap ? s1o : s2o;
  const int pitch = cols | 1;

  const long long pair = static_cast<long long>(blockIdx.x) * warps + warp;
  if (pair >= static_cast<long long>(Q) * B) return;  // the whole warp leaves
  const int q = static_cast<int>(pair / B);
  const int b = static_cast<int>(pair - static_cast<long long>(q) * B);

  unsigned char* base = smem + warp * warp_bytes(rows, cols);
  float* tile = reinterpret_cast<float*>(base);
  float* rmin = tile + static_cast<size_t>(rows) * pitch;
  float* cmin = rmin + rows;
  uint8_t* sel = reinterpret_cast<uint8_t*>(cmin + cols);
  uint8_t* rlive = sel + rows * cols;
  uint8_t* clive = rlive + rows;

  // one read of the tile, in d's own order; stored transposed when swapped
  const float* dp = d + q * sq + b * sb;
  for (int idx = lane; idx < s1o * s2o; idx += 32) {
    const int i = idx / s2o;
    const int j = idx - i * s2o;
    const float v = dp[i * si + j * sj];
    if (swap) {
      tile[j * pitch + i] = v;
    } else {
      tile[i * pitch + j] = v;
    }
  }
  const uint8_t* qv = qvalid + static_cast<size_t>(q) * s1o;
  const uint8_t* cv = cvalid + static_cast<size_t>(b) * s2o;
  for (int r = lane; r < rows; r += 32) rlive[r] = swap ? cv[r] : qv[r];
  for (int c = lane; c < cols; c += 32) clive[c] = swap ? qv[c] : cv[c];
  for (int idx = lane; idx < rows * cols; idx += 32) sel[idx] = 0;
  __syncwarp();

  int count = 0;  // entries this lane selected
  for (int round = 0; round < n_rounds; ++round) {
    for (int r = lane; r < rows; r += 32) {
      float m = inf;
      if (rlive[r]) {
        const float* row = tile + r * pitch;
        for (int c = 0; c < cols; ++c) {
          if (clive[c]) m = fminf(m, row[c]);
        }
      }
      rmin[r] = m;
    }
    for (int c = lane; c < cols; c += 32) {
      float m = inf;
      if (clive[c]) {
        for (int r = 0; r < rows; ++r) {
          if (rlive[r]) m = fminf(m, tile[r * pitch + c]);
        }
      }
      cmin[c] = m;
    }
    __syncwarp();
    float mn = inf;
    for (int r = lane; r < rows; r += 32) mn = fminf(mn, rmin[r]);
    for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    // only a row whose live minimum is mn can hold an entry <= mn
    for (int r = lane; r < rows; r += 32) {
      if (rlive[r] && rmin[r] <= mn) {
        const float* row = tile + r * pitch;
        for (int c = 0; c < cols; ++c) {
          if (clive[c] && row[c] <= mn) {
            sel[r * cols + c] = 1;
            ++count;
          }
        }
      }
    }
    __syncwarp();
    for (int r = lane; r < rows; r += 32) {
      if (rmin[r] <= mn) rlive[r] = 0;
    }
    for (int c = lane; c < cols; c += 32) {
      if (cmin[c] <= mn) clive[c] = 0;
    }
    __syncwarp();
    if (mn >= inf) break;  // every row is now knocked out: later rounds select nothing
  }

  for (int r = lane; r < rows; r += 32) {
    const float* row = tile + r * pitch;
    const uint8_t* sr = sel + r * cols;
    float s = 0.f;
    for (int c = 0; c < cols; ++c) s += sr[c] ? row[c] : 0.f;
    rmin[r] = s;
  }
  for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(0xffffffffu, count, o);
  __syncwarp();
  if (lane == 0) {
    float total = 0.f;
    for (int r = 0; r < rows; ++r) total += rmin[r];
    out[pair] = total / fmaxf(static_cast<float>(count), eps);
  }
}

}  // namespace

// d: f32 (Q, B, s1, s2) read through the element strides sq, sb, si, sj;
// qvalid (Q, s1) and cvalid (B, s2): contiguous bytes, nonzero = valid chunk;
// out: contiguous f32 (Q, B). n_rounds = max(1, min(n, min(s1, s2))).
WEALY_API int wealy_bpwr_redux(const void* d, const void* qvalid, const void* cvalid, void* out,
                               int Q, int B, int s1, int s2, long long sq, long long sb,
                               long long si, long long sj, int n_rounds, float eps, float inf,
                               void* stream) {
  if (Q <= 0 || B <= 0 || s1 <= 0 || s2 <= 0 || s1 > kMaxSide || s2 > kMaxSide ||
      n_rounds <= 0) {
    return cudaErrorInvalidValue;
  }
  const int rows = s1 < s2 ? s1 : s2;
  const int cols = s1 < s2 ? s2 : s1;
  const size_t per_warp = warp_bytes(rows, cols);
  size_t warps = kDefaultSmem / per_warp;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = warps * per_warp;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        bpwr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long pairs = static_cast<long long>(Q) * B;
  const long long blocks = (pairs + static_cast<long long>(warps) - 1) / static_cast<long long>(warps);
  bpwr_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(warps * 32), smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const uint8_t*>(qvalid),
      static_cast<const uint8_t*>(cvalid), static_cast<float*>(out), Q, B, s1, s2, sq, sb, si,
      sj, n_rounds, eps, inf);
  return cudaGetLastError();
}
