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
// The knockout as the kernels run it: the live entries <= mn are those equal
// to the live minimum, so the rows and the columns a round knocks out are
// exactly those holding a selected entry. A row is therefore selected in at
// most one round, and its selected entries are all live in that round: the
// row's sum is formed then, and the row is dead afterwards.
//
// Numerics: the selected entries are added along each row from column 0,
// then the row sums from row 0, one f32 rounding per add, with no FMA (there
// is no multiply). ops/redux.py::ordered_selected_mean adds in the same
// order, so every route is bit-equal to the plain version, and two calls on
// the same input give the same bits (no atomics, a fixed order). The rank
// passes of parallel/similarity.py compare scores of two passes with ==.
//
// What bounds it on an H100: at the evaluate block (Q = B = 222, s1 = s2 =
// 18) the tile is read once, 64 MB, about 19 us at 3.35 TB/s; the knockout
// is up to 18 rounds per pair of a min over the live tile, about 49,284 x 18
// x 324 = 287 M compares, which would be about 4 us at the f32 rate if every
// lane of the card did one a cycle. A knockout round is a chain of dependent
// steps (row min, a minimum across the rows, the select, an OR across the
// rows), so a pass over the tile each round makes it bound by instruction
// issue, not by the read; the sorted route takes the row minima out of the
// rounds. Two routes, by tile shape (rows R = the smaller side, columns
// C = the larger), chosen in one place (pick_route):
//
// - sorted (R <= 32, C <= 32): one lane per row. Each lane sorts its row
//   once, with the column indices, in registers (C rounded up to 20, for
//   the smax 18 of every product shape, where a 32-entry sort made the
//   kernel 1.5x slower, or to 32; padded with +inf; an unrolled odd-even
//   merge network), into shared memory, and keeps a
//   pointer to its first entry in a live column: that entry is the row's
//   live minimum. Column liveness is one bitmask. A round is then: a minimum
//   across the rows (__reduce_min_sync on order-preserving keys, or
//   shuffles); on the lanes holding it, the walk over their entries equal to
//   mn (one, but for ties), whose column bits the lanes OR together
//   (__reduce_or_sync) into the columns to knock out, the row knocking
//   itself out; and on the lanes whose minimum's column died, a step of the
//   pointer past the dead columns. Every selected entry equals mn, so a
//   row's sum in column order is mn added once per selected entry. A round
//   costs a few dozen instructions, where a pass over the row costs C. Where
//   R <= 16 two pairs share a warp (16 lanes each), so small tiles do not
//   leave half the lanes idle.
// - block (any other tile): one block per pair, one thread per row up to
//   256 rows (a warp where R <= 32); the tile in dynamic shared memory where
//   it fits (up to the opt-in limit), else read from device memory through
//   its strides each round; row and column live flags in shared memory; each
//   row keeps its minimum and the column holding it, and recomputes them
//   only when that column dies.
//
// The grid is sized so that at least two blocks land on each SM where the
// pair count allows it (the serving blocks give 512-8,192 pairs a launch).
// d is read through its strides: the rank passes' (Q, N, s1, s2) view of the
// (Q*s1, N*s2) distance matrix gets no copy.
#include <algorithm>
#include <cstdint>
#include <utility>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kSortedSide = 32;  // the sorted route's largest side
constexpr int kBlockThreads = 256;
// the block kernel's static shared memory (block_min's and the count's scratch)
constexpr size_t kBlockStaticBytes = kBlockThreads / 32 * (sizeof(float) + sizeof(int));

enum Route : int { kSorted = 0, kBlockShared = 1, kBlockDevice = 2 };

struct Tile {
  const float* d;
  const uint8_t* qvalid;
  const uint8_t* cvalid;
  float* out;
  long long pairs;
  int B, s1, s2;
  long long sq, sb, si, sj;
  int n_rounds;
  float eps, inf;
};

// float -> unsigned key with the same order (for __reduce_min_sync)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// reductions over the L lanes of one group (L = 32: the warp; L = 16: each
// half); every lane of the warp calls them
template <int L>
__device__ __forceinline__ float group_min(float v) {
  if constexpr (L == 32) {
    return key_value(__reduce_min_sync(FULL, order_key(v)));
  } else {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
    return v;
  }
}
template <int L>
__device__ __forceinline__ uint32_t group_or(uint32_t v) {
  if constexpr (L == 32) {
    return __reduce_or_sync(FULL, v);
  } else {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
    return v;
  }
}
template <int L>
__device__ __forceinline__ int group_sum(int v) {
  if constexpr (L == 32) {
    return static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(v)));
  } else {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
  }
}

// which pair a group of L lanes owns, and its orientation
struct Pair {
  long long id;
  bool active, swap;
  int rows, cols;
  const float* base;
  long long rs, cs;  // element strides along a row index and a column index
  const uint8_t* rv;  // validity of the rows and of the columns
  const uint8_t* cv;
};

__device__ __forceinline__ Pair locate(const Tile& t, long long id) {
  Pair p;
  p.id = id;
  p.active = id < t.pairs;
  const long long pid = p.active ? id : 0;
  const int q = static_cast<int>(pid / t.B);
  const int b = static_cast<int>(pid - static_cast<long long>(q) * t.B);
  p.swap = t.s2 < t.s1;
  p.rows = p.swap ? t.s2 : t.s1;
  p.cols = p.swap ? t.s1 : t.s2;
  p.base = t.d + q * t.sq + b * t.sb;
  p.rs = p.swap ? t.sj : t.si;
  p.cs = p.swap ? t.si : t.sj;
  const uint8_t* qv = t.qvalid + static_cast<size_t>(q) * t.s1;
  const uint8_t* cv = t.cvalid + static_cast<size_t>(b) * t.s2;
  p.rv = p.swap ? cv : qv;
  p.cv = p.swap ? qv : cv;
  return p;
}

// the end of the sorted route: the row sums added from row 0 (each lane holds
// its row's), the counts summed, lane 0 of the group writes the mean
template <int L>
__device__ __forceinline__ void finish(const Tile& t, const Pair& p, float rsum, int cnt, int r) {
  float total = 0.f;
  for (int rr = 0; rr < p.rows; ++rr) total = total + __shfl_sync(FULL, rsum, rr, L);
  const int count = group_sum<L>(cnt);
  if (p.active && r == 0) t.out[p.id] = total / fmaxf(static_cast<float>(count), t.eps);
}

// ---- the sorted route: R <= 32, C <= CMAX <= 32 --------------------------

// Batcher's odd-even merge sorting network on N <= 32 values (padded to 32
// with +inf; the comparators that only meet the padding are left out, since
// +inf stays in place), built at compile time
struct Network {
  int a[192], b[192];  // comparator q orders positions a[q] < b[q]
  int n;
};

__host__ __device__ constexpr Network odd_even_merge(int N) {
  Network net{};
  constexpr int P = 32;
  for (int p = 1; p < P; p <<= 1) {
    for (int k = p; k >= 1; k >>= 1) {
      for (int j = k % p; j + k < P; j += 2 * k) {
        for (int i = 0; i < k; ++i) {
          const int a = i + j;
          const int b = i + j + k;
          if (b < N && i < P - j - k && a / (2 * p) == b / (2 * p)) {
            net.a[net.n] = a;
            net.b[net.n] = b;
            ++net.n;
          }
        }
      }
    }
  }
  return net;
}

template <int N>
struct NetworkOf {
  static constexpr Network net = odd_even_merge(N);
};

// the positions are template arguments, so v and c stay in registers
template <int A, int B, int N>
__device__ __forceinline__ void compare_swap(float (&v)[N], int (&c)[N]) {
  const bool swap = v[B] < v[A];
  const float va = v[A], vb = v[B];
  const int ca = c[A], cb = c[B];
  v[A] = swap ? vb : va;
  v[B] = swap ? va : vb;
  c[A] = swap ? cb : ca;
  c[B] = swap ? ca : cb;
}

template <int N, int... Q>
__device__ __forceinline__ void run_network(float (&v)[N], int (&c)[N],
                                            std::integer_sequence<int, Q...>) {
  (compare_swap<NetworkOf<N>::net.a[Q], NetworkOf<N>::net.b[Q], N>(v, c), ...);
}

// sorts v ascending, and c along with it
template <int N>
__device__ __forceinline__ void sort_row(float (&v)[N], int (&c)[N]) {
  run_network<N>(v, c, std::make_integer_sequence<int, NetworkOf<N>::net.n>{});
}

template <int L, int CMAX>
__global__ void __launch_bounds__(128) bpwr_sorted_kernel(const Tile t) {
  // each lane's sorted row, entry k of lane l at [k * 32 + l]: the lanes'
  // reads at different k fall in distinct banks
  __shared__ float s_val[4][CMAX * 32];
  __shared__ uint8_t s_col[4][CMAX * 32];
  const int lane = threadIdx.x & 31;
  const int r = lane % L;
  const long long warp = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const Pair p = locate(t, warp * (32 / L) + lane / L);
  float* sv = s_val[threadIdx.x >> 5] + lane;
  uint8_t* sc = s_col[threadIdx.x >> 5] + lane;

  // the column validity as bits, then this lane's row (dead entries +inf),
  // sorted once with its column indices
  uint32_t live_cols = 0;
  if (p.active) {
    for (int c = r; c < p.cols; c += L) live_cols |= p.cv[c] ? (1u << c) : 0u;
  }
  live_cols = group_or<L>(live_cols);
  bool live = p.active && r < p.rows && p.rv[r];
  {
    float v[CMAX];
    int c[CMAX];
    const float* rp = p.base + r * p.rs;
#pragma unroll
    for (int k = 0; k < CMAX; ++k) {
      v[k] = (live && ((live_cols >> k) & 1u)) ? rp[k * p.cs] : INFINITY;
      c[k] = k;
    }
    sort_row<CMAX>(v, c);
#pragma unroll
    for (int k = 0; k < CMAX; ++k) {
      sv[k * 32] = v[k];
      sc[k * 32] = static_cast<uint8_t>(c[k]);
    }
  }
  // the row's live minimum is its first sorted entry in a live column
  int ptr = 0;
  float m = sv[0];
  int col = sc[0];

  float rsum = 0.f;
  int cnt = 0;
  for (int round = 0; round < t.n_rounds; ++round) {
    const float mn = group_min<L>(live ? fminf(m, t.inf) : t.inf);
    if (__all_sync(FULL, mn >= t.inf)) break;  // nothing live: later rounds select nothing
    uint32_t bits = 0;
    if (live && m <= mn && mn < t.inf) {
      // this row holds the minimum: its live entries <= mn, which all equal
      // mn, follow one another in the sorted row
      for (int k = ptr; k < CMAX; ++k) {
        if (!(sv[k * 32] <= mn)) break;
        const int c = sc[k * 32];
        bits |= ((live_cols >> c) & 1u) << c;
      }
      // the row's sum in column order is mn added once per selected entry
      cnt = __popc(bits);
      for (int k = 0; k < cnt; ++k) rsum = rsum + mn;
      live = false;
    }
    const uint32_t dead = group_or<L>(bits);
    live_cols &= ~dead;
    if (live && ((dead >> col) & 1u)) {  // the row's minimum died: step to the next live entry
      do {
        ++ptr;
      } while (ptr < CMAX && !((live_cols >> sc[ptr * 32]) & 1u));
      m = ptr < CMAX ? sv[ptr * 32] : INFINITY;
      col = ptr < CMAX ? sc[ptr * 32] : 0;
    }
  }
  finish<L>(t, p, rsum, cnt, r);
}

// ---- the block route: one block per pair, any tile -----------------------
struct BlockLayout {
  size_t tile, rmin, rsum, rarg, rlive, clive, ckill, bytes;
};

__host__ __device__ inline BlockLayout block_layout(int rows, int cols, bool in_smem) {
  BlockLayout l;
  size_t at = 0;
  l.tile = at;
  if (in_smem) at += static_cast<size_t>(rows) * (cols | 1) * sizeof(float);
  l.rmin = at;
  at += rows * sizeof(float);
  l.rsum = at;
  at += rows * sizeof(float);
  l.rarg = at;
  at += rows * sizeof(int);
  l.rlive = at;
  at += rows;
  l.clive = at;
  at += cols;
  l.ckill = at;
  at += cols;
  l.bytes = (at + 15) & ~static_cast<size_t>(15);
  return l;
}

// the minimum over the block; `scratch` holds one float a warp
__device__ __forceinline__ float block_min(float v, float* scratch) {
  v = key_value(__reduce_min_sync(FULL, order_key(v)));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fminf(m, scratch[w]);
  __syncthreads();
  return m;
}

__global__ void __launch_bounds__(kBlockThreads) bpwr_block_kernel(const Tile t, int in_smem) {
  extern __shared__ __align__(16) unsigned char smem_block[];
  __shared__ float red[kBlockThreads / 32];
  __shared__ int red_cnt[kBlockThreads / 32];
  const Pair p = locate(t, blockIdx.x);
  const int R = p.rows;
  const int C = p.cols;
  const int pitch = C | 1;
  const BlockLayout l = block_layout(R, C, in_smem != 0);
  float* tile = reinterpret_cast<float*>(smem_block + l.tile);
  float* rmin = reinterpret_cast<float*>(smem_block + l.rmin);
  float* rsum = reinterpret_cast<float*>(smem_block + l.rsum);
  int* rarg = reinterpret_cast<int*>(smem_block + l.rarg);
  uint8_t* rlive = smem_block + l.rlive;
  uint8_t* clive = smem_block + l.clive;
  uint8_t* ckill = smem_block + l.ckill;
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  if (in_smem) {
    for (int idx = tid; idx < t.s1 * t.s2; idx += T) {
      const int i = idx / t.s2;
      const int j = idx - i * t.s2;
      tile[(p.swap ? j : i) * pitch + (p.swap ? i : j)] = p.base[i * t.si + j * t.sj];
    }
  }
  for (int r = tid; r < R; r += T) {
    rlive[r] = p.rv[r] ? 1 : 0;
    rsum[r] = 0.f;
    rarg[r] = -1;  // the row's minimum is not known yet
    rmin[r] = t.inf;
  }
  for (int c = tid; c < C; c += T) {
    clive[c] = p.cv[c] ? 1 : 0;
    ckill[c] = 0;
  }
  __syncthreads();

  auto at = [&](int r, int c) -> float {
    return in_smem ? tile[r * pitch + c] : p.base[r * p.rs + c * p.cs];
  };

  int cnt = 0;
  for (int round = 0; round < t.n_rounds; ++round) {
    // each live row's minimum over the live columns, recomputed only when
    // the column that held it died (columns never come back)
    float m = t.inf;
    for (int r = tid; r < R; r += T) {
      if (!rlive[r]) continue;
      const int a = rarg[r];
      if (round == 0 || (a >= 0 && !clive[a])) {
        float best = t.inf;
        int arg = -1;
        for (int c = 0; c < C; ++c) {
          if (!clive[c]) continue;
          const float v = at(r, c);
          if (v < best || arg < 0) {
            best = fminf(best, v);
            arg = c;
          }
        }
        rmin[r] = best;
        rarg[r] = arg;
      }
      m = fminf(m, rmin[r]);
    }
    const float mn = block_min(m, red);
    if (mn >= t.inf) break;  // uniform: every thread read the same minimum
    for (int r = tid; r < R; r += T) {
      if (!rlive[r] || !(rmin[r] <= mn)) continue;
      float s = 0.f;
      for (int c = 0; c < C; ++c) {
        const float v = at(r, c);
        const bool sel = clive[c] && v <= mn;
        s = s + (sel ? v : 0.f);
        if (sel) {
          ckill[c] = 1;
          ++cnt;
        }
      }
      rsum[r] = s;
      rlive[r] = 0;
    }
    __syncthreads();
    for (int c = tid; c < C; c += T) {
      if (ckill[c]) {
        clive[c] = 0;
        ckill[c] = 0;
      }
    }
    __syncthreads();
  }

  cnt = static_cast<int>(__reduce_add_sync(FULL, static_cast<unsigned>(cnt)));
  if ((tid & 31) == 0) red_cnt[tid >> 5] = cnt;
  __syncthreads();
  if (tid == 0) {
    int count = 0;
    for (int w = 0; w < T / 32; ++w) count += red_cnt[w];
    float total = 0.f;
    for (int r = 0; r < R; ++r) total = total + rsum[r];
    t.out[p.id] = total / fmaxf(static_cast<float>(count), t.eps);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// warps per block for `warps` warps in all: four, halved while the grid
// would give fewer than two blocks to each SM
int warps_per_block(long long warps) {
  int wpb = 4;
  while (wpb > 1 && (warps + wpb - 1) / wpb < 2LL * sm_count()) wpb /= 2;
  return wpb;
}

template <int L, int CMAX>
cudaError_t launch_sorted(const Tile& t, cudaStream_t s) {
  const long long warps = (t.pairs + (32 / L) - 1) / (32 / L);
  const int wpb = warps_per_block(warps);
  const long long blocks = (warps + wpb - 1) / wpb;
  bpwr_sorted_kernel<L, CMAX><<<static_cast<unsigned>(blocks), wpb * 32, 0, s>>>(t);
  return cudaGetLastError();
}

cudaError_t launch_block(const Tile& t, int rows, int cols, bool in_smem, cudaStream_t s) {
  const size_t smem = block_layout(rows, cols, in_smem).bytes;
  cudaError_t err = cudaFuncSetAttribute(bpwr_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = std::min(kBlockThreads, (rows + 31) / 32 * 32);
  bpwr_block_kernel<<<static_cast<unsigned>(t.pairs), threads, smem, s>>>(t, in_smem ? 1 : 0);
  return cudaGetLastError();
}

// the route for a tile of rows (the smaller side) x cols: the block route
// holds the tile in shared memory where it fits the opt-in limit
Route pick_route(int rows, int cols) {
  if (rows <= kSortedSide && cols <= kSortedSide) return kSorted;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t fits = block_layout(rows, cols, true).bytes + kBlockStaticBytes;
  return fits <= static_cast<size_t>(optin) ? kBlockShared : kBlockDevice;
}

}  // namespace

// d: f32 (Q, B, s1, s2) read through the element strides sq, sb, si, sj;
// qvalid (Q, s1) and cvalid (B, s2): contiguous bytes, nonzero = valid chunk;
// out: contiguous f32 (Q, B). n_rounds = max(1, min(n, min(s1, s2))).
// Any s1, s2 >= 1: the route is chosen by the tile's shape.
WEALY_API int wealy_bpwr_redux(const void* d, const void* qvalid, const void* cvalid, void* out,
                               int Q, int B, int s1, int s2, long long sq, long long sb,
                               long long si, long long sj, int n_rounds, float eps, float inf,
                               void* stream) {
  if (Q <= 0 || B <= 0 || s1 <= 0 || s2 <= 0 || n_rounds <= 0) return cudaErrorInvalidValue;
  const int rows = s1 < s2 ? s1 : s2;
  const int cols = s1 < s2 ? s2 : s1;
  const Tile t{static_cast<const float*>(d), static_cast<const uint8_t*>(qvalid),
               static_cast<const uint8_t*>(cvalid), static_cast<float*>(out),
               static_cast<long long>(Q) * B, B, s1, s2, sq, sb, si, sj, n_rounds, eps, inf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pick_route(rows, cols)) {
    case kSorted:
      // two pairs a warp where the rows fit 16 lanes; C up to 20 or 32
      if (rows <= 16) {
        return cols <= 20 ? launch_sorted<16, 20>(t, s) : launch_sorted<16, 32>(t, s);
      }
      return cols <= 20 ? launch_sorted<32, 20>(t, s) : launch_sorted<32, 32>(t, s);
    case kBlockShared:
      return launch_block(t, rows, cols, true, s);
    default:
      return launch_block(t, rows, cols, false, s);
  }
}

// The route wealy_bpwr_redux takes for an s1 x s2 tile on the current
// device (pick_route): 0 sorted, 1 block with the tile in shared memory,
// 2 block reading the tile from device memory each round.
WEALY_API int wealy_bpwr_route(int s1, int s2) {
  return pick_route(s1 < s2 ? s1 : s2, s1 < s2 ? s2 : s1);
}
