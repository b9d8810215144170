// K1: fused Whisper log-mel (framing + windowed real FFT + power + mel +
// log10).
//
// Replaces the TPU kernel wealy_tpu/audio/pallas_mel.py::_mel_kernel
// (launched by _log_mel_pallas_jit). Output is log10(max(mel, 1e-10)) in
// the (B, n_mels, n_frames) layout; the per-clip max-8 clamp and (x+4)/4
// stay outside the kernel, as they do in JAX. All of it is f32: the golden
// tolerance (rtol 1e-4 / atol 1e-5) rules out TF32.
//
// What bounds it on an H100: the bytes. The waveform is read once (1.92 MB
// per 30 s clip) and the log-mel written once (0.96 MB at 80 mels): 23.0 MB
// at B=8 with 80 mels, 6.9 us at 3.35 TB/s. The TPU kernel multiplies each
// frame by a dense 400 x 201 cos/sin basis on the MXU (160,800 MACs a
// frame); on this card that basis (643 KB) does not fit in shared memory and
// the f32 FMA rate makes the dense product about 17x the byte time. The
// function needs about 10k flops a frame on an FFT route, so that is what
// this kernel computes:
//
// - A block owns FT consecutive frames of one clip. It reads the waveform
//   span those frames cover once into shared memory, with the reflect pad at
//   both ends (frames overlap by 240 of 400 samples, so each sample is read
//   about once), and applies the periodic Hann window as it loads a frame.
// - Each frame's 400-point real DFT is a 200-point complex FFT of the
//   even/odd-packed samples z[n] = x[2n] + i x[2n+1], then the real split
//   step X[k] = A[k] + W400^k B[k], X[200-k] = conj(A[k] - W400^k B[k]),
//   with A and B the spectra of the even and odd samples taken apart from
//   Z[k] and Z[200-k]. The 200 points are 8 x 25 (Cooley-Tukey, n = 25 n1 +
//   n2, k = k1 + 8 k2): a radix-8 stage (one thread per (frame, n2): an
//   8-point DFT of radix-2 butterflies, times W200^(n2 k1)), then a 25-point
//   DFT per (frame, k1) in one thread's registers as 5 x 5 (5-point DFTs,
//   times W25^(b c), 5-point DFTs). Stages exchange through shared memory.
// - The twiddles (W200, W25, W400) and the window are built on the host in
//   float64 and rounded to f32 (audio/fused_mel.py::fft_plan), so the CPU
//   tests run the same plan in torch; each block copies them (4.2 KB) into
//   shared memory with its waveform span, every load issued before the
//   first store.
// - The power |X|^2 of the 201 bins goes to shared memory, and the mel
//   product runs over each slaney band's nonzeros only: a band is one
//   contiguous bin range (first bin, count, weights; at most 14 bins at 80
//   mels). One thread per (band, frame), frames fastest, so the log-mel is
//   written coalesced along frames.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int NH = N_FFT / 2;           // 200 complex points
constexpr int N_FREQS = N_FFT / 2 + 1;  // 201
constexpr int FT = 16;                  // frames per block
constexpr int THREADS = 256;
constexpr int SPAN = (FT - 1) * HOP + N_FFT;  // waveform samples of a block's frames
constexpr int WAVE = SPAN > FT * N_FREQS ? SPAN : FT * N_FREQS;  // the span, later the power
// the plan (f32, fft_plan): window, W200^(n2 k1) [n2][k1], W25^(b c) [b][c], W400^k (k <= 100)
constexpr int PLAN_WIN = 0;
constexpr int PLAN_TW200 = PLAN_WIN + N_FFT;
constexpr int PLAN_TW25 = PLAN_TW200 + 2 * 25 * 8;
constexpr int PLAN_SPLIT = PLAN_TW25 + 2 * 25;
constexpr int PLAN_SIZE = PLAN_SPLIT + 2 * (NH / 2 + 1);

constexpr int BAND_W = 16;  // bins per band in the mel table (mel_bands' BAND_WIDTH)

struct Smem {
  float plan[PLAN_SIZE + 4];  // (padded to keep z 8-byte aligned)
  float wave[WAVE];           // the frames' waveform span, then the power (FT, N_FREQS)
  float2 z[FT][NH];           // the complex FFT's data between stages
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// forward 5-point DFT of x[0], x[s], ..., x[4s] in place
template <int S>
__device__ __forceinline__ void dft5(float2* x) {
  constexpr float C1 = 0.30901699437494745f;   // cos(2 pi / 5)
  constexpr float C2 = -0.8090169943749473f;   // cos(4 pi / 5)
  constexpr float S1 = 0.9510565162951535f;    // sin(2 pi / 5)
  constexpr float S2 = 0.5877852522924732f;    // sin(4 pi / 5)
  const float2 x0 = x[0];
  const float2 s1 = cadd(x[S], x[4 * S]), d1 = csub(x[S], x[4 * S]);
  const float2 s2 = cadd(x[2 * S], x[3 * S]), d2 = csub(x[2 * S], x[3 * S]);
  const float2 t1 = make_float2(x0.x + C1 * s1.x + C2 * s2.x, x0.y + C1 * s1.y + C2 * s2.y);
  const float2 t2 = make_float2(x0.x + C2 * s1.x + C1 * s2.x, x0.y + C2 * s1.y + C1 * s2.y);
  const float2 u1 = mul_neg_i(make_float2(S1 * d1.x + S2 * d2.x, S1 * d1.y + S2 * d2.y));
  const float2 u2 = mul_neg_i(make_float2(S2 * d1.x - S1 * d2.x, S2 * d1.y - S1 * d2.y));
  x[0] = cadd(x0, cadd(s1, s2));
  x[S] = cadd(t1, u1);
  x[4 * S] = csub(t1, u1);
  x[2 * S] = cadd(t2, u2);
  x[3 * S] = csub(t2, u2);
}

// forward 8-point DFT in place (radix-2 butterflies)
__device__ __forceinline__ void dft8(float2 (&x)[8]) {
  constexpr float R = 0.7071067811865476f;  // 1 / sqrt(2)
  const float2 a0 = cadd(x[0], x[4]), a1 = csub(x[0], x[4]);
  const float2 a2 = cadd(x[2], x[6]), a3 = mul_neg_i(csub(x[2], x[6]));
  const float2 a4 = cadd(x[1], x[5]), a5 = csub(x[1], x[5]);
  const float2 a6 = cadd(x[3], x[7]), a7 = mul_neg_i(csub(x[3], x[7]));
  const float2 e[4] = {cadd(a0, a2), cadd(a1, a3), csub(a0, a2), csub(a1, a3)};  // evens' DFT
  float2 o[4] = {cadd(a4, a6), cadd(a5, a7), csub(a4, a6), csub(a5, a7)};        // odds' DFT
  o[1] = make_float2(R * (o[1].x + o[1].y), R * (o[1].y - o[1].x));    // W8^1 = (1 - i) / sqrt 2
  o[2] = mul_neg_i(o[2]);                                              // W8^2 = -i
  o[3] = make_float2(R * (o[3].y - o[3].x), -R * (o[3].x + o[3].y));   // W8^3 = -(1 + i) / sqrt 2
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = cadd(e[k], o[k]);
    x[k + 4] = csub(e[k], o[k]);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) { return make_float2(p[0], p[1]); }

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ plan_g,
               const int* __restrict__ band, const float* __restrict__ band_w,
               float* __restrict__ out, int n_samples, int n_frames, int n_mels) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* x = audio + static_cast<size_t>(b) * n_samples;

  // 1. the waveform span of frames f0 .. f0 + FT - 1: sample t of frame f is
  //    x[f * HOP + t - N_FFT / 2], reflect-padded (no edge repeat) at both
  //    ends; samples of frames past n_frames read as zeros. Every load is
  //    issued before the first store, and the plan comes along.
  constexpr int LOADS = (SPAN + THREADS - 1) / THREADS;
  constexpr int PLAN_LOADS = (PLAN_SIZE + THREADS - 1) / THREADS;
  float v[LOADS], pv[PLAN_LOADS];
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    int i = f0 * HOP - N_FFT / 2 + tid + THREADS * it;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    v[it] = tid + THREADS * it < SPAN && i >= 0 && i < n_samples ? __ldg(x + i) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < PLAN_LOADS; ++it) {
    pv[it] = tid + THREADS * it < PLAN_SIZE ? __ldg(plan_g + tid + THREADS * it) : 0.f;
  }
#pragma unroll
  for (int it = 0; it < LOADS; ++it) {
    if (tid + THREADS * it < SPAN) sm.wave[tid + THREADS * it] = v[it];
  }
#pragma unroll
  for (int it = 0; it < PLAN_LOADS; ++it) {
    if (tid + THREADS * it < PLAN_SIZE) sm.plan[tid + THREADS * it] = pv[it];
  }
  __syncthreads();
  const float* plan = sm.plan;

  // 2. radix-8 stage: thread (f, n2) takes z[25 n1 + n2] = w x[2n] + i w x[2n+1],
  //    n1 = 0..7, and writes Y[k1] W200^(n2 k1) to z[f][25 k1 + n2]
  for (int task = tid; task < FT * 25; task += THREADS) {
    const int f = task / 25;
    const int n2 = task % 25;
    float2 y[8];
#pragma unroll
    for (int n1 = 0; n1 < 8; ++n1) {
      const int t = 2 * (25 * n1 + n2);
      const float2 w = ld2(plan + PLAN_WIN + t);
      y[n1] = make_float2(sm.wave[f * HOP + t] * w.x, sm.wave[f * HOP + t + 1] * w.y);
    }
    dft8(y);
    sm.z[f][n2] = y[0];
#pragma unroll
    for (int k1 = 1; k1 < 8; ++k1) {
      sm.z[f][25 * k1 + n2] = cmul(y[k1], ld2(plan + PLAN_TW200 + 2 * (8 * n2 + k1)));
    }
  }
  __syncthreads();

  // 3. the 25-point DFTs: thread (f, k1) reads z[f][25 k1 + n2], n2 = 5a + b,
  //    and writes Z[k1 + 8 (c + 5 d)] in place (after every thread has read)
  const bool has25 = tid < FT * 8;
  const int f25 = tid / 8, k1 = tid % 8;
  float2 y[25];
  if (has25) {
#pragma unroll
    for (int n = 0; n < 25; ++n) y[n] = sm.z[f25][25 * k1 + n];
  }
  __syncthreads();
  if (has25) {
#pragma unroll
    for (int bb = 0; bb < 5; ++bb) {  // over a: y[5a + bb] becomes U[bb][c] in y[5c + bb]
      dft5<5>(y + bb);
#pragma unroll
      for (int c = 1; c < 5; ++c) {
        if (bb > 0) y[5 * c + bb] = cmul(y[5 * c + bb], ld2(plan + PLAN_TW25 + 2 * (5 * bb + c)));
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {  // over b: U[.][c] becomes Z[k1 + 8 (c + 5 d)]
      dft5<1>(y + 5 * c);
#pragma unroll
      for (int d = 0; d < 5; ++d) sm.z[f25][k1 + 8 * (c + 5 * d)] = y[5 * c + d];
    }
  }
  __syncthreads();

  // 4. the real split and the power of bins k and 200 - k, into sm.wave
  float* power = sm.wave;
  for (int task = tid; task < FT * (NH / 2 + 1); task += THREADS) {
    const int f = task / (NH / 2 + 1);
    const int k = task % (NH / 2 + 1);
    const float2 zk = sm.z[f][k];
    const float2 zc = sm.z[f][(NH - k) % NH];
    const float2 a = make_float2(0.5f * (zk.x + zc.x), 0.5f * (zk.y - zc.y));  // (Z[k] + conj Z[-k]) / 2
    const float2 bk = make_float2(0.5f * (zk.y + zc.y), 0.5f * (zc.x - zk.x));  // (Z[k] - conj Z[-k]) / 2i
    const float2 t = cmul(bk, ld2(plan + PLAN_SPLIT + 2 * k));
    const float2 lo = cadd(a, t), hi = csub(a, t);
    power[f * N_FREQS + k] = lo.x * lo.x + lo.y * lo.y;
    if (k != NH / 2) power[f * N_FREQS + NH - k] = hi.x * hi.x + hi.y * hi.y;
  }
  __syncthreads();

  // 5. the mel product over each band's nonzeros and log10; thread (m, f), frames fastest
  for (int task = tid; task < FT * n_mels; task += THREADS) {
    const int f = task % FT;
    const int m = task / FT;
    if (f0 + f >= n_frames) continue;
    const int first = __ldg(band + 2 * m), count = __ldg(band + 2 * m + 1);
    const float* w = band_w + m * BAND_W;
    const float* p = power + f * N_FREQS + first;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < BAND_W; ++j) {
      if (j < count) acc = fmaf(__ldg(w + j), p[j], acc);
    }
    out[(static_cast<size_t>(b) * n_mels + m) * n_frames + f0 + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio (batch, n_samples) f32; plan (PLAN_SIZE,) f32 from fft_plan; band
// (n_mels, 2) int32 (first bin, count) and band_w (n_mels, band_width) f32
// from mel_bands, band_width 16; out (batch, n_mels, n_frames) f32.
// n_frames <= the centred frames of n_samples (the last STFT frame may be
// dropped).
WEALY_API int wealy_log_mel(const void* audio, const void* plan, const void* band,
                            const void* band_w, void* out, int batch, int n_samples, int n_frames,
                            int n_mels, int band_width, void* stream) {
  if (n_samples <= N_FFT / 2 || n_frames <= 0 || n_mels <= 0 || band_width != BAND_W) {
    return cudaErrorInvalidValue;
  }
  static_assert(PLAN_SIZE == 1052, "the plan's layout is audio/fused_mel.py::fft_plan's");
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err =
      cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_frames + FT - 1) / FT, batch);
  log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(plan),
      static_cast<const int*>(band), static_cast<const float*>(band_w), static_cast<float*>(out),
      n_samples, n_frames, n_mels);
  return cudaGetLastError();
}
