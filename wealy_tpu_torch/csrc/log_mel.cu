// K1: fused Whisper log-mel (framing + windowed DFT + power + mel + log10).
//
// Replaces the TPU kernel wealy_tpu/audio/pallas_mel.py::_mel_kernel
// (launched by _log_mel_pallas_jit). Output is log10(max(mel, 1e-10)) in
// the (B, n_mels, n_frames) layout; the per-clip max-8 clamp and (x+4)/4
// stay outside the kernel, as they do in JAX.
//
// What bounds it on an H100: arithmetic. Each 400-sample frame costs
// 2 x 400 x 201 FMAs for the DFT and 201 x n_mels for the mel projection,
// about 0.5 GFMA per 30 s clip, all in f32 (the golden tolerance rtol 1e-4 /
// atol 1e-5 rules out TF32 tensor cores). The waveform is read once (1.9 MB
// per clip) and the output written once. The function itself needs far
// less: on an FFT route with the filterbank's nonzeros only, about 10k
// flops a frame, so its floor is the bytes (about 7 us at B=8, 80 mels:
// chip_smoke.py's log_mel_bound). The dense DFT is this design's cost.
//
// Design: the TPU kernel keeps the cos/sin bases (2 x 400 x 201 f32 =
// 643 KB) resident in VMEM; they do not fit in the 227 KB of shared memory,
// so here they stream through L2 (they are shared by every block and stay
// hot there). A block owns FT consecutive frames of one clip: it assembles
// them straight from the waveform (reflect pad at both ends) into shared
// memory (FT x 400 f32 = 51 KB), thread k accumulates bin k's real and
// imaginary parts for all FT frames in registers (each basis value read
// from L2 feeds 2 x FT FMAs), the (FT, 201) power tile overwrites the
// frames in shared memory, and thread m projects it onto mel band m.
#include "common.cuh"

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_FREQS = N_FFT / 2 + 1;  // 201
constexpr int FT = 32;                  // frames per block
constexpr int THREADS = 224;            // 7 warps; threads 0..200 own one DFT bin each
constexpr int SMEM_BYTES = FT * N_FFT * sizeof(float);  // 51,200

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ audio, const float* __restrict__ wcos,
               const float* __restrict__ wsin, const float* __restrict__ melw,
               float* __restrict__ out, int n_samples, int n_frames, int n_mels) {
  extern __shared__ float smem[];  // frames (FT, N_FFT), later power (FT, N_FREQS)
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const float* x = audio + static_cast<size_t>(b) * n_samples;

  // 1. centred frames: sample t of frame f is x[f*HOP + t - N_FFT/2],
  //    reflect-padded (no edge repeat) at both ends
  for (int idx = threadIdx.x; idx < FT * N_FFT; idx += THREADS) {
    const int f = idx / N_FFT;
    const int t = idx - f * N_FFT;
    float v = 0.f;
    if (f0 + f < n_frames) {
      int i = (f0 + f) * HOP + t - N_FFT / 2;
      if (i < 0) i = -i;
      if (i >= n_samples) i = 2 * (n_samples - 1) - i;
      v = x[i];
    }
    smem[idx] = v;
  }
  __syncthreads();

  // 2. windowed real DFT: thread k owns bin k for all FT frames
  const int k = threadIdx.x;
  float re[FT], im[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.f;
  if (k < N_FREQS) {
    for (int t = 0; t < N_FFT; ++t) {
      const float c = __ldg(wcos + t * N_FREQS + k);
      const float s = __ldg(wsin + t * N_FREQS + k);
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const float v = smem[f * N_FFT + t];
        re[f] = fmaf(v, c, re[f]);
        im[f] = fmaf(v, s, im[f]);
      }
    }
  }
  __syncthreads();  // every thread is done reading frames before they are overwritten
  if (k < N_FREQS) {
#pragma unroll
    for (int f = 0; f < FT; ++f) smem[f * N_FREQS + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  // 3. mel projection and log10: thread m owns mel band m
  for (int m = threadIdx.x; m < n_mels; m += THREADS) {
    float acc[FT];
#pragma unroll
    for (int f = 0; f < FT; ++f) acc[f] = 0.f;
    for (int q = 0; q < N_FREQS; ++q) {
      const float w = __ldg(melw + q * n_mels + m);
#pragma unroll
      for (int f = 0; f < FT; ++f) acc[f] = fmaf(smem[f * N_FREQS + q], w, acc[f]);
    }
    float* o = out + (static_cast<size_t>(b) * n_mels + m) * n_frames + f0;
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      if (f0 + f < n_frames) o[f] = log10f(fmaxf(acc[f], 1e-10f));
    }
  }
}

}  // namespace

// audio (batch, n_samples) f32; wcos/wsin (N_FFT, N_FREQS) f32 with the Hann
// window folded in; melw (N_FREQS, n_mels) f32; out (batch, n_mels, n_frames) f32.
WEALY_API int wealy_log_mel(const void* audio, const void* wcos, const void* wsin,
                            const void* melw, void* out, int batch, int n_samples,
                            int n_frames, int n_mels, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((n_frames + FT - 1) / FT, batch);
  log_mel_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(wcos),
      static_cast<const float*>(wsin), static_cast<const float*>(melw),
      static_cast<float*>(out), n_samples, n_frames, n_mels);
  return cudaGetLastError();
}
