// Native host data plane of the PyTorch port: WAV + MP3 decode, polyphase
// resampling, 30 s chunk packing. A copy of the JAX package's
// wealy_tpu/native/wealy_host.cpp (the same code, so both packages decode and
// resample bit-identically); the port keeps its own copy because it imports
// nothing of the JAX package.
//
// This is host code: it feeds the extraction batches that the card consumes.
// Exposed as a plain C ABI for ctypes (no pybind11, no PyTorch headers).
//
// MP3 decode wraps the system libmpg123 through dlopen (every dataset's
// filename convention is .mp3 and the reference decodes through ffmpeg);
// dlopen keeps the build free of mpg123 headers and link dependencies, and
// mp3_available() reports 0 where the library is absent.
//
// Build (wealy_tpu_torch/native/__init__.py does this on first use):
//   g++ -O3 -march=native -shared -fPIC -std=c++17 wealy_host.cpp -o libwealy_host.so

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <algorithm>
#include <dlfcn.h>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------
// Parses a RIFF/WAVE buffer: PCM 8/16/24/32-bit int and 32/64-bit IEEE float,
// any channel count (downmixed to mono by averaging).
//
// Returns 0 on success. Caller provides the output buffer via wav_info first:
//   wav_info(data, len, &n_samples_mono, &sample_rate) -> 0/err
//   wav_decode(data, len, out /* n_samples_mono floats */) -> 0/err
//
// Error codes: 1=bad header, 2=missing fmt, 3=missing data, 4=unsupported fmt.

static int parse_wav(const uint8_t* data, uint64_t len, uint16_t* format,
                     uint16_t* channels, uint32_t* rate, uint16_t* bits,
                     const uint8_t** payload, uint64_t* payload_len) {
  if (len < 12 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
    return 1;
  uint64_t pos = 12;
  bool have_fmt = false, have_data = false;
  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_len;
    memcpy(&chunk_len, hdr + 4, 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > len) chunk_len = (uint32_t)(len - pos - 8);
    if (memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      memcpy(format, body + 0, 2);
      memcpy(channels, body + 2, 2);
      memcpy(rate, body + 4, 4);
      memcpy(bits, body + 14, 2);
      if (*format == 0xFFFE && chunk_len >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: real format in the GUID's first 2 bytes
        memcpy(format, body + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(hdr, "data", 4) == 0) {
      *payload = body;
      *payload_len = chunk_len;
      have_data = true;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are 2-byte aligned
    if (have_fmt && have_data) break;
  }
  if (!have_fmt) return 2;
  if (!have_data) return 3;
  return 0;
}

int wav_info(const uint8_t* data, uint64_t len, uint64_t* n_samples_mono,
             uint32_t* sample_rate) {
  uint16_t format, channels, bits;
  uint32_t rate;
  const uint8_t* payload;
  uint64_t payload_len;
  int rc = parse_wav(data, len, &format, &channels, &rate, &bits, &payload, &payload_len);
  if (rc) return rc;
  if (channels == 0 || bits == 0) return 4;
  uint64_t bytes_per_frame = (uint64_t)channels * (bits / 8);
  if (bytes_per_frame == 0) return 4;
  *n_samples_mono = payload_len / bytes_per_frame;
  *sample_rate = rate;
  return 0;
}

int wav_decode(const uint8_t* data, uint64_t len, float* out) {
  uint16_t format, channels, bits;
  uint32_t rate;
  const uint8_t* payload;
  uint64_t payload_len;
  int rc = parse_wav(data, len, &format, &channels, &rate, &bits, &payload, &payload_len);
  if (rc) return rc;
  uint64_t bytes_per_sample = bits / 8;
  uint64_t bytes_per_frame = (uint64_t)channels * bytes_per_sample;
  if (bytes_per_frame == 0) return 4;
  uint64_t frames = payload_len / bytes_per_frame;
  const float inv_ch = 1.0f / (float)channels;

  for (uint64_t i = 0; i < frames; ++i) {
    float acc = 0.0f;
    const uint8_t* f = payload + i * bytes_per_frame;
    for (uint16_t c = 0; c < channels; ++c) {
      const uint8_t* s = f + c * bytes_per_sample;
      float v = 0.0f;
      if (format == 1) {  // integer PCM
        switch (bits) {
          case 8: v = ((float)(*s) - 128.0f) / 128.0f; break;
          case 16: { int16_t x; memcpy(&x, s, 2); v = (float)x / 32768.0f; } break;
          case 24: {
            int32_t x = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                  ((uint32_t)s[2] << 16));
            if (x & 0x800000) x |= (int32_t)0xFF000000;
            v = (float)x / 8388608.0f;
          } break;
          case 32: { int32_t x; memcpy(&x, s, 4); v = (float)x / 2147483648.0f; } break;
          default: return 4;
        }
      } else if (format == 3) {  // IEEE float
        if (bits == 32) { float x; memcpy(&x, s, 4); v = x; }
        else if (bits == 64) { double x; memcpy(&x, s, 8); v = (float)x; }
        else return 4;
      } else {
        return 4;
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// MP3 decode (libmpg123 via dlopen)
// ---------------------------------------------------------------------------
// Feed-API decode of a whole in-memory MP3 to mono float32. The library is
// loaded lazily; if it is unavailable, mp3_available() returns 0 and callers
// fall back (the Python side raises a clear error / tries ffmpeg).

namespace {

typedef struct mpg123_handle_struct mpg123_handle;

// minimal public-ABI surface (values from the stable mpg123 API)
constexpr int kMpgOK = 0;
constexpr int kMpgNeedMore = -10;
constexpr int kMpgNewFormat = -11;
constexpr int kMpgDone = -12;
constexpr int kEncFloat32 = 0x200;     // MPG123_ENC_FLOAT_32
constexpr int kMonoOrStereo = 0x3;     // MPG123_MONO | MPG123_STEREO

struct Mpg123Api {
  int (*init)(void);
  mpg123_handle* (*make)(const char*, int*);
  void (*destroy)(mpg123_handle*);
  int (*open_feed)(mpg123_handle*);
  int (*feed)(mpg123_handle*, const unsigned char*, size_t);
  int (*decode_frame)(mpg123_handle*, int64_t*, unsigned char**, size_t*);
  int (*getformat)(mpg123_handle*, long*, int*, int*);
  int (*format_none)(mpg123_handle*);
  int (*format)(mpg123_handle*, long, int, int);
  bool ok = false;
};

const Mpg123Api& mpg123_api() {
  static Mpg123Api api = [] {
    Mpg123Api a{};
    void* so = dlopen("libmpg123.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!so) so = dlopen("libmpg123.so", RTLD_NOW | RTLD_LOCAL);
    if (!so) return a;
    a.init = (int (*)(void))dlsym(so, "mpg123_init");
    a.make = (mpg123_handle * (*)(const char*, int*)) dlsym(so, "mpg123_new");
    a.destroy = (void (*)(mpg123_handle*))dlsym(so, "mpg123_delete");
    a.open_feed = (int (*)(mpg123_handle*))dlsym(so, "mpg123_open_feed");
    a.feed = (int (*)(mpg123_handle*, const unsigned char*, size_t))dlsym(so, "mpg123_feed");
    // _64 variant pins the frame-offset out-param to int64 regardless of the
    // library's off_t build configuration
    a.decode_frame = (int (*)(mpg123_handle*, int64_t*, unsigned char**, size_t*))
        dlsym(so, "mpg123_decode_frame_64");
    if (!a.decode_frame)
      a.decode_frame = (int (*)(mpg123_handle*, int64_t*, unsigned char**, size_t*))
          dlsym(so, "mpg123_decode_frame");
    a.getformat = (int (*)(mpg123_handle*, long*, int*, int*))dlsym(so, "mpg123_getformat");
    a.format_none = (int (*)(mpg123_handle*))dlsym(so, "mpg123_format_none");
    a.format = (int (*)(mpg123_handle*, long, int, int))dlsym(so, "mpg123_format");
    a.ok = a.init && a.make && a.destroy && a.open_feed && a.feed &&
           a.decode_frame && a.getformat && a.format_none && a.format;
    if (a.ok && a.init() != kMpgOK) a.ok = false;
    return a;
  }();
  return api;
}

}  // namespace

int mp3_available() { return mpg123_api().ok ? 1 : 0; }

// Decode an MP3 buffer to mono float32. On success (*out, *n_samples,
// *sample_rate) are set; the buffer is malloc'd — release with wealy_free.
// Error codes: 1=mpg123 unavailable, 2=handle/feed error, 3=decode error,
// 4=no audio frames.
int mp3_decode_alloc(const uint8_t* data, uint64_t len, float** out,
                     uint64_t* n_samples, uint32_t* sample_rate) {
  const Mpg123Api& api = mpg123_api();
  if (!api.ok) return 1;
  int err = 0;
  mpg123_handle* h = api.make(nullptr, &err);
  if (!h) return 2;
  // accept float32 output at every MPEG rate, mono or stereo
  static const long kRates[] = {8000,  11025, 12000, 16000, 22050,
                                24000, 32000, 44100, 48000};
  api.format_none(h);
  for (long r : kRates) api.format(h, r, kMonoOrStereo, kEncFloat32);
  if (api.open_feed(h) != kMpgOK || api.feed(h, data, (size_t)len) != kMpgOK) {
    api.destroy(h);
    return 2;
  }

  uint64_t cap = 1 << 20, n = 0;
  float* buf = (float*)malloc(cap * sizeof(float));
  long rate = 0;
  int channels = 1, encoding = 0;

  // mpg123 can return the same recoverable error forever on garbage input
  // (e.g. a renamed non-MP3 file) without consuming data — bound the number
  // of consecutive no-progress error retries so decode never spins.
  int err_streak = 0;
  for (;;) {
    int64_t fnum = 0;
    unsigned char* audio = nullptr;
    size_t bytes = 0;
    int rc = api.decode_frame(h, &fnum, &audio, &bytes);
    if (rc == kMpgNewFormat) {
      api.getformat(h, &rate, &channels, &encoding);
      if (encoding != kEncFloat32 || channels < 1 || channels > 2) {
        free(buf);
        api.destroy(h);
        return 3;
      }
      err_streak = 0;
      continue;
    }
    if (rc == kMpgNeedMore || rc == kMpgDone) break;  // whole file was fed
    if (rc != kMpgOK) {
      // tolerate recoverable frame errors (resync) only before any audio,
      // and only a bounded number of times
      if (n == 0 && bytes == 0 && ++err_streak < 4096) continue;
      free(buf);
      api.destroy(h);
      return 3;
    }
    err_streak = 0;
    if (!audio || bytes == 0) continue;
    const float* pcm = (const float*)audio;
    uint64_t frames = bytes / (sizeof(float) * (uint64_t)channels);
    if (n + frames > cap) {
      while (n + frames > cap) cap *= 2;
      buf = (float*)realloc(buf, cap * sizeof(float));
    }
    if (channels == 1) {
      memcpy(buf + n, pcm, frames * sizeof(float));
    } else {
      for (uint64_t i = 0; i < frames; ++i)
        buf[n + i] = 0.5f * (pcm[2 * i] + pcm[2 * i + 1]);
    }
    n += frames;
  }
  api.destroy(h);
  if (n == 0 || rate == 0) {
    free(buf);
    return 4;
  }
  *out = buf;
  *n_samples = n;
  *sample_rate = (uint32_t)rate;
  return 0;
}

void wealy_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Polyphase resampling
// ---------------------------------------------------------------------------
// y[j] = sum_k taps[k] * x[(j*M + k - half) / L]  where (j*M + k - half) % L == 0
// (cross-correlation with an L-dilated input, the same sum as the port's
// torch resampler in wealy_tpu_torch/audio/resample.py, with the same taps;
// the two agree within 2e-4).

#if defined(__AVX2__) && defined(__FMA__)
#include <immintrin.h>
static inline float dot_f32(const float* a, const float* b, int64_t n) {
  __m256 acc0 = _mm256_setzero_ps(), acc1 = _mm256_setzero_ps();
  int64_t i = 0;
  for (; i + 16 <= n; i += 16) {
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), acc0);
    acc1 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i + 8), _mm256_loadu_ps(b + i + 8), acc1);
  }
  for (; i + 8 <= n; i += 8)
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), acc0);
  acc0 = _mm256_add_ps(acc0, acc1);
  float tmp[8];
  _mm256_storeu_ps(tmp, acc0);
  float s = tmp[0] + tmp[1] + tmp[2] + tmp[3] + tmp[4] + tmp[5] + tmp[6] + tmp[7];
  for (; i < n; ++i) s += a[i] * b[i];
  return s;
}
#else
static inline float dot_f32(const float* a, const float* b, int64_t n) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 += a[i] * b[i];
    s1 += a[i + 1] * b[i + 1];
    s2 += a[i + 2] * b[i + 2];
    s3 += a[i + 3] * b[i + 3];
  }
  float s = (s0 + s1) + (s2 + s3);
  for (; i < n; ++i) s += a[i] * b[i];
  return s;
}
#endif

int resample_poly(const float* x, uint64_t n, int L, int M, const float* taps,
                  int ktaps, float* out, uint64_t out_len) {
  if (L <= 0 || M <= 0 || ktaps <= 0) return 1;
  const int64_t half = (ktaps - 1) / 2;
  // Polyphase restructure: for output j the contributing taps are
  // taps[k0 + m*L] against CONTIGUOUS input x[xi0 + m] (k0 = phase offset,
  // xi0 = (t0 + k0) / L). Regrouping the L-strided tap walk into per-phase
  // contiguous rows turns each output sample into one dense dot product
  // (AVX2 FMA above) — 14x over the strided scalar loop at 44.1k->16k
  // (L=160, M=441, ~133 taps/phase).
  const int64_t tpp = (ktaps + L - 1) / L;  // taps per phase, zero-padded
  float* ph = (float*)calloc((size_t)L * tpp, sizeof(float));
  if (!ph) return 2;
  for (int64_t k = 0; k < ktaps; ++k) ph[(k % L) * tpp + (k / L)] = taps[k];
  for (uint64_t j = 0; j < out_len; ++j) {
    const int64_t t0 = (int64_t)j * M - half;  // upsampled-grid index of tap 0
    int64_t rem = ((t0 % L) + L) % L;
    const int64_t k0 = (rem == 0) ? 0 : (L - rem);  // first valid tap; also
    const int64_t p = k0;  // the phase row: row p holds taps[p + m*L]
    const int64_t xi0 = (t0 + k0) / L;
    const int64_t m_hi0 = (ktaps - 1 - k0) / L + 1;  // #taps in this phase row
    // clip the dot to the valid input range [0, n)
    const int64_t m_lo = xi0 < 0 ? -xi0 : 0;
    int64_t m_hi = m_hi0;
    if (xi0 + m_hi > (int64_t)n) m_hi = (int64_t)n - xi0;
    out[j] = (m_hi > m_lo)
                 ? dot_f32(x + xi0 + m_lo, ph + p * tpp + m_lo, m_hi - m_lo)
                 : 0.0f;
  }
  free(ph);
  return 0;
}

// Zero-padded 30 s chunk packing: audio (n,) -> out (n_chunks, chunk) floats.
int pack_chunks(const float* x, uint64_t n, uint64_t chunk, float* out,
                uint64_t n_chunks) {
  for (uint64_t c = 0; c < n_chunks; ++c) {
    const uint64_t start = c * chunk;
    const uint64_t take = start < n ? std::min(chunk, n - start) : 0;
    if (take) memcpy(out + c * chunk, x + start, take * sizeof(float));
    if (take < chunk) memset(out + c * chunk + take, 0, (chunk - take) * sizeof(float));
  }
  return 0;
}

}  // extern "C"
