// Native audio preprocessing: WAV parse + mono mix, Kaiser-windowed sinc
// resampling, peak normalization.
//
// Host code for the port's audio input (llark_tpu_torch/audio/io.py loads
// it through ctypes): the WAV read and the resample set the pace of the
// CLAP and Jukebox extraction CLIs, so the hot loops live here. The same
// source as the JAX package's native library, built with the same flags.
//
// Build: llark_tpu_torch/native/build.py at first use
// (g++ -O3 -march=native -shared -fPIC), into llark_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta values we use
  double sum = 1.0, term = 1.0;
  const double y = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= y / (double)(k * k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Peak normalization (reference jukebox/main.py:40-44 semantics)
// ---------------------------------------------------------------------------
void ljt_peak_normalize(float* x, long n) {
  float peak = 0.f;
  for (long i = 0; i < n; ++i) {
    float a = std::fabs(x[i]);
    if (a > peak) peak = a;
  }
  if (peak > 0.f) {
    const float inv = 1.0f / peak;
    for (long i = 0; i < n; ++i) x[i] *= inv;
  }
}

// ---------------------------------------------------------------------------
// Kaiser-windowed sinc resampler (resampy-style table + phase interpolation)
// ---------------------------------------------------------------------------
long ljt_resample_len(long n_in, int sr_in, int sr_out) {
  return (long)std::ceil((double)n_in * sr_out / sr_in);
}

// num_zeros: sinc zero crossings per side (quality); precision: table
// samples per zero crossing. beta ~14.77 matches kaiser_best-like rolloff.
void ljt_resample(const float* in, long n_in, int sr_in, float* out,
                  long n_out, int sr_out, int num_zeros, int precision,
                  double beta) {
  if (sr_in == sr_out) {
    const long n = n_in < n_out ? n_in : n_out;
    std::memcpy(out, in, n * sizeof(float));
    for (long i = n; i < n_out; ++i) out[i] = 0.f;
    return;
  }
  const double ratio = (double)sr_out / sr_in;             // out/in
  const double cutoff = (ratio < 1.0 ? ratio : 1.0) * 0.9475; // anti-alias
  const long table_len = (long)num_zeros * precision + 1;
  std::vector<double> table(table_len);
  const double i0b = bessel_i0(beta);
  for (long i = 0; i < table_len; ++i) {
    // t is in ZERO-CROSSING units (u = tau * cutoff): the runtime lookup
    // below indexes by d = |t_in - i| * cutoff, so the sinc argument here
    // is pi * u — applying cutoff again would narrow the passband and
    // misscale the gain (h(tau) must be cutoff * sinc(pi * cutoff * tau)).
    const double t = (double)i / precision;
    const double x = t * M_PI;
    const double sinc = (i == 0) ? 1.0 : std::sin(x) / x;
    const double w = (double)i / (double)(table_len - 1);  // 0..1
    const double kais = bessel_i0(beta * std::sqrt(1.0 - w * w)) / i0b;
    table[i] = cutoff * sinc * kais;
  }
  const double scale = 1.0 / ratio;  // input samples per output sample
  const double half_width = (double)num_zeros / cutoff;
  for (long n = 0; n < n_out; ++n) {
    const double t_in = n * scale;
    const long i0 = (long)std::floor(t_in - half_width) + 1;
    const long i1 = (long)std::floor(t_in + half_width);
    double acc = 0.0;
    const long lo = i0 < 0 ? 0 : i0;
    const long hi = i1 >= n_in ? n_in - 1 : i1;
    for (long i = lo; i <= hi; ++i) {
      const double d = std::fabs(t_in - (double)i) * cutoff;  // zero-crossing units
      const double pos = d * precision;
      const long idx = (long)pos;
      if (idx + 1 >= table_len) continue;
      const double frac = pos - idx;
      const double coef = table[idx] * (1.0 - frac) + table[idx + 1] * frac;
      acc += coef * in[i];
    }
    out[n] = (float)acc;
  }
}

// ---------------------------------------------------------------------------
// WAV (RIFF) parsing: PCM 8/16/24/32 + IEEE float32/64, mono-mixed output.
// Two-phase: call with out==nullptr to query n_frames/channels/sr.
// Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------
int ljt_parse_wav(const uint8_t* data, long n_bytes, float* out,
                  long* n_frames, int* n_channels, int* sample_rate) {
  if (n_bytes < 44 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
    return -1;
  long pos = 12;
  int fmt = 0, channels = 0, sr = 0, bits = 0;
  long data_off = -1, data_len = 0;
  while (pos + 8 <= n_bytes) {
    const uint32_t chunk_len = *(const uint32_t*)(data + pos + 4);
    if (!std::memcmp(data + pos, "fmt ", 4)) {
      // bounds-check the fmt payload against BOTH the declared chunk
      // length and the actual buffer (truncated/hostile files)
      if (chunk_len < 16 || pos + 8 + 16 > n_bytes) return -1;
      const uint8_t* f = data + pos + 8;
      fmt = *(const uint16_t*)f;
      channels = *(const uint16_t*)(f + 2);
      sr = *(const int32_t*)(f + 4);
      bits = *(const uint16_t*)(f + 14);
      if (fmt == 0xFFFE && chunk_len >= 40 && pos + 8 + 26 <= n_bytes) {
        fmt = *(const uint16_t*)(f + 24);  // WAVE_FORMAT_EXTENSIBLE
      }
    } else if (!std::memcmp(data + pos, "data", 4)) {
      data_off = pos + 8;
      data_len = chunk_len;
      if (data_off + data_len > n_bytes) data_len = n_bytes - data_off;
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!channels || !sr || data_off < 0) return -2;
  const int bytes_per = bits / 8;
  if (bytes_per <= 0) return -3;  // bits < 8 would divide by zero (SIGFPE)
  const long frames = data_len / (bytes_per * channels);
  *n_frames = frames;
  *n_channels = channels;
  *sample_rate = sr;
  if (!out) return 0;

  const uint8_t* d = data + data_off;
  const double inv_ch = 1.0 / channels;
  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = d + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt == 1) {  // PCM
        switch (bits) {
          case 8:  v = ((int)*s - 128) / 128.0; break;
          case 16: v = *(const int16_t*)s / 32768.0; break;
          case 24: {
            int32_t x = (s[0] | (s[1] << 8) | (s[2] << 16));
            if (x & 0x800000) x |= ~0xFFFFFF;
            v = x / 8388608.0;
            break;
          }
          case 32: v = *(const int32_t*)s / 2147483648.0; break;
          default: return -3;
        }
      } else if (fmt == 3) {  // IEEE float
        if (bits == 32) v = *(const float*)s;
        else if (bits == 64) v = *(const double*)s;
        else return -3;
      } else {
        return -4;
      }
      acc += v;
    }
    out[i] = (float)(acc * inv_ch);
  }
  return 0;
}

}  // extern "C"
