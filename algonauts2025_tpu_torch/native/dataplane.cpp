// Native host data-plane kernels for the audio/feature input pipeline.
//
// The reference leaned on libsndfile/julius (C/C++ inside third-party deps)
// for its wav decode path; this library owns those hot host loops directly:
// PCM decode (16/24/32-bit), channel-mean downmix and z-scoring run fused
// in one pass over the buffer instead of three NumPy temporaries, and an
// overlap-add accumulator serves the TimedArray pooling hot path of the
// training dataloader.
//
// Exposed via a C ABI consumed through ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Decode interleaved PCM16 -> mono float32 (mean over channels), returning
// sum and sum-of-squares for a follow-up z-score without a second pass.
void pcm16_to_mono_f32(const int16_t* in, int64_t frames, int channels,
                       float* out, double* sum, double* sumsq) {
  const float scale = 1.0f / 32768.0f;
  double s = 0.0, s2 = 0.0;
  if (channels == 1) {
    for (int64_t i = 0; i < frames; ++i) {
      float v = in[i] * scale;
      out[i] = v;
      s += v;
      s2 += (double)v * v;
    }
  } else {
    const float inv_ch = 1.0f / channels;
    for (int64_t i = 0; i < frames; ++i) {
      int32_t acc = 0;
      const int16_t* row = in + i * channels;
      for (int c = 0; c < channels; ++c) acc += row[c];
      float v = acc * scale * inv_ch;
      out[i] = v;
      s += v;
      s2 += (double)v * v;
    }
  }
  *sum = s;
  *sumsq = s2;
}

// Decode interleaved PCM24 (3 bytes LE) -> mono float32 with moments.
void pcm24_to_mono_f32(const uint8_t* in, int64_t frames, int channels,
                       float* out, double* sum, double* sumsq) {
  const float scale = 1.0f / 8388608.0f;
  const float inv_ch = 1.0f / channels;
  double s = 0.0, s2 = 0.0;
  for (int64_t i = 0; i < frames; ++i) {
    int64_t acc = 0;
    const uint8_t* row = in + (int64_t)3 * i * channels;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* b = row + 3 * c;
      int32_t val = (int32_t)b[0] | ((int32_t)b[1] << 8) | ((int32_t)b[2] << 16);
      if (val >= (1 << 23)) val -= (1 << 24);
      acc += val;
    }
    float v = acc * scale * inv_ch;
    out[i] = v;
    s += v;
    s2 += (double)v * v;
  }
  *sum = s;
  *sumsq = s2;
}

// In-place z-score given precomputed moments (matches the reference's
// (wav - mean) / (1e-8 + std), audio.py:123-127).
void zscore_inplace(float* data, int64_t n, double sum, double sumsq) {
  if (n <= 0) return;
  double mean = sum / n;
  double var = sumsq / n - mean * mean;
  if (var < 0) var = 0;
  float inv = (float)(1.0 / (1e-8 + std::sqrt(var)));
  float m = (float)mean;
  for (int64_t i = 0; i < n; ++i) data[i] = (data[i] - m) * inv;
}

// Overlap-add accumulate: out[:, dst:dst+n] += src[:, src_off:src_off+n]
// for a (rows, out_cols) destination and (rows, src_cols) source.
// The inner loop of TimedArray.__iadd__ (base time core) for 2D payloads.
void overlap_add_f32(float* out, int64_t out_cols, const float* src,
                     int64_t src_cols, int64_t rows, int64_t dst_off,
                     int64_t src_off, int64_t n) {
  for (int64_t r = 0; r < rows; ++r) {
    float* o = out + r * out_cols + dst_off;
    const float* s = src + r * src_cols + src_off;
    for (int64_t i = 0; i < n; ++i) o[i] += s[i];
  }
}

}  // extern "C"
