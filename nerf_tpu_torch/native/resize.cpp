// Native area-downsample kernel for the LLFF loader's minify step.
//
// Replaces the reference's out-of-process ImageMagick `mogrify -resize`
// shell-out (load_llff.py:45-51) with an in-process block-mean reduction
// (exactly what OpenCV INTER_AREA computes for integer factors). Called from
// Python via ctypes (nerf_tpu_torch/native/resize.py); built on first use with g++.
//
// Layout: row-major interleaved channels (H, W, C). Output is the
// floor(H/f) x floor(W/f) block mean, one thread per output row stripe.

#include <cstdint>
#include <cstddef>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// uint8 input -> float output in [0, 255]
void area_downsample_u8(const uint8_t* in, int64_t H, int64_t W, int64_t C,
                        int64_t factor, float* out) {
  const int64_t H2 = H / factor, W2 = W / factor;
  const float inv = 1.0f / static_cast<float>(factor * factor);
  int64_t n_threads = std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()), H2);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int64_t r = t; r < H2; r += n_threads) {
        for (int64_t c = 0; c < W2; ++c) {
          for (int64_t ch = 0; ch < C; ++ch) {
            float acc = 0.0f;
            for (int64_t dr = 0; dr < factor; ++dr) {
              const uint8_t* row = in + ((r * factor + dr) * W + c * factor) * C + ch;
              for (int64_t dc = 0; dc < factor; ++dc) acc += row[dc * C];
            }
            out[(r * W2 + c) * C + ch] = acc * inv;
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

// float input -> float output (same scale as input)
void area_downsample_f32(const float* in, int64_t H, int64_t W, int64_t C,
                         int64_t factor, float* out) {
  const int64_t H2 = H / factor, W2 = W / factor;
  const float inv = 1.0f / static_cast<float>(factor * factor);
  int64_t n_threads = std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()), H2);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int64_t r = t; r < H2; r += n_threads) {
        for (int64_t c = 0; c < W2; ++c) {
          for (int64_t ch = 0; ch < C; ++ch) {
            float acc = 0.0f;
            for (int64_t dr = 0; dr < factor; ++dr) {
              const float* row = in + ((r * factor + dr) * W + c * factor) * C + ch;
              for (int64_t dc = 0; dc < factor; ++dc) acc += row[dc * C];
            }
            out[(r * W2 + c) * C + ch] = acc * inv;
          }
        }
      }
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"

// --- Lanczos-3 separable resampling ------------------------------------
//
// The reference's minify shells out to ImageMagick `mogrify -resize N%`
// (load_llff.py:45-51), whose default downscale filter is Lanczos (sinc
// windowed by sinc, support 3). This reproduces that filter in-process:
// output pixel centers map to (i + 0.5) / scale - 0.5 in input space, the
// kernel support widens by 1/scale when minifying, weights of in-range taps
// are renormalized at the borders — the same conventions ImageMagick and
// PIL's Image.LANCZOS use (tests/test_native.py pins us against PIL).

namespace {

inline double lanczos3(double x) {
  if (x < 0) x = -x;
  if (x >= 3.0) return 0.0;
  if (x < 1e-8) return 1.0;
  const double pix = 3.14159265358979323846 * x;
  return 3.0 * std::sin(pix) * std::sin(pix / 3.0) / (pix * pix);
}

// Precomputed taps for one output coordinate axis.
struct AxisTaps {
  std::vector<int32_t> first;    // [n_out] first input index
  std::vector<int32_t> count;    // [n_out] number of taps
  std::vector<float> weights;    // [n_out * max_count] normalized weights
  int32_t max_count = 0;
};

AxisTaps build_taps(int64_t n_in, int64_t n_out) {
  AxisTaps t;
  const double scale = static_cast<double>(n_out) / static_cast<double>(n_in);
  const double fscale = scale < 1.0 ? 1.0 / scale : 1.0;  // widen when minifying
  const double support = 3.0 * fscale;
  t.max_count = static_cast<int32_t>(std::ceil(2.0 * support)) + 2;
  t.first.resize(n_out);
  t.count.resize(n_out);
  t.weights.assign(static_cast<size_t>(n_out) * t.max_count, 0.0f);
  for (int64_t i = 0; i < n_out; ++i) {
    const double center = (i + 0.5) / scale - 0.5;
    int64_t lo = std::max<int64_t>(0, static_cast<int64_t>(std::floor(center - support)) + 1);
    int64_t hi = std::min<int64_t>(n_in - 1, static_cast<int64_t>(std::floor(center + support)));
    double sum = 0.0;
    std::vector<double> w(hi - lo + 1);
    for (int64_t k = lo; k <= hi; ++k) {
      w[k - lo] = lanczos3((k - center) / fscale);
      sum += w[k - lo];
    }
    t.first[i] = static_cast<int32_t>(lo);
    t.count[i] = static_cast<int32_t>(hi - lo + 1);
    for (int64_t k = 0; k <= hi - lo; ++k)
      t.weights[i * t.max_count + k] = static_cast<float>(w[k] / sum);
  }
  return t;
}

}  // namespace

extern "C" {

// float [H, W, C] -> float [H2, W2, C], separable Lanczos-3 (rows then cols)
void lanczos_resize_f32(const float* in, int64_t H, int64_t W, int64_t C,
                        int64_t H2, int64_t W2, float* out) {
  const AxisTaps tx = build_taps(W, W2);
  const AxisTaps ty = build_taps(H, H2);
  std::vector<float> mid(static_cast<size_t>(H) * W2 * C);

  int64_t n_threads = std::min<int64_t>(
      std::max(1u, std::thread::hardware_concurrency()), std::max<int64_t>(H, 1));
  {
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int64_t t = 0; t < n_threads; ++t) {
      workers.emplace_back([=, &tx, &mid]() {
        for (int64_t r = t; r < H; r += n_threads) {
          const float* row = in + r * W * C;
          float* orow = mid.data() + r * W2 * C;
          for (int64_t c = 0; c < W2; ++c) {
            const float* wts = tx.weights.data() + c * tx.max_count;
            const int64_t f = tx.first[c], n = tx.count[c];
            for (int64_t ch = 0; ch < C; ++ch) {
              float acc = 0.0f;
              for (int64_t k = 0; k < n; ++k)
                acc += wts[k] * row[(f + k) * C + ch];
              orow[c * C + ch] = acc;
            }
          }
        }
      });
    }
    for (auto& w : workers) w.join();
  }
  {
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int64_t t = 0; t < n_threads; ++t) {
      workers.emplace_back([=, &ty, &mid]() {
        for (int64_t r = t; r < H2; r += n_threads) {
          const float* wts = ty.weights.data() + r * ty.max_count;
          const int64_t f = ty.first[r], n = ty.count[r];
          float* orow = out + r * W2 * C;
          for (int64_t c = 0; c < W2 * C; ++c) {
            float acc = 0.0f;
            for (int64_t k = 0; k < n; ++k)
              acc += wts[k] * mid[(f + k) * W2 * C + c];
            orow[c] = acc;
          }
        }
      });
    }
    for (auto& w : workers) w.join();
  }
}

}  // extern "C"
