// Host-side resampling kernels for video preprocessing (the PyTorch port's
// own copy of the repo's native/remap.cc: the same code, built by
// imagine360_tpu_torch/native/__init__.py).
//
// The reference's preprocessing leans on OpenCV's C++ remap
// (cv2.remap BORDER_WRAP — reference src/utils/pano_utils/Equirec2Perspec.py,
// Perspec2Equirec.py) executed per frame from Python. This library provides
// the same bilinear/nearest wrap-border resampling as a standalone,
// multi-threaded C++ kernel with a ctypes interface, so the host data path
// has no OpenCV dependency and overlaps with device compute.
//
// Layout: images are HWC float32 (or uint8 for the converting variants);
// grids are [outH, outW] absolute source coordinates.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int wrap_i(int x, int n) {
  int m = x % n;
  return m < 0 ? m + n : m;
}

template <typename Src>
void remap_bilinear_rows(const Src* src, int H, int W, int C,
                         const float* gx, const float* gy, int outH, int outW,
                         float* out, int row0, int row1, bool wrap_x) {
  for (int r = row0; r < row1; ++r) {
    for (int c = 0; c < outW; ++c) {
      const float x = gx[r * outW + c];
      const float y = gy[r * outW + c];
      const int x0 = static_cast<int>(std::floor(x));
      const int y0 = static_cast<int>(std::floor(y));
      const float wx = x - x0;
      const float wy = y - y0;
      int xa, xb;
      if (wrap_x) {
        xa = wrap_i(x0, W);
        xb = wrap_i(x0 + 1, W);
      } else {
        xa = std::clamp(x0, 0, W - 1);
        xb = std::clamp(x0 + 1, 0, W - 1);
      }
      const int ya = std::clamp(y0, 0, H - 1);
      const int yb = std::clamp(y0 + 1, 0, H - 1);
      const Src* p00 = src + (static_cast<int64_t>(ya) * W + xa) * C;
      const Src* p01 = src + (static_cast<int64_t>(ya) * W + xb) * C;
      const Src* p10 = src + (static_cast<int64_t>(yb) * W + xa) * C;
      const Src* p11 = src + (static_cast<int64_t>(yb) * W + xb) * C;
      float* o = out + (static_cast<int64_t>(r) * outW + c) * C;
      const float w00 = (1 - wx) * (1 - wy), w01 = wx * (1 - wy);
      const float w10 = (1 - wx) * wy, w11 = wx * wy;
      for (int k = 0; k < C; ++k) {
        o[k] = w00 * static_cast<float>(p00[k]) +
               w01 * static_cast<float>(p01[k]) +
               w10 * static_cast<float>(p10[k]) +
               w11 * static_cast<float>(p11[k]);
      }
    }
  }
}

template <typename Src>
void run_threaded(const Src* src, int H, int W, int C, const float* gx,
                  const float* gy, int outH, int outW, float* out,
                  bool wrap_x, int num_threads) {
  if (num_threads <= 1 || outH < 2 * num_threads) {
    remap_bilinear_rows(src, H, W, C, gx, gy, outH, outW, out, 0, outH,
                        wrap_x);
    return;
  }
  std::vector<std::thread> threads;
  const int rows = (outH + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int r0 = t * rows;
    const int r1 = std::min(outH, r0 + rows);
    if (r0 >= r1) break;
    threads.emplace_back([=] {
      remap_bilinear_rows(src, H, W, C, gx, gy, outH, outW, out, r0, r1,
                          wrap_x);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void remap_bilinear_f32(const float* src, int H, int W, int C,
                        const float* gx, const float* gy, int outH, int outW,
                        float* out, int wrap_x, int num_threads) {
  run_threaded(src, H, W, C, gx, gy, outH, outW, out, wrap_x != 0,
               num_threads);
}

void remap_bilinear_u8(const uint8_t* src, int H, int W, int C,
                       const float* gx, const float* gy, int outH, int outW,
                       float* out, int wrap_x, int num_threads) {
  run_threaded(src, H, W, C, gx, gy, outH, outW, out, wrap_x != 0,
               num_threads);
}

// uint8 HWC -> float32 in [-1, 1] (the model input range), multi-threaded.
void u8_to_model_range(const uint8_t* src, int64_t n, float* out,
                       int num_threads) {
  auto work = [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      out[i] = static_cast<float>(src[i]) / 127.5f - 1.0f;
  };
  if (num_threads <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// Largest all-ones axis-aligned rectangle in a binary mask (histogram-stack
// DP). Replaces the per-frame python DP in anchor extraction
// (reference src/modules/utils.py:39-73). mask: [h, w] uint8 (0/1).
// out4: {top, left, width, height}.
void max_inscribed_rect_u8(const uint8_t* mask, int h, int w, int* out4) {
  std::vector<int> heights(w + 1, 0);
  std::vector<int> stack;
  stack.reserve(w + 1);
  int64_t best_area = 0;
  out4[0] = out4[1] = out4[2] = out4[3] = 0;
  for (int i = 0; i < h; ++i) {
    for (int j = 0; j < w; ++j) {
      heights[j] = mask[static_cast<int64_t>(i) * w + j] ? heights[j] + 1 : 0;
    }
    stack.clear();
    for (int j = 0; j <= w; ++j) {
      const int cur = (j < w) ? heights[j] : 0;
      int start = j;
      while (!stack.empty() && heights[stack.back()] > cur) {
        const int s = stack.back();
        stack.pop_back();
        const int hh = heights[s];
        const int ww = stack.empty() ? j : j - stack.back() - 1;
        const int64_t area = static_cast<int64_t>(hh) * ww;
        if (area > best_area) {
          best_area = area;
          out4[0] = i - hh + 1;
          out4[1] = stack.empty() ? 0 : stack.back() + 1;
          out4[2] = ww;
          out4[3] = hh;
        }
        start = s;
      }
      stack.push_back(j);
      (void)start;
    }
  }
}

}  // extern "C"
