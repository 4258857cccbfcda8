// munit_tpu_torch native image ops — the host-side data-pipeline hot path.
//
// The reference's loader burns CPU in a chain of PIL ops per sample
// (flip → resize → crop → to-tensor → normalize, utils.py:287-337). This
// library fuses the whole post-decode chain into one pass:
//   uint8 HWC → (optional hflip) → PIL-style ANTIALIASED bilinear
//   shorter-side resize → crop → float32 HWC in [-1, 1]
// computing only the cropped region, with separable triangle-filter
// resampling (support scaled by the downscale factor — the same convolution
// PIL's BILINEAR resize performs, in float instead of PIL's int16
// fixed-point, so outputs agree within ~1/255).
//
// The PyTorch port's copy of munit_tpu/native/imageops.cpp, built with the
// same flags as a plain shared library and bound via ctypes in
// munit_tpu_torch/native/__init__.py, with a PIL fallback where no g++ is
// installed.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Weights {
  // for each output index: source start + normalized weights
  std::vector<int> xmin;
  std::vector<int> xsize;
  std::vector<float> w;  // stride = max window
  int kmax = 0;
};

// PIL-style triangle (bilinear) resampling weights for in_size -> out_size,
// evaluated only for output indices [out_lo, out_lo+out_n).
Weights make_weights(int in_size, int out_size, int out_lo, int out_n) {
  Weights ws;
  const double scale = (double)in_size / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // bilinear support = 1
  const int kmax = (int)std::ceil(support) * 2 + 1;
  ws.kmax = kmax;
  ws.xmin.resize(out_n);
  ws.xsize.resize(out_n);
  ws.w.assign((size_t)out_n * kmax, 0.f);
  for (int i = 0; i < out_n; ++i) {
    const int oo = out_lo + i;
    const double center = (oo + 0.5) * scale;
    int x0 = (int)(center - support + 0.5);
    int x1 = (int)(center + support + 0.5);
    x0 = std::max(x0, 0);
    x1 = std::min(x1, in_size);
    double sum = 0.0;
    for (int x = x0; x < x1; ++x) {
      const double t = (x - center + 0.5) / filterscale;
      const double k = (t < 0 ? (t <= -1 ? 0.0 : 1.0 + t)
                              : (t >= 1 ? 0.0 : 1.0 - t));
      ws.w[(size_t)i * kmax + (x - x0)] = (float)k;
      sum += k;
    }
    if (sum > 0) {
      for (int x = 0; x < x1 - x0; ++x)
        ws.w[(size_t)i * kmax + x] /= (float)sum;
    }
    ws.xmin[i] = x0;
    ws.xsize[i] = x1 - x0;
  }
  return ws;
}

void resized_dims(int h, int w, int new_size, int* rh, int* rw) {
  if (w <= h) {
    *rw = new_size;
    *rh = std::max(1, (int)std::lround((double)h * new_size / w));
  } else {
    *rh = new_size;
    *rw = std::max(1, (int)std::lround((double)w * new_size / h));
  }
}

}  // namespace

extern "C" {

// Fused transform; see file header. Returns 0 on success.
int mt_transform(const uint8_t* src, int h, int w, int c,
                 int flip, int new_size, int crop_i, int crop_j,
                 int crop_h, int crop_w, int normalize, float* dst) {
  if (!src || !dst || c < 1 || c > 4 || h < 1 || w < 1) return -1;
  int rh, rw;
  resized_dims(h, w, new_size, &rh, &rw);
  if (crop_i < 0 || crop_j < 0 || crop_i + crop_h > rh || crop_j + crop_w > rw)
    return -2;

  const Weights wx = make_weights(w, rw, crop_j, crop_w);
  const Weights wy = make_weights(h, rh, crop_i, crop_h);

  // horizontal pass over all source rows that the vertical pass touches
  int y_lo = h, y_hi = 0;
  for (int i = 0; i < crop_h; ++i) {
    y_lo = std::min(y_lo, wy.xmin[i]);
    y_hi = std::max(y_hi, wy.xmin[i] + wy.xsize[i]);
  }
  const int ny = y_hi - y_lo;
  std::vector<float> tmp((size_t)ny * crop_w * c);
  for (int yy = 0; yy < ny; ++yy) {
    const uint8_t* row = src + (size_t)(y_lo + yy) * w * c;
    float* trow = tmp.data() + (size_t)yy * crop_w * c;
    for (int ox = 0; ox < crop_w; ++ox) {
      const int x0 = wx.xmin[ox];
      const int n = wx.xsize[ox];
      const float* ww = wx.w.data() + (size_t)ox * wx.kmax;
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k) {
          int sxc = x0 + k;
          if (flip) sxc = w - 1 - sxc;
          acc += ww[k] * row[(size_t)sxc * c + ch];
        }
        trow[(size_t)ox * c + ch] = acc;
      }
    }
  }

  // vertical pass + normalize
  const float scale = normalize ? 2.0f / 255.0f : 1.0f / 255.0f;
  const float shift = normalize ? -1.0f : 0.0f;
  for (int oy = 0; oy < crop_h; ++oy) {
    const int y0 = wy.xmin[oy];
    const int n = wy.xsize[oy];
    const float* ww = wy.w.data() + (size_t)oy * wy.kmax;
    float* out = dst + (size_t)oy * crop_w * c;
    for (int ox = 0; ox < crop_w; ++ox) {
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < n; ++k)
          acc += ww[k] *
                 tmp[(size_t)(y0 - y_lo + k) * crop_w * c + (size_t)ox * c + ch];
        out[(size_t)ox * c + ch] = acc * scale + shift;
      }
    }
  }
  return 0;
}

// Nearest-neighbor variant for masks / semantic maps (PIL Image.NEAREST):
// src uint8 HW, output uint8 crop_h*crop_w.
int mt_transform_nearest(const uint8_t* src, int h, int w,
                         int flip, int new_size, int crop_i, int crop_j,
                         int crop_h, int crop_w, uint8_t* dst) {
  if (!src || !dst || h < 1 || w < 1) return -1;
  int rh, rw;
  resized_dims(h, w, new_size, &rh, &rw);
  if (crop_i < 0 || crop_j < 0 || crop_i + crop_h > rh || crop_j + crop_w > rw)
    return -2;
  const double sy = (double)h / rh;
  const double sx = (double)w / rw;
  for (int oy = 0; oy < crop_h; ++oy) {
    // PIL NEAREST samples at (o + 0.5) * scale, truncated
    int y = std::min((int)((crop_i + oy + 0.5) * sy), h - 1);
    const uint8_t* row = src + (size_t)y * w;
    uint8_t* out = dst + (size_t)oy * crop_w;
    for (int ox = 0; ox < crop_w; ++ox) {
      int x = std::min((int)((crop_j + ox + 0.5) * sx), w - 1);
      if (flip) x = w - 1 - x;
      out[ox] = row[x];
    }
  }
  return 0;
}

void mt_resized_dims(int h, int w, int new_size, int* rh, int* rw) {
  resized_dims(h, w, new_size, rh, rw);
}

}  // extern "C"
