// Native host-side segmentation batch preparation.
//
// The reference delegates its per-sample host geometry to OpenCV's native
// code (cv2.resize bilinear/nearest + numpy crops inside __getitem__,
// reference: code/datasets/segmentation/cocostuff.py:104-140). This library
// is the framework's native equivalent: a threaded batch-assembly kernel
// that, for each sample, applies
//   1. optional pre-scale (bilinear for the image, nearest for the label),
//   2. optional random scale,
//   3. centre-pad + random/centre crop to input_sz (identical coordinate
//      conventions to iic_tpu.data.seg_transforms.pad_and_or_crop),
//   4. label-table remap + relevancy mask,
// writing directly into the pinned output batch buffers the device upload
// consumes. Exposed via a plain C ABI for ctypes (no pybind11 in this
// image).
//
// Build: iic_tpu/native/build.py (g++ -O3 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear resize, uint8 HWC -> uint8 HWC (half-pixel centres, matching
// cv2.INTER_LINEAR).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = std::clamp(y0, 0, sh - 1);
    int y1c = std::clamp(y0 + 1, 0, sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = std::clamp(x0, 0, sw - 1);
      int x1c = std::clamp(x0 + 1, 0, sw - 1);
      for (int ch = 0; ch < c; ++ch) {
        float v00 = src[(y0c * sw + x0c) * c + ch];
        float v01 = src[(y0c * sw + x1c) * c + ch];
        float v10 = src[(y1c * sw + x0c) * c + ch];
        float v11 = src[(y1c * sw + x1c) * c + ch];
        float v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                  v10 * wy * (1 - wx) + v11 * wy * wx;
        dst[(y * dw + x) * c + ch] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// Nearest resize for label maps (int32), matching cv2.INTER_NEAREST.
void resize_nearest_i32(const int32_t* src, int sh, int sw, int32_t* dst,
                        int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    int ys = std::min(static_cast<int>(std::floor((y + 0.5f) * sy)), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xs =
          std::min(static_cast<int>(std::floor((x + 0.5f) * sx)), sw - 1);
      dst[y * dw + x] = src[ys * sw + xs];
    }
  }
}

// Centre-pad to at least (sz, sz) then crop about centre (h_c, w_c):
// identical indexing to pad_and_or_crop (seg_transforms.py).
template <typename T>
void pad_crop(const T* src, int h, int w, int c, T* dst, int sz, int h_c,
              int w_c) {
  int new_h = std::max(h, sz), new_w = std::max(w, sz);
  int ph = new_h / 2 - h / 2;  // source placed at [ph, ph+h)
  int pw = new_w / 2 - w / 2;
  int h_start = h_c - sz / 2;
  int w_start = w_c - sz / 2;
  for (int y = 0; y < sz; ++y) {
    int yy = h_start + y;      // coordinate in padded frame
    int ys = yy - ph;          // coordinate in source frame
    for (int x = 0; x < sz; ++x) {
      int xx = w_start + x;
      int xs = xx - pw;
      T* out = dst + (static_cast<int64_t>(y) * sz + x) * c;
      if (ys >= 0 && ys < h && xs >= 0 && xs < w) {
        const T* in = src + (static_cast<int64_t>(ys) * w + xs) * c;
        std::memcpy(out, in, sizeof(T) * c);
      } else {
        std::memset(out, 0, sizeof(T) * c);
      }
    }
  }
}

struct SampleSpec {
  const uint8_t* img;
  const int32_t* label;  // may be null
  int h, w, c;
  float scale;      // combined pre_scale * random scale; 1.0 = none
  int h_c, w_c;     // crop centre in the (scaled, padded) frame
};

}  // namespace

extern "C" {

// Prepare one batch of train samples.
//  specs are flattened per-sample arrays; label_table maps raw label values
//  (offset by 1 so -1 is index 0) to filtered labels; mask = label >= 0.
//  imgs_out: (batch, sz, sz, c) uint8; masks_out: (batch, sz, sz) uint8.
// Returns 0 on success.
int seg_prepare_batch(const uint8_t** imgs, const int32_t** labels,
                      const int32_t* heights, const int32_t* widths,
                      int channels, int batch,
                      const float* scales, const int32_t* h_cs,
                      const int32_t* w_cs, int input_sz,
                      const int32_t* label_table, int table_len,
                      uint8_t* imgs_out, uint8_t* masks_out,
                      int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    std::vector<uint8_t> img_scaled;
    std::vector<int32_t> lab_scaled;
    std::vector<int32_t> lab_crop;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) break;
      int h = heights[i], w = widths[i];
      const uint8_t* img = imgs[i];
      const int32_t* lab = labels ? labels[i] : nullptr;

      int sh = h, sw = w;
      if (scales[i] != 1.0f) {
        sh = std::max(1, static_cast<int>(std::round(h * scales[i])));
        sw = std::max(1, static_cast<int>(std::round(w * scales[i])));
        img_scaled.resize(static_cast<size_t>(sh) * sw * channels);
        resize_bilinear_u8(img, h, w, channels, img_scaled.data(), sh, sw);
        img = img_scaled.data();
        if (lab) {
          lab_scaled.resize(static_cast<size_t>(sh) * sw);
          resize_nearest_i32(lab, h, w, lab_scaled.data(), sh, sw);
          lab = lab_scaled.data();
        }
      }

      uint8_t* img_out =
          imgs_out + static_cast<int64_t>(i) * input_sz * input_sz * channels;
      pad_crop<uint8_t>(img, sh, sw, channels, img_out, input_sz, h_cs[i],
                        w_cs[i]);

      uint8_t* mask_out =
          masks_out + static_cast<int64_t>(i) * input_sz * input_sz;
      if (lab) {
        lab_crop.resize(static_cast<size_t>(input_sz) * input_sz);
        pad_crop<int32_t>(lab, sh, sw, 1, lab_crop.data(), input_sz,
                          h_cs[i], w_cs[i]);
        for (int p = 0; p < input_sz * input_sz; ++p) {
          int32_t v = lab_crop[p] + 1;  // -1 -> 0
          int32_t mapped = (v >= 0 && v < table_len) ? label_table[v] : -1;
          mask_out[p] = mapped >= 0 ? 1 : 0;
        }
      } else {
        std::memset(mask_out, 1, static_cast<size_t>(input_sz) * input_sz);
      }
    }
  };

  int n_threads = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

}  // extern "C"
