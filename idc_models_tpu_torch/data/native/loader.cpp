// Native IDC image loader: threaded PNG decode + bilinear resize.
//
// The reference's input pipeline rides tf.data's C++ runtime (PNG decode,
// resize, prefetch -- dist_model_tf_vgg.py:34-65 via tf.io/tf.image). This
// is the port's native equivalent, the same source as
// idc_models_tpu/data/native/loader.cpp: libpng decode fanned out over a
// std::thread pool, bilinear resize to the target patch size, float32
// [0,1] NHWC output written straight into a caller-provided (numpy)
// buffer. Exposed as a C ABI consumed through ctypes
// (idc_models_tpu_torch/data/native/__init__.py) -- no Python in the
// decode path, so the host keeps the card fed.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cpp -lpng -lz -lpthread
//        (see _build in __init__.py; rebuilt lazily when stale).

#include <png.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Decode one PNG to RGB8. Returns true on success; fills w/h and pixels.
bool decode_png_rgb(const char* path, std::vector<uint8_t>* pixels,
                    unsigned* width, unsigned* height) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return false;
  image.format = PNG_FORMAT_RGB;  // libpng converts gray/palette/alpha
  pixels->resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, pixels->data(), 0, nullptr)) {
    png_image_free(&image);
    return false;
  }
  *width = image.width;
  *height = image.height;
  return true;
}

// Bilinear resize RGB8 (h,w) -> float32 [0,1] (size,size,3), matching
// PIL's BILINEAR (align_corners=false, half-pixel centers).
void resize_bilinear(const uint8_t* src, unsigned w, unsigned h,
                     int size, float* dst) {
  const float sx = static_cast<float>(w) / size;
  const float sy = static_cast<float>(h) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < static_cast<int>(h) ? y0 + 1 : h - 1;
    float wy = fy - y0;
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < static_cast<int>(w) ? x0 + 1 : w - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        float v00 = src[(y0 * w + x0) * 3 + c];
        float v01 = src[(y0 * w + x1) * 3 + c];
        float v10 = src[(y1 * w + x0) * 3 + c];
        float v11 = src[(y1 * w + x1) * 3 + c];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        dst[(oy * size + ox) * 3 + c] = (top + (bot - top) * wy) / 255.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Decode `n` PNG files to float32 [0,1] NHWC batches of (size,size,3).
// `out` must hold n*size*size*3 floats. Failed decodes leave their slot
// zeroed and are counted in the return value (0 == all succeeded).
// `status` (nullable) must hold n bytes; gets 1 per decoded file, 0 per
// failure, so the caller can name the failing paths.
int idc_decode_batch(const char** paths, int n, int size, float* out,
                     int n_threads, unsigned char* status) {
  if (n <= 0) return 0;
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  const size_t stride = static_cast<size_t>(size) * size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      unsigned w = 0, h = 0;
      float* dst = out + stride * i;
      if (!decode_png_rgb(paths[i], &pixels, &w, &h) || w == 0 || h == 0) {
        std::memset(dst, 0, stride * sizeof(float));
        if (status) status[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      if (status) status[i] = 1;
      if (static_cast<int>(w) == size && static_cast<int>(h) == size) {
        for (size_t p = 0; p < stride; ++p) dst[p] = pixels[p] / 255.0f;
      } else {
        resize_bilinear(pixels.data(), w, h, size, dst);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// ABI version so the Python side can detect stale binaries.
int idc_loader_abi_version() { return 2; }

}  // extern "C"
