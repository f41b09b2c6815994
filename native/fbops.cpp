// Native framebuffer ops for spectral_tpu.
//
// Host-side equivalent of the reference's C++ host image layer:
//   - XYZ -> sRGB -> gamma -> uint8 conversion (save_to_fb,
//     rendering/rendering.cu:140-149 + color/color.cu:15-49 +
//     frame_buffer.cuh image_channels) for the full frame on the host,
//     multithreaded over rows;
//   - 24-bit BMP encoding (io/save_image.cpp via CImg save_bmp layout:
//     bottom-up rows, BGR, 4-byte row padding).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bruce Lindbloom D65 XYZ -> linear sRGB (reference utils/color_const.cu:13-27)
constexpr float kXyzToSrgb[9] = {
    3.2404542f, -1.5371385f, -0.4985314f,
    -0.9692660f, 1.8760108f,  0.0415560f,
    0.0556434f, -0.2040259f,  1.0572252f,
};

inline float gamma_correct(float u) {
  // exact twin of ops/color.py srgb_gamma_compress (reference
  // color/color.cu:15-22 nested ternary, truncated exponent 0.416666)
  if (u < 0.0f) return 0.0f;
  if (u < 0.0031308f) return 12.92f * u;
  if (u < 1.0f) return 1.055f * std::pow(u, 0.416666f) - 0.055f;
  return 1.0f;
}

inline uint8_t to_u8(float v) {
  // exact twin of ops/color.py expand_srgb + to_uint8 (reference
  // color.cu:43-49 trunc(v * 255.99), frame_buffer.cuh:31-37 cast)
  v = std::trunc(v * 255.99f);
  v = std::min(std::max(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(v);
}

void convert_rows(const float* xyz, uint8_t* out, int64_t begin, int64_t end,
                  float inv_spp) {
  for (int64_t i = begin; i < end; ++i) {
    const float x = xyz[3 * i + 0] * inv_spp;
    const float y = xyz[3 * i + 1] * inv_spp;
    const float z = xyz[3 * i + 2] * inv_spp;
    for (int c = 0; c < 3; ++c) {
      const float lin = kXyzToSrgb[3 * c + 0] * x + kXyzToSrgb[3 * c + 1] * y +
                        kXyzToSrgb[3 * c + 2] * z;
      out[3 * i + c] = to_u8(gamma_correct(lin));
    }
  }
}

}  // namespace

extern "C" {

// xyz: [n, 3] float32 accumulated XYZ; out: [n, 3] uint8 sRGB.
void stpu_xyz_to_srgb_u8(const float* xyz, int64_t n, float inv_spp,
                         uint8_t* out) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int64_t kMinPerThread = 1 << 15;
  const unsigned nthreads = static_cast<unsigned>(
      std::min<int64_t>(hw, std::max<int64_t>(1, n / kMinPerThread)));
  if (nthreads <= 1) {
    convert_rows(xyz, out, 0, n, inv_spp);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t step = (n + nthreads - 1) / nthreads;
  for (unsigned t = 0; t < nthreads; ++t) {
    const int64_t b = t * step;
    const int64_t e = std::min<int64_t>(n, b + step);
    if (b >= e) break;
    threads.emplace_back(convert_rows, xyz, out, b, e, inv_spp);
  }
  for (auto& th : threads) th.join();
}

// Returns the number of bytes a BMP for (w, h) needs.
int64_t stpu_bmp_size(int32_t w, int32_t h) {
  const int64_t row = static_cast<int64_t>(w) * 3;
  const int64_t pad = (4 - row % 4) % 4;
  return 54 + (row + pad) * h;
}

// rgb: [h, w, 3] uint8 top-down RGB; out: buffer of stpu_bmp_size bytes.
void stpu_encode_bmp(const uint8_t* rgb, int32_t w, int32_t h, uint8_t* out) {
  const int64_t row = static_cast<int64_t>(w) * 3;
  const int64_t pad = (4 - row % 4) % 4;
  const int64_t image_size = (row + pad) * h;
  const uint32_t file_size = static_cast<uint32_t>(54 + image_size);

  std::memset(out, 0, 54);
  out[0] = 'B';
  out[1] = 'M';
  std::memcpy(out + 2, &file_size, 4);
  const uint32_t offset = 54;
  std::memcpy(out + 10, &offset, 4);
  const uint32_t hdr = 40;
  std::memcpy(out + 14, &hdr, 4);
  std::memcpy(out + 18, &w, 4);
  std::memcpy(out + 22, &h, 4);
  const uint16_t planes = 1, bpp = 24;
  std::memcpy(out + 26, &planes, 2);
  std::memcpy(out + 28, &bpp, 2);
  const uint32_t isz = static_cast<uint32_t>(image_size);
  std::memcpy(out + 34, &isz, 4);
  const int32_t ppm = 2835;
  std::memcpy(out + 38, &ppm, 4);
  std::memcpy(out + 42, &ppm, 4);

  uint8_t* p = out + 54;
  for (int32_t y = h - 1; y >= 0; --y) {
    const uint8_t* src = rgb + static_cast<int64_t>(y) * row;
    for (int32_t x = 0; x < w; ++x) {
      p[0] = src[3 * x + 2];
      p[1] = src[3 * x + 1];
      p[2] = src[3 * x + 0];
      p += 3;
    }
    std::memset(p, 0, pad);
    p += pad;
  }
}

}  // extern "C"
