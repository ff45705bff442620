// ssad_tpu_torch native host-data loader: threaded PNG/JPEG decode + resize.
//
// A copy of ssad_tpu/native/loader.cpp for the PyTorch/CUDA port (the
// port builds and loads its own; only this header differs).  The
// reference's input pipeline decodes every PNG with PIL inside 8 forked
// Python dataloader workers, every epoch (reference datasets.py:67-80,
// :209-213, :501-533).  The port decodes each split exactly once
// (data/mvtec.py), so the remaining host cost is that one decode+resize
// sweep over the dataset.  This file fuses
//   file read -> libpng/libjpeg decode -> PIL-compatible bicubic
//   resize -> float32 [0,1] (or uint8) output
// across a std::thread worker pool, writing straight into the caller's
// numpy buffer.  No Python objects, no GIL, no intermediate copies; the
// pool degrades to sequential on one core.
//
// Exposed C ABI (ctypes-bound in ssad_tpu_torch/native/__init__.py):
//   ssad_decode_resize_batch(paths, n, out_h, out_w, channels,
//                            out_f32, n_threads, err_idx) -> int
//   ssad_probe() -> int   (always 1; binding sanity check)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -lpng -ljpeg

#include <png.h>
#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Decoding: file -> interleaved RGB8 (or GRAY8) buffer at native size.
// ---------------------------------------------------------------------

struct RawImage {
  std::vector<uint8_t> pixels;  // h*w*c
  int h = 0, w = 0, c = 0;
  bool ok = false;
};

RawImage decode_png(const char* path, int want_channels) {
  RawImage out;
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) return out;
  image.format = (want_channels == 1) ? PNG_FORMAT_GRAY : PNG_FORMAT_RGB;
  out.h = static_cast<int>(image.height);
  out.w = static_cast<int>(image.width);
  out.c = want_channels;
  out.pixels.resize(PNG_IMAGE_SIZE(image));
  if (!png_image_finish_read(&image, nullptr, out.pixels.data(), 0, nullptr)) {
    png_image_free(&image);
    return out;
  }
  out.ok = true;
  return out;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

RawImage decode_jpeg(const char* path, int want_channels) {
  RawImage out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (want_channels == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.h = static_cast<int>(cinfo.output_height);
  out.w = static_cast<int>(cinfo.output_width);
  out.c = want_channels;
  out.pixels.resize(static_cast<size_t>(out.h) * out.w * out.c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.pixels.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out.w * out.c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  out.ok = true;
  return out;
}

bool has_suffix(const char* path, const char* suf) {
  size_t lp = std::strlen(path), ls = std::strlen(suf);
  if (ls > lp) return false;
  for (size_t i = 0; i < ls; ++i) {
    char a = path[lp - ls + i], b = suf[i];
    if (a >= 'A' && a <= 'Z') a = static_cast<char>(a - 'A' + 'a');
    if (a != b) return false;
  }
  return true;
}

RawImage decode_any(const char* path, int want_channels) {
  if (has_suffix(path, ".png")) return decode_png(path, want_channels);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg(path, want_channels);
  return RawImage{};
}

// ---------------------------------------------------------------------
// PIL-compatible bicubic resampling (Pillow Resample.c semantics):
// separable convolution, horizontal then vertical, weights from the
// Catmull-Rom cubic (a = -0.5, support 2.0) stretched by the scale
// factor when downscaling, normalized per output pixel, with [0,255]
// clamping between passes.  data/mvtec.py's PIL path is the oracle —
// tests/test_native.py checks agreement to <2/255 per pixel.
// ---------------------------------------------------------------------

double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterTable {
  int ksize = 0;                 // max taps per output pixel
  std::vector<int> bounds;       // 2*out: (xmin, xcount)
  std::vector<double> weights;   // out*ksize
};

FilterTable precompute(int in_size, int out_size) {
  FilterTable t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(2 * out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double* w = &t.weights[static_cast<size_t>(xx) * t.ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      const double v = bicubic((x - center + 0.5) / filterscale);
      w[x - xmin] = v;
      total += v;
    }
    if (total != 0.0)
      for (int x = 0; x < xmax - xmin; ++x) w[x] /= total;
    t.bounds[2 * xx] = xmin;
    t.bounds[2 * xx + 1] = xmax - xmin;
  }
  return t;
}

// resize (h,w,c) uint8 -> (out_h,out_w,c) float in [0,255]
std::vector<float> resize_bicubic(const RawImage& img, int out_h, int out_w) {
  const int c = img.c;
  const FilterTable fx = precompute(img.w, out_w);
  const FilterTable fy = precompute(img.h, out_h);

  // horizontal pass: (h, w, c) u8 -> (h, out_w, c) float, clamped
  std::vector<float> horiz(static_cast<size_t>(img.h) * out_w * c);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.pixels.data() + static_cast<size_t>(y) * img.w * c;
    float* orow = horiz.data() + static_cast<size_t>(y) * out_w * c;
    for (int xx = 0; xx < out_w; ++xx) {
      const int xmin = fx.bounds[2 * xx], xcount = fx.bounds[2 * xx + 1];
      const double* w = &fx.weights[static_cast<size_t>(xx) * fx.ksize];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int k = 0; k < xcount; ++k)
          acc += row[(xmin + k) * c + ch] * w[k];
        if (acc < 0.0) acc = 0.0;
        if (acc > 255.0) acc = 255.0;
        orow[xx * c + ch] = static_cast<float>(acc);
      }
    }
  }

  // vertical pass: (h, out_w, c) -> (out_h, out_w, c), clamped
  std::vector<float> out(static_cast<size_t>(out_h) * out_w * c);
  for (int yy = 0; yy < out_h; ++yy) {
    const int ymin = fy.bounds[2 * yy], ycount = fy.bounds[2 * yy + 1];
    const double* w = &fy.weights[static_cast<size_t>(yy) * fy.ksize];
    float* orow = out.data() + static_cast<size_t>(yy) * out_w * c;
    for (int x = 0; x < out_w * c; ++x) {
      double acc = 0.0;
      for (int k = 0; k < ycount; ++k)
        acc += horiz[static_cast<size_t>(ymin + k) * out_w * c + x] * w[k];
      if (acc < 0.0) acc = 0.0;
      if (acc > 255.0) acc = 255.0;
      orow[x] = static_cast<float>(acc);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Decode + resize a batch of image files into out (n, out_h, out_w, c)
// float32 in [0, 1].  channels: 3 = RGB, 1 = grayscale.  paths that
// fail to decode leave zeros and set *err_idx to the first failing
// index (err_idx may be null).  Returns the number of failures.
int ssad_decode_resize_batch(const char** paths, int n, int out_h, int out_w,
                             int channels, float* out, int n_threads,
                             int* err_idx) {
  if (n <= 0) return 0;
  const size_t per = static_cast<size_t>(out_h) * out_w * channels;
  std::atomic<int> next(0), failures(0), first_err(-1);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      RawImage img = decode_any(paths[i], channels);
      float* dst = out + static_cast<size_t>(i) * per;
      if (!img.ok) {
        std::memset(dst, 0, per * sizeof(float));
        failures.fetch_add(1);
        int expected = -1;
        first_err.compare_exchange_strong(expected, i);
        continue;
      }
      if (img.h == out_h && img.w == out_w) {
        for (size_t k = 0; k < per; ++k)
          dst[k] = img.pixels[k] / 255.0f;
      } else {
        std::vector<float> resized = resize_bicubic(img, out_h, out_w);
        for (size_t k = 0; k < per; ++k) dst[k] = resized[k] / 255.0f;
      }
    }
  };

  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  int nt = n_threads > 0 ? n_threads : hw;
  if (nt > n) nt = n;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nt);
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  if (err_idx) *err_idx = first_err.load();
  return failures.load();
}

int ssad_probe() { return 1; }

}  // extern "C"
