// Copy of native/dataio.cpp, built by camouflage_multimodal_tpu_torch/native.py.
//
// Native host-side data loader for the TPU pipeline.
//
// The reference fed its models through PIL decode + resize in Python
// DataLoader workers (region_graph/train.py:56-64); on a TPU host the decode
// is the only work that must stay on CPU, and it must keep up with the
// device. This loader decodes JPEG (libjpeg) / PNG (libpng), resizes with a
// PIL-compatible antialiased bicubic filter (Catmull-Rom-style a=-0.5 with
// support scaling), converts to float32 in [0,1], and fans a batch out over
// a thread pool — exposed to Python through ctypes (see
// camouflage_multimodal_tpu_torch/native.py).
//
// Build: at first use by camouflage_multimodal_tpu_torch/native.py (g++,
// links libjpeg/libpng only)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <setjmp.h>

#ifdef __SSE4_1__
#include <immintrin.h>
#endif

namespace {

struct Image {
  int w = 0, h = 0, c = 0;  // c in {1, 3}
  std::vector<uint8_t> data;  // row-major, interleaved
};

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// draft_min_size > 0 enables libjpeg DCT scaling: decode at the smallest
// M/8 scale whose output still covers draft_min_size on both axes (the IDCT
// then runs on fewer coefficients — a high-quality low-pass downsample for
// ~2-3x less decode + resize work). 0 = full-resolution decode (PIL parity).
bool decode_jpeg(FILE* f, Image* out, int draft_min_size) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  if (draft_min_size > 0) {
    cinfo.scale_denom = 8;
    for (int m = 1; m <= 8; m++) {
      cinfo.scale_num = m;
      jpeg_calc_output_dimensions(&cinfo);
      if (int(cinfo.output_width) >= draft_min_size &&
          int(cinfo.output_height) >= draft_min_size)
        break;  // smallest scale that still covers the target box
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->c = 3;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode
// ---------------------------------------------------------------------------

bool decode_png(FILE* f, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);

  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  color_type = png_get_color_type(png, info);
  int channels = (color_type == PNG_COLOR_TYPE_GRAY) ? 1 : 3;
  out->w = int(w);
  out->h = int(h);
  out->c = channels;
  out->data.resize(size_t(w) * h * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; y++)
    rows[y] = out->data.data() + size_t(y) * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, Image* out, int draft_min_size = 0) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, draft_min_size);
  } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out);  // draft is a JPEG-only concept
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// PIL-style grayscale + antialiased bicubic resize
// ---------------------------------------------------------------------------

// PIL convert('L'): L = R*299/1000 + G*587/1000 + B*114/1000
inline uint8_t to_gray(uint8_t r, uint8_t g, uint8_t b) {
  return uint8_t((r * 299 + g * 587 + b * 114) / 1000);
}

// Keys cubic kernel, a = -0.5 (PIL BICUBIC)
inline double cubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct FilterTaps {
  std::vector<int> xmin;        // per output pixel
  std::vector<int> count;
  std::vector<double> weights;  // flattened [out, max_taps]
  int max_taps = 0;
};

// PIL ImagingResampleHorizontal weight computation (antialias: support
// scaled by the downscale factor).
FilterTaps make_taps(int in_size, int out_size) {
  FilterTaps t;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;  // bicubic support = 2
  t.max_taps = int(std::ceil(support)) * 2 + 1;
  t.xmin.resize(out_size);
  t.count.resize(out_size);
  t.weights.assign(size_t(out_size) * t.max_taps, 0.0);
  for (int i = 0; i < out_size; i++) {
    double center = (i + 0.5) * scale;
    int xlo = int(center - support + 0.5);
    int xhi = int(center + support + 0.5);
    if (xlo < 0) xlo = 0;
    if (xhi > in_size) xhi = in_size;
    double sum = 0.0;
    int k = 0;
    for (int x = xlo; x < xhi; x++, k++) {
      double w = cubic((x + 0.5 - center) / filterscale);
      t.weights[size_t(i) * t.max_taps + k] = w;
      sum += w;
    }
    if (sum != 0.0)
      for (int j = 0; j < k; j++) t.weights[size_t(i) * t.max_taps + j] /= sum;
    t.xmin[i] = xlo;
    t.count[i] = k;
  }
  return t;
}

// Fixed-point quantization of the tap weights — exactly Pillow's
// normalize_coeffs_8bpc (Resample.c): 22-bit precision, symmetric rounding.
// Running the whole resample in int32 over uint8 rows is both bit-exact with
// PIL and ~4x faster than the previous double-precision float path on the
// single host core this environment provides.
constexpr int kPrecisionBits = 32 - 8 - 2;

struct IntTaps {
  std::vector<int> xmin;
  std::vector<int> count;
  std::vector<int32_t> weights;  // flattened [out, max_taps]
  int max_taps = 0;
};

IntTaps quantize_taps(const FilterTaps& t) {
  IntTaps q;
  q.xmin = t.xmin;
  q.count = t.count;
  q.max_taps = t.max_taps;
  q.weights.resize(t.weights.size());
  for (size_t i = 0; i < t.weights.size(); i++) {
    double w = t.weights[i] * (1 << kPrecisionBits);
    q.weights[i] = int32_t(w < 0 ? w - 0.5 : w + 0.5);
  }
  return q;
}

// Pillow's clip8: shift out the precision bits with saturation.
inline uint8_t clip8(int32_t in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return uint8_t(in >> kPrecisionBits);
}

// Resize (h_in, w_in, c) uint8 buffer to (out, out, c): separable
// horizontal-then-vertical passes, int32 accumulation, uint8 rounding after
// each pass — bit-for-bit Pillow BICUBIC (antialiased) semantics.
//
// The horizontal pass dominates (it runs over all h_in source rows; the
// vertical pass only over out_size result rows) and its RGB tap loop defeats
// auto-vectorization (3-byte stride, variable tap count). With SSE4.1 each
// tap becomes one 4-lane epi32 multiply-accumulate over an RGBX pixel —
// identical int32 arithmetic to the scalar path (weights exceed int16 at
// Pillow's 22-bit precision, so epi32 mullo, not madd), hence bit-exact.
// Measured on the single host core: 3.7 → ~2 ms/img at 352² from ~0.63 MP
// COD10K sources.
void resize_bicubic_u8(const uint8_t* in, int w_in, int h_in, int c,
                       int out_size, uint8_t* out) {
  IntTaps tx = quantize_taps(make_taps(w_in, out_size));
  IntTaps ty = quantize_taps(make_taps(h_in, out_size));
  const int32_t half = 1 << (kPrecisionBits - 1);

  // Horizontal pass: (h_in, out_size, c)
  std::vector<uint8_t> tmp(size_t(h_in) * out_size * c);
#ifdef __SSE4_1__
  if (c == 3) {
    // One row of RGBX-expanded pixels, refreshed per source row: the 4-byte
    // stride lets each tap load one aligned-enough 32-bit lane set.
    std::vector<uint8_t> row4(size_t(w_in) * 4 + 4);
    const __m128i vhalf = _mm_set1_epi32(half);
    for (int y = 0; y < h_in; y++) {
      const uint8_t* row = in + size_t(y) * w_in * 3;
      for (int x = 0; x < w_in; x++) {
        row4[x * 4] = row[x * 3];
        row4[x * 4 + 1] = row[x * 3 + 1];
        row4[x * 4 + 2] = row[x * 3 + 2];
      }
      uint8_t* trow = tmp.data() + size_t(y) * out_size * 3;
      for (int i = 0; i < out_size; i++) {
        const int32_t* wts = tx.weights.data() + size_t(i) * tx.max_taps;
        const uint8_t* p = row4.data() + size_t(tx.xmin[i]) * 4;
        __m128i acc = vhalf;
        int k = 0;
        const int n = tx.count[i];
        for (; k + 2 <= n; k += 2, p += 8) {
          // two taps per iteration: unpack 2 RGBX pixels to 2x4 epi32
          __m128i px2 = _mm_loadl_epi64((const __m128i*)p);
          __m128i lo = _mm_cvtepu8_epi32(px2);
          __m128i hi = _mm_cvtepu8_epi32(_mm_srli_si128(px2, 4));
          acc = _mm_add_epi32(acc, _mm_mullo_epi32(lo, _mm_set1_epi32(wts[k])));
          acc = _mm_add_epi32(acc,
                              _mm_mullo_epi32(hi, _mm_set1_epi32(wts[k + 1])));
        }
        if (k < n) {
          __m128i px = _mm_cvtepu8_epi32(_mm_cvtsi32_si128(
              *(const int*)p));
          acc = _mm_add_epi32(acc, _mm_mullo_epi32(px, _mm_set1_epi32(wts[k])));
        }
        alignas(16) int32_t s[4];
        _mm_store_si128((__m128i*)s, acc);
        trow[i * 3] = clip8(s[0]);
        trow[i * 3 + 1] = clip8(s[1]);
        trow[i * 3 + 2] = clip8(s[2]);
      }
    }
  } else
#endif
  for (int y = 0; y < h_in; y++) {
    const uint8_t* row = in + size_t(y) * w_in * c;
    uint8_t* trow = tmp.data() + size_t(y) * out_size * c;
    if (c == 3) {
      for (int i = 0; i < out_size; i++) {
        const int32_t* wts = tx.weights.data() + size_t(i) * tx.max_taps;
        const uint8_t* p = row + tx.xmin[i] * 3;
        int32_t s0 = half, s1 = half, s2 = half;
        for (int k = 0; k < tx.count[i]; k++, p += 3) {
          const int32_t w = wts[k];
          s0 += p[0] * w;
          s1 += p[1] * w;
          s2 += p[2] * w;
        }
        trow[i * 3] = clip8(s0);
        trow[i * 3 + 1] = clip8(s1);
        trow[i * 3 + 2] = clip8(s2);
      }
    } else {
      for (int i = 0; i < out_size; i++) {
        const int32_t* wts = tx.weights.data() + size_t(i) * tx.max_taps;
        const uint8_t* p = row + tx.xmin[i];
        int32_t s = half;
        for (int k = 0; k < tx.count[i]; k++) s += p[k] * wts[k];
        trow[i] = clip8(s);
      }
    }
  }

  // Vertical pass: tap-outer row accumulation (contiguous, vectorizable).
  const int rowlen = out_size * c;
  std::vector<int32_t> acc(rowlen);
  for (int i = 0; i < out_size; i++) {
    const int32_t* wts = ty.weights.data() + size_t(i) * ty.max_taps;
    for (int j = 0; j < rowlen; j++) acc[j] = half;
    for (int k = 0; k < ty.count[i]; k++) {
      const uint8_t* trow = tmp.data() + size_t(ty.xmin[i] + k) * rowlen;
      const int32_t w = wts[k];
      for (int j = 0; j < rowlen; j++) acc[j] += trow[j] * w;
    }
    uint8_t* orow = out + size_t(i) * rowlen;
    for (int j = 0; j < rowlen; j++) orow[j] = clip8(acc[j]);
  }
}

// Decode → channel shape-up → PIL-exact resize, emitting uint8 pixels.
int load_resized_u8(const char* path, int size, bool gray, int draft,
                    unsigned char* out) {
  Image img;
  if (!decode_file(path, &img, draft ? size : 0)) return 1;

  int c = gray ? 1 : 3;
  const uint8_t* src = img.data.data();
  std::vector<uint8_t> conv;
  if (gray && img.c == 3) {
    conv.resize(size_t(img.w) * img.h);
    for (size_t i = 0; i < conv.size(); i++)
      conv[i] = to_gray(img.data[i * 3], img.data[i * 3 + 1], img.data[i * 3 + 2]);
    src = conv.data();
  } else if (!gray && img.c == 1) {
    conv.resize(size_t(img.w) * img.h * 3);
    for (size_t i = 0; i < size_t(img.w) * img.h; i++)
      conv[i * 3] = conv[i * 3 + 1] = conv[i * 3 + 2] = img.data[i];
    src = conv.data();
  }
  resize_bicubic_u8(src, img.w, img.h, c, size, out);
  return 0;
}

int load_one(const char* path, int size, bool gray, float* out) {
  int c = gray ? 1 : 3;
  std::vector<uint8_t> px(size_t(size) * size * c);
  if (load_resized_u8(path, size, gray, /*draft=*/0, px.data())) return 1;
  for (size_t i = 0; i < px.size(); i++) out[i] = px[i] / 255.0f;
  return 0;
}

// uint8 variant: the natural feed for the device-side normalize
// (ops/image.py), skipping the float conversion and shrinking the host
// buffer 4x.
int load_one_u8(const char* path, int size, bool gray, unsigned char* out) {
  return load_resized_u8(path, size, gray, /*draft=*/0, out);
}

}  // namespace

extern "C" {

// Decode + resize one image. out must hold size*size*(gray?1:3) floats.
// Returns 0 on success.
int cmt_load_image(const char* path, int size, int gray, float* out) {
  return load_one(path, size, gray != 0, out);
}

// Threaded batch load. paths: array of n C strings. out: contiguous
// (n, size, size, c). status: per-image 0/1. Returns count of failures.
int cmt_load_batch(const char** paths, int n, int size, int gray,
                   float* out, int* status, int n_threads) {
  int c = gray ? 1 : 3;
  size_t stride = size_t(size) * size * c;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_one(paths[i], size, gray != 0, out + stride * i);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

// uint8 single-image load. out must hold size*size*(gray?1:3) bytes.
int cmt_load_image_u8(const char* path, int size, int gray,
                      unsigned char* out) {
  return load_one_u8(path, size, gray != 0, out);
}

// Threaded uint8 batch load — same contract as cmt_load_batch but the
// output buffer is (n, size, size, c) uint8. draft != 0 decodes JPEGs at
// the smallest M/8 DCT scale covering `size` (≈2x faster end-to-end;
// PNG inputs are unaffected). draft=0 is bit-exact with PIL.
int cmt_load_batch_u8_draft(const char** paths, int n, int size, int gray,
                            int draft, unsigned char* out, int* status,
                            int n_threads) {
  int c = gray ? 1 : 3;
  size_t stride = size_t(size) * size * c;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_resized_u8(paths[i], size, gray != 0, draft, out + stride * i);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

int cmt_load_batch_u8(const char** paths, int n, int size, int gray,
                      unsigned char* out, int* status, int n_threads) {
  return cmt_load_batch_u8_draft(paths, n, size, gray, /*draft=*/0, out,
                                 status, n_threads);
}

}  // extern "C"
