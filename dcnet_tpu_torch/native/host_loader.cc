// The port's host loader: decode -> letterbox -> normalize for a whole clip
// or video in one call, in an in-process thread pool, bound through ctypes
// (dcnet_tpu_torch/native/__init__.py). The caller's thread holds no GIL
// while it runs (ctypes releases it), and the normalized float32 NHWC frames
// are written straight into the caller's buffer.
//
// The letterbox is a C++ copy of the port's numpy path, not cv::resize:
// transforms.resize(..., "area") / letterbox / normalize_image in
// dcnet_tpu_torch/data/transforms.py, which equal cv2 5.0 pixel for pixel.
// Each step keeps that code's arithmetic, so the two paths agree bit for bit:
//   - shrinking on both axes: cv2's INTER_AREA float32 tables
//     (transforms._area_table), summed along x and then y in the same order;
//     at integer scales the box sums, (sum + 2) >> 2 for 2 x 2, else
//     rint(float(sum) * float(1 / area));
//   - an axis that grows: cv2's 11-bit fixed-point bilinear with INTER_AREA's
//     offsets (transforms._linear_table / _resize_linear);
//   - rounding half to even (std::nearbyint in the default rounding mode),
//     the border stored as rint(color) (124, 116, 104), and
//     ((p / 255) - mean) / std in float32, per channel through a table of
//     the 256 values.
// It is compiled with -ffp-contract=off, so that no FMA changes a rounding.
//
// Readers, by what the build found (native/__init__.py passes the macros):
//   .npy    always: v1-v3 header, uint8, (H, W), (H, W, 1) or (H, W, 3), C or
//           Fortran order (data/vid.py::read_image's arrays);
//   JPEG    through libjpeg where jpeglib.h was found (DCNET_HAVE_JPEG);
//   others  through OpenCV's imdecode where its opencv4 headers were found
//           (DCNET_HAVE_OPENCV), which also takes the JPEGs libjpeg refuses.
// Files are told apart by their first bytes. Gray frames become three equal
// channels, as read_image makes them.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

#ifdef DCNET_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif
#ifdef DCNET_HAVE_OPENCV
#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#endif

namespace {

constexpr int kAbiVersion = 1;
constexpr int kFormatNpy = 1, kFormatJpeg = 2, kFormatOpenCV = 4;
constexpr int kCoefOne = 1 << 11;  // cv2's INTER_RESIZE_COEF_BITS

struct Image {  // uint8 RGB, row-major (h, w, 3)
  int h = 0, w = 0;
  std::vector<uint8_t> px;
};

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = std::fseek(f, 0, SEEK_END) == 0;
  const long n = ok ? std::ftell(f) : -1;
  ok = n > 0 && std::fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize((size_t)n);
    ok = std::fread(buf->data(), 1, (size_t)n, f) == (size_t)n;
  }
  std::fclose(f);
  return ok;
}

// ---- .npy ------------------------------------------------------------------

// The text after `'key':` in a header dict, with leading spaces skipped.
const char* npy_field(const std::string& header, const char* key) {
  const size_t at = header.find(key);
  if (at == std::string::npos) return nullptr;
  const char* p = header.c_str() + at + std::strlen(key);
  while (*p == ' ') ++p;
  return p;
}

// An RGB array in C order keeps the file's buffer: its pixels are moved
// down over the header, with no second buffer.
bool parse_npy(std::vector<uint8_t>& buf, Image* out) {
  static const uint8_t kMagic[6] = {0x93, 'N', 'U', 'M', 'P', 'Y'};
  if (buf.size() < 10 || std::memcmp(buf.data(), kMagic, 6) != 0) return false;
  const int major = buf[6];
  size_t start, len;
  if (major == 1) {
    len = buf[8] | (size_t)buf[9] << 8;
    start = 10;
  } else if ((major == 2 || major == 3) && buf.size() >= 12) {
    len = buf[8] | (size_t)buf[9] << 8 | (size_t)buf[10] << 16 | (size_t)buf[11] << 24;
    start = 12;
  } else {
    return false;
  }
  if (start + len > buf.size()) return false;
  const std::string header(reinterpret_cast<const char*>(buf.data()) + start, len);
  const char* descr = npy_field(header, "'descr':");
  if (!descr || !(std::strncmp(descr, "'|u1'", 5) == 0 || std::strncmp(descr, "'<u1'", 5) == 0 ||
                  std::strncmp(descr, "'>u1'", 5) == 0 || std::strncmp(descr, "'u1'", 4) == 0))
    return false;
  const char* order = npy_field(header, "'fortran_order':");
  if (!order) return false;
  const bool fortran = std::strncmp(order, "True", 4) == 0;
  if (!fortran && std::strncmp(order, "False", 5) != 0) return false;
  const char* shape = npy_field(header, "'shape':");
  if (!shape || *shape != '(') return false;
  long dims[4];
  int nd = 0;
  for (const char* p = shape + 1; *p != ')';) {
    if (*p == ' ' || *p == ',') { ++p; continue; }
    char* end;
    const long v = std::strtol(p, &end, 10);
    if (end == p || nd == 4 || v < 0) return false;
    dims[nd++] = v;
    p = end;
  }
  const long c = nd == 3 ? dims[2] : 1;
  if (!(nd == 2 || (nd == 3 && (c == 1 || c == 3))) || dims[0] < 1 || dims[1] < 1 ||
      dims[0] > (1 << 20) || dims[1] > (1 << 20))
    return false;
  const long h = dims[0], w = dims[1];
  const size_t data = start + len;
  if (buf.size() - data < (size_t)(h * w * c)) return false;
  out->h = (int)h;
  out->w = (int)w;
  if (!fortran && c == 3) {
    std::memmove(buf.data(), buf.data() + data, (size_t)(h * w * 3));
    buf.resize((size_t)(h * w * 3));
    out->px = std::move(buf);
    return true;
  }
  const uint8_t* src = buf.data() + data;
  out->px.resize((size_t)h * w * 3);
  for (long y = 0; y < h; ++y) {
    for (long x = 0; x < w; ++x) {
      uint8_t* o = &out->px[((size_t)y * w + x) * 3];
      for (long ch = 0; ch < 3; ++ch) {
        const long k = c == 3 ? ch : 0;
        o[ch] = fortran ? src[y + x * h + k * h * w] : src[(y * w + x) * c + k];
      }
    }
  }
  return true;
}

// ---- JPEG (libjpeg) ----------------------------------------------------------

#ifdef DCNET_HAVE_JPEG
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) { longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1); }
void jpeg_silent(j_common_ptr, int) {}
void jpeg_silent_msg(j_common_ptr) {}

// RGB straight from libjpeg (ISLOW IDCT, the default); a gray JPEG is
// decoded as gray into the start of each row and copied out to the three
// channels from the row's end backwards. Nothing between setjmp and a
// longjmp lives in a local that the jump could leave stale.
bool decode_jpeg(const std::vector<uint8_t>& buf, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  err.mgr.emit_message = jpeg_silent;
  err.mgr.output_message = jpeg_silent_msg;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf.data()), (unsigned long)buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  const bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = (int)cinfo.output_height;
  out->w = (int)cinfo.output_width;
  out->px.resize((size_t)out->h * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* o = &out->px[(size_t)cinfo.output_scanline * out->w * 3];
    jpeg_read_scanlines(&cinfo, &o, 1);
    if (gray)
      for (int x = out->w - 1; x >= 0; --x) o[3 * x + 2] = o[3 * x + 1] = o[3 * x] = o[x];
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}
#endif

// ---- other formats (OpenCV's imdecode) ---------------------------------------

#ifdef DCNET_HAVE_OPENCV
bool decode_opencv(std::vector<uint8_t>& buf, Image* out) {
  const cv::Mat bgr = cv::imdecode(cv::Mat(1, (int)buf.size(), CV_8UC1, buf.data()),
                                   cv::IMREAD_COLOR);
  if (bgr.empty() || bgr.type() != CV_8UC3) return false;
  out->h = bgr.rows;
  out->w = bgr.cols;
  out->px.resize((size_t)bgr.rows * bgr.cols * 3);
  for (int y = 0; y < bgr.rows; ++y) {
    const uint8_t* s = bgr.ptr<uint8_t>(y);
    uint8_t* o = &out->px[(size_t)y * bgr.cols * 3];
    for (int x = 0; x < bgr.cols; ++x) {
      o[3 * x] = s[3 * x + 2];
      o[3 * x + 1] = s[3 * x + 1];
      o[3 * x + 2] = s[3 * x];
    }
  }
  return true;
}
#endif

bool decode_rgb(const char* path, Image* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return false;
  if (buf[0] == 0x93) return parse_npy(buf, out);
#ifdef DCNET_HAVE_JPEG
  if (buf.size() > 3 && buf[0] == 0xFF && buf[1] == 0xD8 && decode_jpeg(buf, out)) return true;
#endif
#ifdef DCNET_HAVE_OPENCV
  return decode_opencv(buf, out);
#else
  return false;
#endif
}

// ---- the letterbox: transforms.resize(..., "area") and letterbox ---------------

// Python's round(): half to even (the default rounding mode).
inline int py_round(double v) { return (int)std::nearbyint(v); }

// rint(v) clipped to [0, 255]: v + 1.5 * 2^23 rounds v half to even to an
// integer in the default rounding mode wherever |v| < 2^22 (a libm call
// per pixel cost more than the resize's sums); larger values saturate.
inline uint8_t saturate(float v) {
  constexpr float kMagic = 12582912.0f;
  const float r = std::fabs(v) < 4194304.0f ? (v + kMagic) - kMagic : v;
  return (uint8_t)std::min(std::max(r, 0.f), 255.f);
}

struct AreaTerm {
  int d, s;
  float a;
};

// transforms._area_table: cv2's computeResizeAreaTab, in its order.
std::vector<AreaTerm> area_table(int ssize, int dsize, double scale) {
  std::vector<AreaTerm> t;
  for (int d = 0; d < dsize; ++d) {
    const double f1 = d * scale, f2 = f1 + scale;
    const double cell = std::min(scale, ssize - f1);
    int s1 = (int)std::ceil(f1), s2 = (int)std::floor(f2);
    s2 = std::min(s2, ssize - 1);
    s1 = std::min(s1, s2);
    if (s1 - f1 > 1e-3) t.push_back({d, s1 - 1, (float)((s1 - f1) / cell)});
    for (int s = s1; s < s2; ++s) t.push_back({d, s, (float)(1.0 / cell)});
    if (f2 - s2 > 1e-3) t.push_back({d, s2, (float)(std::min(std::min(f2 - s2, 1.0), cell) / cell)});
  }
  return t;
}

// transforms._resize_area: along x into float32 rows, then along y, each
// destination summed from 0 in its table's order.
void resize_area(const Image& src, int w, int h, double sx, double sy, uint8_t* dst) {
  const std::vector<AreaTerm> xt = area_table(src.w, w, sx), yt = area_table(src.h, h, sy);
  std::vector<size_t> xend(w);  // the end of each destination's terms in xt
  for (size_t k = 0; k < xt.size(); ++k) xend[xt[k].d] = k + 1;
  std::vector<float> rows((size_t)src.h * w * 3), f((size_t)src.w * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* s = &src.px[(size_t)y * src.w * 3];
    for (int i = 0; i < src.w * 3; ++i) f[i] = (float)s[i];  // a row's floats, once
    float* r = &rows[(size_t)y * w * 3];
    size_t k = 0;
    for (int d = 0; d < w; ++d) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (; k < xend[d]; ++k) {
        const float* p = &f[(size_t)xt[k].s * 3];
        const float a = xt[k].a;
        a0 = a0 + p[0] * a;
        a1 = a1 + p[1] * a;
        a2 = a2 + p[2] * a;
      }
      r[d * 3] = a0;
      r[d * 3 + 1] = a1;
      r[d * 3 + 2] = a2;
    }
  }
  std::vector<float> acc((size_t)w * 3);
  size_t k = 0;
  for (int d = 0; d < h; ++d) {
    std::fill(acc.begin(), acc.end(), 0.f);
    for (; k < yt.size() && yt[k].d == d; ++k) {
      const float* r = &rows[(size_t)yt[k].s * w * 3];
      const float a = yt[k].a;
      for (int i = 0; i < w * 3; ++i) acc[i] = acc[i] + a * r[i];
    }
    for (int i = 0; i < w * 3; ++i) dst[(size_t)d * w * 3 + i] = saturate(acc[i]);
  }
}

// transforms._resize_area_integer: cv2's fast path at integer scales.
void resize_area_integer(const Image& src, int w, int h, int kx, int ky, uint8_t* dst) {
  const float inv = (float)(1.0 / (kx * ky));
  const size_t pitch = (size_t)src.w * 3;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = &src.px[(size_t)y * ky * pitch];
    uint8_t* o = dst + (size_t)y * w * 3;
    for (int x = 0; x < w; ++x) {
      int s0 = 0, s1 = 0, s2 = 0;
      for (int j = 0; j < ky; ++j) {
        const uint8_t* p = row + j * pitch + (size_t)x * kx * 3;
        for (int i = 0; i < kx * 3; i += 3) {
          s0 += p[i];
          s1 += p[i + 1];
          s2 += p[i + 2];
        }
      }
      const int sum[3] = {s0, s1, s2};
      for (int c = 0; c < 3; ++c)
        o[x * 3 + c] = kx == 2 && ky == 2 ? (uint8_t)((sum[c] + 2) >> 2)
                                          : saturate((float)sum[c] * inv);
    }
  }
}

// transforms._linear_table with area=True: source offsets and 11-bit weights.
void linear_table(int ssize, int dsize, double scale, double inv_scale, bool clamp,
                  std::vector<int>* ofs, std::vector<int>* w0, std::vector<int>* w1) {
  for (int d = 0; d < dsize; ++d) {
    int s = (int)std::floor(d * scale);
    float f = (float)((d + 1) - (s + 1) * inv_scale);
    f = f <= 0 ? 0.f : f - std::floor(f);
    if (clamp && s < 0) { f = 0.f; s = 0; }
    if (clamp && s >= ssize - 1) { f = 0.f; s = ssize - 1; }
    ofs->push_back(s);
    w0->push_back((int)std::nearbyint((1.f - f) * (float)kCoefOne));
    w1->push_back((int)std::nearbyint(f * (float)kCoefOne));
  }
}

// transforms._resize_linear (area=True): integer sums along x, then the
// vertical blend as cv2's vector code rounds it.
void resize_linear(const Image& src, int w, int h, double sx, double sy, uint8_t* dst) {
  std::vector<int> xo, xw0, xw1, yo, yw0, yw1;
  linear_table(src.w, w, sx, (double)w / src.w, true, &xo, &xw0, &xw1);
  linear_table(src.h, h, sy, (double)h / src.h, false, &yo, &yw0, &yw1);
  std::vector<int> rows((size_t)src.h * w * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* s = &src.px[(size_t)y * src.w * 3];
    int* r = &rows[(size_t)y * w * 3];
    for (int x = 0; x < w; ++x) {
      const int x0 = xo[x], x1 = std::min(x0 + 1, src.w - 1);
      for (int c = 0; c < 3; ++c) r[x * 3 + c] = s[x0 * 3 + c] * xw0[x] + s[x1 * 3 + c] * xw1[x];
    }
  }
  for (int d = 0; d < h; ++d) {
    const int* r0 = &rows[(size_t)std::min(std::max(yo[d], 0), src.h - 1) * w * 3];
    const int* r1 = &rows[(size_t)std::min(std::max(yo[d] + 1, 0), src.h - 1) * w * 3];
    const int b0 = yw0[d], b1 = yw1[d];
    for (int i = 0; i < w * 3; ++i) {
      const int v = ((((r0[i] >> 4) * b0) >> 16) + (((r1[i] >> 4) * b1) >> 16) + 2) >> 2;
      dst[(size_t)d * w * 3 + i] = (uint8_t)std::min(std::max(v, 0), 255);
    }
  }
}

// transforms.resize(img, (w, h), "area") of a uint8 RGB image.
void resize_area_any(const Image& src, int w, int h, uint8_t* dst) {
  const double sx = 1.0 / ((double)w / src.w), sy = 1.0 / ((double)h / src.h);
  if (w == src.w && h == src.h) {
    std::memcpy(dst, src.px.data(), src.px.size());
  } else if (sx >= 1 && sy >= 1) {
    const int kx = py_round(sx), ky = py_round(sy);
    const double eps = 2.220446049250313e-16;  // np.finfo(float).eps
    if (std::fabs(sx - kx) < eps && std::fabs(sy - ky) < eps)
      resize_area_integer(src, w, h, kx, ky, dst);
    else
      resize_area(src, w, h, sx, sy, dst);
  } else {
    resize_linear(src, w, h, sx, sy, dst);
  }
}

struct Geom {
  int new_w, new_h, top, left;
  double ratio, dw, dh;
};

// transforms.letterbox's geometry.
Geom letterbox_geom(int h, int w, int size) {
  Geom g;
  g.ratio = (double)size / (double)std::max(h, w);
  g.new_w = py_round(w * g.ratio);
  g.new_h = py_round(h * g.ratio);
  g.dw = (size - g.new_w) / 2.0;
  g.dh = (size - g.new_h) / 2.0;
  g.top = py_round(g.dh - 0.1);
  g.left = py_round(g.dw - 0.1);
  return g;
}

// The letterboxed, normalized frame: the resized image at (top, left), the
// stored border colour around it, each value through its channel's table.
// False where a side would shrink to no pixel (the numpy path divides by
// zero there).
bool letterbox_normalize(const Image& img, int size, const float (*lut)[256],
                         const uint8_t* border, float* out, Geom* g) {
  *g = letterbox_geom(img.h, img.w, size);
  if (g->new_w < 1 || g->new_h < 1) return false;
  std::vector<uint8_t> small((size_t)g->new_h * g->new_w * 3);
  resize_area_any(img, g->new_w, g->new_h, small.data());
  const float pad[3] = {lut[0][border[0]], lut[1][border[1]], lut[2][border[2]]};
  for (int r = 0; r < size; ++r) {
    float* o = out + (size_t)r * size * 3;
    const int y = r - g->top;
    const bool row_in = y >= 0 && y < g->new_h;
    const int x0 = row_in ? g->left : size, x1 = row_in ? g->left + g->new_w : size;
    for (int x = 0; x < x0; ++x)
      for (int c = 0; c < 3; ++c) o[x * 3 + c] = pad[c];
    const uint8_t* p = row_in ? &small[(size_t)y * g->new_w * 3] : nullptr;
    for (int x = x0; x < x1; ++x, p += 3)
      for (int c = 0; c < 3; ++c) o[x * 3 + c] = lut[c][p[c]];
    for (int x = x1; x < size; ++x)
      for (int c = 0; c < 3; ++c) o[x * 3 + c] = pad[c];
  }
  return true;
}

void run_pool(int n, int num_threads, const std::function<void(int)>& fn) {
  const int workers = std::max(1, std::min(n, num_threads));
  if (workers == 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t)
    threads.emplace_back([&] {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  for (auto& th : threads) th.join();
}

struct DecodeBatch {
  std::vector<Image> images;
};

}  // namespace

extern "C" {

int dcnet_host_abi_version() { return kAbiVersion; }

// The formats this build reads: kFormatNpy | kFormatJpeg | kFormatOpenCV.
int dcnet_host_formats() {
  int f = kFormatNpy;
#ifdef DCNET_HAVE_JPEG
  f |= kFormatJpeg;
#endif
#ifdef DCNET_HAVE_OPENCV
  f |= kFormatOpenCV;
#endif
  return f;
}

// Decode, letterbox and normalize n frames into out (float32 [n, size, size,
// 3]), their geometry into ratios / dws / dhs (float64 [n]). mean and std
// are float[3], pad double[3] (the border colour before rounding), in RGB
// order.
// A frame that fails to decode (or shrinks to no pixel) has its slot zeroed, ratio 1, dw = dh = 0 and
// ok 0. Returns the number of failures.
int dcnet_decode_letterbox_batch(const char** paths, int n, int size, const float* mean,
                                 const float* std_, const double* pad, float* out,
                                 double* ratios, double* dws, double* dhs, unsigned char* ok,
                                 int num_threads) {
  float lut[3][256];
  uint8_t border[3];
  for (int c = 0; c < 3; ++c) {
    for (int v = 0; v < 256; ++v) lut[c][v] = ((float)v / 255.0f - mean[c]) / std_[c];
    border[c] = (uint8_t)std::min(std::max(std::nearbyint(pad[c]), 0.0), 255.0);
  }
  const size_t plane = (size_t)size * size * 3;
  std::atomic<int> failures{0};
  run_pool(n, num_threads, [&](int i) {
    float* dst = out + (size_t)i * plane;
    Image img;
    Geom g;
    if (!decode_rgb(paths[i], &img) || !letterbox_normalize(img, size, lut, border, dst, &g)) {
      std::memset(dst, 0, plane * sizeof(float));
      ratios[i] = 1.0;
      dws[i] = dhs[i] = 0.0;
      ok[i] = 0;
      failures.fetch_add(1);
      return;
    }
    ratios[i] = g.ratio;
    dws[i] = g.dw;
    dhs[i] = g.dh;
    ok[i] = 1;
  });
  return failures.load();
}

// Decode n frames to uint8 RGB in parallel (the augmenting paths, which
// transform the frames in Python). dims: int[2 n] of (h, w), (0, 0) for a
// failed decode. Returns a handle for dcnet_decode_batch_copy / _close.
void* dcnet_decode_batch_open(const char** paths, int n, int* dims, int num_threads) {
  auto* batch = new DecodeBatch();
  batch->images.resize(n);
  run_pool(n, num_threads, [&](int i) {
    Image& img = batch->images[i];
    if (!decode_rgb(paths[i], &img)) img = Image();
    dims[2 * i] = img.h;
    dims[2 * i + 1] = img.w;
  });
  return batch;
}

// Copy frame i into a caller's uint8 [h, w, 3] buffer; -1 if it failed.
int dcnet_decode_batch_copy(void* handle, int i, unsigned char* out) {
  auto* batch = static_cast<DecodeBatch*>(handle);
  if (i < 0 || i >= (int)batch->images.size() || batch->images[i].px.empty()) return -1;
  std::memcpy(out, batch->images[i].px.data(), batch->images[i].px.size());
  return 0;
}

void dcnet_decode_batch_close(void* handle) { delete static_cast<DecodeBatch*>(handle); }

}  // extern "C"
