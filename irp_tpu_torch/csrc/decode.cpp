// Native batch JPEG decoder + antialiased resize for the port's input
// pipeline: the port's own copy of the JAX package's native/decode.cpp,
// the same C ABI and, byte for byte, the same output.
//
// Decode N JPEGs -> RGB -> triangle-filter (PIL-BILINEAR-family) resize
// to out_size x out_size uint8, across a pthread pool, exposed through a
// C ABI for ctypes.  Host code: the reference decodes on the host too.
//
// Built at first use by irp_tpu_torch/data/jpeg.py:
//   g++ -O3 -march=x86-64-v2 -fPIC -shared -std=c++17 -Wall decode.cpp
//       -o build/irp_tpu_torch/libdecode-<digest>.so -ljpeg -lpthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG to RGB. Returns true on success; out is resized.
bool decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>* out,
                 int* width, int* height) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;  // force RGB (gray/CMYK converted)
  jpeg_start_decompress(&cinfo);
  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const int stride = cinfo.output_width * cinfo.output_components;
  out->resize(static_cast<size_t>(stride) * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Triangle-filter (antialiased bilinear) coefficients for 1-D resampling
// from in_size to out_size over the full extent — the same filter family
// PIL's BILINEAR resize uses.
struct Taps {
  std::vector<int> start;        // first source index per output pixel
  std::vector<int> count;        // taps per output pixel
  std::vector<float> weights;    // flattened [out][count]
  int max_count = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  const double scale = static_cast<double>(in_size) / out_size;
  const double support = std::max(scale, 1.0);
  const int max_taps = static_cast<int>(std::ceil(support)) * 2 + 2;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.weights.resize(static_cast<size_t>(out_size) * max_taps, 0.0f);
  t.max_count = max_taps;
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale - 0.5;
    int lo = static_cast<int>(std::floor(center - support));
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size - 1);
    double sum = 0.0;
    std::vector<double> w(hi - lo + 1, 0.0);
    for (int s = lo; s <= hi; ++s) {
      const double d = std::abs(s - center) / support;
      const double v = d < 1.0 ? 1.0 - d : 0.0;
      w[s - lo] = v;
      sum += v;
    }
    if (sum <= 0.0) {  // degenerate: nearest
      lo = std::min(std::max(static_cast<int>(std::lround(center)), 0),
                    in_size - 1);
      w.assign(1, 1.0);
      hi = lo;
      sum = 1.0;
    }
    t.start[o] = lo;
    t.count[o] = hi - lo + 1;
    for (int i = 0; i < t.count[o]; ++i) {
      t.weights[static_cast<size_t>(o) * max_taps + i] =
          static_cast<float>(w[i] / sum);
    }
  }
  return t;
}

// Per-worker scratch: taps cached across same-sized images (a dataset is
// typically dominated by a few sizes) + reusable float buffers.
struct ResizeScratch {
  int tx_in = -1, ty_in = -1, out = -1;
  Taps tx, ty;
  std::vector<float> tmp;   // (h, out, 3) horizontal-pass buffer
  std::vector<float> frow;  // (w * 3) source row as float
  std::vector<float> acc;   // (out * 3) vertical accumulator
};

// Separable resize RGB (h,w) -> (out,out) uint8.
void resize_rgb(const uint8_t* src, int w, int h, uint8_t* dst,
                int out_size, ResizeScratch* sc) {
  if (sc->tx_in != w || sc->out != out_size) sc->tx = make_taps(w, out_size);
  if (sc->ty_in != h || sc->out != out_size) sc->ty = make_taps(h, out_size);
  sc->tx_in = w;
  sc->ty_in = h;
  sc->out = out_size;
  const Taps& tx = sc->tx;
  const Taps& ty = sc->ty;
  sc->tmp.resize(static_cast<size_t>(h) * out_size * 3);
  sc->frow.resize(static_cast<size_t>(w) * 3);
  sc->acc.resize(static_cast<size_t>(out_size) * 3);

  // pass 1: horizontal -> (h, out, 3) float.  The u8 row is converted to
  // float once so the tap loop is pure float FMAs the compiler can
  // vectorize over the 3 channels.
  float* const frow = sc->frow.data();
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w * 3; ++x) frow[x] = row[x];
    float* trow = sc->tmp.data() + static_cast<size_t>(y) * out_size * 3;
    for (int o = 0; o < out_size; ++o) {
      const float* wts =
          tx.weights.data() + static_cast<size_t>(o) * tx.max_count;
      float r = 0, g = 0, b = 0;
      const int s0 = tx.start[o];
      const int cnt = tx.count[o];
      const float* px = frow + static_cast<size_t>(s0) * 3;
      for (int i = 0; i < cnt; ++i, px += 3) {
        const float wgt = wts[i];
        r += wgt * px[0];
        g += wgt * px[1];
        b += wgt * px[2];
      }
      trow[o * 3 + 0] = r;
      trow[o * 3 + 1] = g;
      trow[o * 3 + 2] = b;
    }
  }
  // pass 2: vertical -> (out, out, 3) uint8.  Loop-interchanged: each tap
  // streams one contiguous tmp row into the accumulator (vectorizes to
  // full-width FMAs instead of a strided tap loop per pixel).
  const int row_elems = out_size * 3;
  float* const acc = sc->acc.data();
  for (int o = 0; o < out_size; ++o) {
    const float* wts =
        ty.weights.data() + static_cast<size_t>(o) * ty.max_count;
    const int s0 = ty.start[o];
    const int cnt = ty.count[o];
    std::memset(acc, 0, sizeof(float) * row_elems);
    for (int i = 0; i < cnt; ++i) {
      const float wgt = wts[i];
      const float* trow =
          sc->tmp.data() + static_cast<size_t>(s0 + i) * row_elems;
      for (int x = 0; x < row_elems; ++x) acc[x] += wgt * trow[x];
    }
    uint8_t* drow = dst + static_cast<size_t>(o) * row_elems;
    for (int x = 0; x < row_elems; ++x) {
      const int v = static_cast<int>(std::lround(acc[x]));
      drow[x] = static_cast<uint8_t>(std::min(std::max(v, 0), 255));
    }
  }
}

}  // namespace

extern "C" {

// Decode + resize a batch. jpegs: n pointers; sizes: n byte counts;
// out: (n, out_size, out_size, 3) uint8 buffer; ok: n int flags (1 =
// decoded, 0 = failed — the slot is left UNTOUCHED: the caller may
// pre-fill `out` (e.g. a cache being rebuilt in place) and handles
// failed rows itself via the ok flags; passing an uninitialized
// buffer means failed rows contain garbage).  Returns #failures.
int irp_decode_resize_batch(const uint8_t** jpegs, const long* sizes, int n,
                            uint8_t* out, int out_size, int* ok,
                            int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t img_bytes =
      static_cast<size_t>(out_size) * out_size * 3;

  auto worker = [&]() {
    std::vector<uint8_t> raw;
    ResizeScratch scratch;
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      int w = 0, h = 0;
      uint8_t* dst = out + static_cast<size_t>(i) * img_bytes;
      if (decode_jpeg(jpegs[i], static_cast<size_t>(sizes[i]), &raw, &w,
                      &h) &&
          w > 0 && h > 0) {
        if (w == out_size && h == out_size) {
          // identity resize: running the float tap pipeline on an
          // already-target-size image wastes ~40% of a 1-thread build
          std::memcpy(dst, raw.data(), img_bytes);
        } else {
          resize_rgb(raw.data(), w, h, dst, out_size, &scratch);
        }
        ok[i] = 1;
      } else {
        // Leave the failed row's bytes untouched: the Python contract
        // (jpeg.py::decode_batch_native) lets callers pre-fill `out`
        // with fallback pixels and overwrite only decodable rows.  The
        // out=None path hands us a zero-initialized array, so fresh
        // buffers still read as black for failed rows.
        ok[i] = 0;
        failures.fetch_add(1);
      }
    }
  };

  const int threads = std::max(
      1, std::min(n_threads > 0
                      ? n_threads
                      : static_cast<int>(
                            std::thread::hardware_concurrency()),
                  n));
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

int irp_decoder_version() { return 1; }

}  // extern "C"
