// Native batch JPEG decode + resize for the host input pipeline (the
// port's copy of the JAX package's native/jpeg_decode.cc; the code below
// is that file's).
//
// Replaces the per-image work the reference does in Python/PIL inside
// torch DataLoader workers (reference dino_detector/dataset.py:55 decode,
// train.py:584-587 Resize) with a C++ path built directly on libjpeg:
//
//  - DCT-domain scaled decode with the full M/8 (M in 1..8) scale ladder.
//    cv2's IMREAD_REDUCED_* flags only have powers of two, so e.g. a 640px
//    JPEG resized to 224 must decode at 320px there; here it decodes at
//    3/8 = 240px: fewer IDCT columns and a cheaper resize.
//  - One malloc-free scanline loop straight into a reusable buffer, then a
//    separable bilinear resize (half-pixel centers) into the caller's
//    preallocated [N, H, W, 3] uint8 batch slab. Its pixels differ from
//    Pillow's resize (tests/test_torch_native.py states by how much).
//  - A std::thread pool for batch decode: the GIL is released at the
//    ctypes boundary, so the loader scales with cores without Python
//    worker processes.
//
// Error handling: libjpeg's error_exit longjmps back here; the failing
// image's status slot is set nonzero and the caller (data/coco.py)
// re-decodes that image with the next backend. Unsupported color spaces
// (CMYK) report failure the same way.
//
// Build: utils/host_lib.py runs g++ -O3 -std=c++17 -fPIC -shared ...
// -ljpeg -lpthread at first use.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void emit_nothing(j_common_ptr, int) {}
void output_nothing(j_common_ptr) {}

// Separable bilinear resize, RGB uint8, half-pixel centers
// (src_x = (dst_x + 0.5) * sw / dw - 0.5), edges clamped.
void resize_bilinear_rgb(const unsigned char* src, int sh, int sw,
                         unsigned char* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> xw(dw);
  const float sx = static_cast<float>(sw) / dw;
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    if (fx < 0) fx = 0;
    int ix = static_cast<int>(fx);
    if (ix > sw - 1) ix = sw - 1;
    x0[x] = ix;
    x1[x] = std::min(ix + 1, sw - 1);
    xw[x] = fx - ix;
  }
  // Horizontal pass into a float row pair, vertical blend per output row.
  std::vector<float> row_a(static_cast<size_t>(dw) * 3);
  std::vector<float> row_b(static_cast<size_t>(dw) * 3);
  int cached_a = -1, cached_b = -1;
  const float sy = static_cast<float>(sh) / dh;
  auto hpass = [&](int src_row, std::vector<float>& out) {
    const unsigned char* r = src + static_cast<size_t>(src_row) * sw * 3;
    for (int x = 0; x < dw; ++x) {
      const unsigned char* p0 = r + x0[x] * 3;
      const unsigned char* p1 = r + x1[x] * 3;
      const float w = xw[x];
      out[x * 3 + 0] = p0[0] + (p1[0] - p0[0]) * w;
      out[x * 3 + 1] = p0[1] + (p1[1] - p0[1]) * w;
      out[x * 3 + 2] = p0[2] + (p1[2] - p0[2]) * w;
    }
  };
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int iy = static_cast<int>(fy);
    if (iy > sh - 1) iy = sh - 1;
    const int iy1 = std::min(iy + 1, sh - 1);
    const float w = fy - iy;
    if (cached_a != iy) {
      if (cached_b == iy) {  // rows advance monotonically: reuse b as a
        std::swap(row_a, row_b);
        std::swap(cached_a, cached_b);
      } else {
        hpass(iy, row_a);
        cached_a = iy;
      }
    }
    if (cached_b != iy1) {
      hpass(iy1, row_b);
      cached_b = iy1;
    }
    unsigned char* d = dst + static_cast<size_t>(y) * dw * 3;
    for (int c = 0; c < dw * 3; ++c) {
      const float v = row_a[c] + (row_b[c] - row_a[c]) * w;
      d[c] = static_cast<unsigned char>(v + 0.5f);
    }
  }
}

// Decode one JPEG (already in memory) at the smallest M/8 scale that keeps
// both dimensions >= the target, convert to RGB, bilinear-resize into out.
int decode_buffer(const unsigned char* buf, size_t len, int out_h, int out_w,
                  unsigned char* out, std::vector<unsigned char>* scratch) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = err_exit;
  err.pub.emit_message = emit_nothing;
  err.pub.output_message = output_nothing;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK ||
      cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return 3;  // PIL fallback handles CMYK
  }
  cinfo.out_color_space = JCS_RGB;
  // Smallest M with ceil(dim * M / 8) >= target in both dims; M=8 if the
  // source is already smaller than the target (then we upsample).
  int m = 8;
  for (int cand = 1; cand <= 8; ++cand) {
    const long h = (static_cast<long>(cinfo.image_height) * cand + 7) / 8;
    const long w = (static_cast<long>(cinfo.image_width) * cand + 7) / 8;
    if (h >= out_h && w >= out_w) {
      m = cand;
      break;
    }
  }
  cinfo.scale_num = static_cast<unsigned>(m);
  cinfo.scale_denom = 8;
  cinfo.dct_method = JDCT_ISLOW;  // turbo SIMD path; matches PIL quality
  jpeg_start_decompress(&cinfo);
  const int sw = static_cast<int>(cinfo.output_width);
  const int sh = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3 || sw <= 0 || sh <= 0) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  scratch->resize(static_cast<size_t>(sh) * sw * 3);
  unsigned char* rows = scratch->data();
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rows + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear_rgb(rows, sh, sw, out, out_h, out_w);
  return 0;
}

int decode_file(const char* path, int out_h, int out_w, unsigned char* out,
                std::vector<unsigned char>* file_buf,
                std::vector<unsigned char>* scratch) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 10;
  std::fseek(f, 0, SEEK_END);
  const long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (len <= 0) {
    std::fclose(f);
    return 11;
  }
  file_buf->resize(static_cast<size_t>(len));
  const size_t got = std::fread(file_buf->data(), 1, file_buf->size(), f);
  std::fclose(f);
  if (got != file_buf->size()) return 12;
  return decode_buffer(file_buf->data(), file_buf->size(), out_h, out_w, out,
                       scratch);
}

}  // namespace

extern "C" {

// Decode one JPEG file, DCT-scaled + bilinear-resized to (out_h, out_w),
// writing RGB uint8 row-major into out. Returns 0 on success.
int jpeg_decode_resize(const char* path, int out_h, int out_w,
                       unsigned char* out) {
  std::vector<unsigned char> file_buf, scratch;
  return decode_file(path, out_h, out_w, out, &file_buf, &scratch);
}

// Batch variant: paths[i] -> out + i*out_h*out_w*3; status[i] receives the
// per-image return code (0 = ok). num_threads <= 0 means hardware
// concurrency. Safe to call with the GIL released (pure C, no Python).
void jpeg_decode_resize_batch(const char* const* paths, int n, int out_h,
                              int out_w, unsigned char* out, int* status,
                              int num_threads) {
  if (n <= 0) return;
  int workers = num_threads > 0
                    ? num_threads
                    : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min(workers, n));
  std::atomic<int> next(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto run = [&]() {
    std::vector<unsigned char> file_buf, scratch;  // reused across images
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = decode_file(paths[i], out_h, out_w, out + stride * i,
                              &file_buf, &scratch);
    }
  };
  if (workers == 1) {
    run();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(run);
  for (auto& t : pool) t.join();
}

}  // extern "C"
