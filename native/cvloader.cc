// Native input-pipeline core: threaded image decode + geometry on raw
// buffers.
//
// The reference feeds training from Python DataLoader workers doing
// PIL/cv2 work per sample (utils/datasets.py). Feeding a GPU at
// thousands of 416² frames/sec needs the host path out of Python: this
// library decodes JPEG/PNG (libjpeg/libpng), letterboxes, extracts
// tile-and-scale patches and applies bilinear affine warps on uint8
// buffers, across a persistent std::thread pool. Exposed through a plain
// C ABI consumed via ctypes (no pybind11 in this image).
//
// All geometry matches the Python/jax implementations bit-for-bit where
// exactness matters (half-pixel-centre bilinear = cv2.INTER_LINEAR;
// letterbox = utils/utils.py:36-48 semantics).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

extern "C" {

// ---------------------------------------------------------------------------
// thread pool
// ---------------------------------------------------------------------------

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), active_(0) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
            ++active_;
          }
          job();
          {
            std::lock_guard<std::mutex> lk(mu_);
            --active_;
          }
          done_.notify_all();
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_.wait(lk, [this] { return jobs_.empty() && active_ == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_, done_;
  bool stop_;
  int active_;
};

ThreadPool* g_pool = nullptr;
int g_pool_threads = 0;
std::mutex g_pool_mu;

// The pool is sized ONCE, on first use (resizing under concurrent batch
// calls would tear workers out from under them); later calls with a
// different n_threads keep the first size. cv_pool_threads() reports the
// actual size so bindings can surface the mismatch.
ThreadPool& pool(int n_threads) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  if (!g_pool) {
    g_pool_threads = n_threads > 0 ? n_threads : 8;
    g_pool = new ThreadPool(g_pool_threads);
  }
  return *g_pool;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

}  // namespace

void cv_init_pool(int n_threads) { pool(n_threads); }

// Actual worker count of the (first-use-sized) global pool; 0 if unbuilt.
int cv_pool_threads() {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  return g_pool_threads;
}

// Probe image dimensions without decoding pixel data.
int cv_probe(const uint8_t* data, long size, int* out_h, int* out_w) {
  if (size >= 8 && data[0] == 0x89 && data[1] == 'P') {
    png_image img;
    memset(&img, 0, sizeof img);
    img.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&img, data, size)) return -1;
    *out_h = img.height;
    *out_w = img.width;
    png_image_free(&img);
    return 0;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  *out_h = cinfo.image_height;
  *out_w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// Decode a JPEG byte buffer into RGB uint8. Returns 0 on success; fills
// out_h/out_w. `out` must hold max_h*max_w*3; fails if larger.
int cv_decode_jpeg(const uint8_t* data, long size, uint8_t* out, int max_h,
                   int max_w, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height, w = cinfo.output_width;
  if (h > max_h || w > max_w || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return 0;
}

// Decode a PNG byte buffer into RGB uint8 (alpha stripped, grey expanded).
int cv_decode_png(const uint8_t* data, long size, uint8_t* out, int max_h,
                  int max_w, int* out_h, int* out_w) {
  png_image img;
  memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, data, size)) return -1;
  img.format = PNG_FORMAT_RGB;
  const int h = img.height, w = img.width;
  if (h > max_h || w > max_w) {
    png_image_free(&img);
    return -2;
  }
  if (!png_image_finish_read(&img, nullptr, out, 0, nullptr)) {
    png_image_free(&img);
    return -3;
  }
  *out_h = h;
  *out_w = w;
  return 0;
}

// ---------------------------------------------------------------------------
// geometry (uint8 HWC RGB)
// ---------------------------------------------------------------------------

namespace {

inline void bilinear_resize(const uint8_t* src, int sh, int sw, uint8_t* dst,
                            int dh, int dw) {
  if (sh <= 0 || sw <= 0) {
    // empty source: nothing to sample — the border clamp below would
    // otherwise resolve to index -1 (out-of-bounds read)
    if (dh > 0 && dw > 0) memset(dst, 0, static_cast<size_t>(dh) * dw * 3);
    return;
  }
  // half-pixel-centre sampling, border clamp = cv2.INTER_LINEAR
  const float ry = static_cast<float>(sh) / dh;
  const float rx = static_cast<float>(sw) / dw;
  for (int i = 0; i < dh; ++i) {
    float sy = (i + 0.5f) * ry - 0.5f;
    sy = std::min(std::max(sy, 0.0f), static_cast<float>(sh - 1));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float fy = sy - y0;
    for (int j = 0; j < dw; ++j) {
      float sx = (j + 0.5f) * rx - 0.5f;
      sx = std::min(std::max(sx, 0.0f), static_cast<float>(sw - 1));
      const int x0 = static_cast<int>(sx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float fx = sx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(static_cast<size_t>(y0) * sw + x0) * 3 + c];
        const float v01 = src[(static_cast<size_t>(y0) * sw + x1) * 3 + c];
        const float v10 = src[(static_cast<size_t>(y1) * sw + x0) * 3 + c];
        const float v11 = src[(static_cast<size_t>(y1) * sw + x1) * 3 + c];
        const float v = (1 - fy) * ((1 - fx) * v00 + fx * v01) +
                        fy * ((1 - fx) * v10 + fx * v11);
        dst[(static_cast<size_t>(i) * dw + j) * 3 + c] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

}  // namespace

// Letterbox: symmetric pad to target aspect (grey fill) then resize.
// Matches calculate_padding (utils/utils.py:36-48) + pad + resize.
void cv_letterbox(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                  int dw, uint8_t fill) {
  int pad_h = 0, pad_w = 0;
  if (sh >= sw) {
    const double new_w = static_cast<double>(sh) * dw / dh;
    pad_w = static_cast<int>((new_w - sw) / 2);
  } else {
    const double new_h = static_cast<double>(sw) * dh / dw;
    pad_h = static_cast<int>((new_h - sh) / 2);
  }
  const int ph = sh + 2 * pad_h, pw = sw + 2 * pad_w;
  if (ph <= 0 || pw <= 0 || sh <= 0 || sw <= 0) {
    if (dh > 0 && dw > 0) memset(dst, fill, static_cast<size_t>(dh) * dw * 3);
    return;
  }
  std::vector<uint8_t> padded(static_cast<size_t>(ph) * pw * 3, fill);
  // paste the source at (pad_h, pad_w) copying only the intersection with
  // the canvas: for aspect-mismatched non-square targets the pads are
  // NEGATIVE (PIL paste crops there) and a raw memcpy at a negative
  // offset would write before the buffer — heap corruption
  const int y_lo = std::max(0, pad_h), y_hi = std::min(ph, sh + pad_h);
  const int x_lo = std::max(0, pad_w), x_hi = std::min(pw, sw + pad_w);
  const int row_bytes = (x_hi - x_lo) * 3;
  for (int y = y_lo; y < y_hi && row_bytes > 0; ++y) {
    memcpy(&padded[(static_cast<size_t>(y) * pw + x_lo) * 3],
           src + (static_cast<size_t>(y - pad_h) * sw + (x_lo - pad_w)) * 3,
           static_cast<size_t>(row_bytes));
  }
  bilinear_resize(padded.data(), ph, pw, dst, dh, dw);
}

// Plain bilinear resize (cv2.INTER_LINEAR semantics).
void cv_resize(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
               int dw) {
  bilinear_resize(src, sh, sw, dst, dh, dw);
}

// Bilinear inverse-affine warp: for each dst pixel p, sample src at
// M_inv · p (2×3 row-major), grey fill outside. Matches
// PIL Image.transform(AFFINE, Minv, BILINEAR) up to rounding.
void cv_affine_warp(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                    int dw, const float* m_inv, uint8_t fill) {
  for (int i = 0; i < dh; ++i) {
    for (int j = 0; j < dw; ++j) {
      const float sx = m_inv[0] * j + m_inv[1] * i + m_inv[2];
      const float sy = m_inv[3] * j + m_inv[4] * i + m_inv[5];
      uint8_t* px = dst + (static_cast<size_t>(i) * dw + j) * 3;
      if (sx < -1.0f || sy < -1.0f || sx > sw || sy > sh) {
        px[0] = px[1] = px[2] = fill;
        continue;
      }
      const int x0 = static_cast<int>(std::floor(sx));
      const int y0 = static_cast<int>(std::floor(sy));
      const float fx = sx - x0, fy = sy - y0;
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int dy = 0; dy < 2; ++dy) {
          for (int dx = 0; dx < 2; ++dx) {
            const int yy = y0 + dy, xx = x0 + dx;
            const float wgt = (dy ? fy : 1 - fy) * (dx ? fx : 1 - fx);
            float v = fill;
            if (yy >= 0 && yy < sh && xx >= 0 && xx < sw)
              v = src[(static_cast<size_t>(yy) * sw + xx) * 3 + c];
            acc += wgt * v;
          }
        }
        px[c] = static_cast<uint8_t>(acc + 0.5f);
      }
    }
  }
}

// Crop a patch [left,top)-(right,bottom) (may exceed bounds; grey fill)
// — the tile-and-scale patch extractor (utils/utils.py:411-426).
void cv_extract_patch(const uint8_t* src, int sh, int sw, uint8_t* dst,
                      int top, int left, int ph, int pw, uint8_t fill) {
  for (int i = 0; i < ph; ++i) {
    const int sy = top + i;
    uint8_t* drow = dst + static_cast<size_t>(i) * pw * 3;
    if (sy < 0 || sy >= sh) {
      memset(drow, fill, static_cast<size_t>(pw) * 3);
      continue;
    }
    for (int j = 0; j < pw; ++j) {
      const int sx = left + j;
      if (sx < 0 || sx >= sw) {
        drow[j * 3] = drow[j * 3 + 1] = drow[j * 3 + 2] = fill;
      } else {
        memcpy(&drow[j * 3], &src[(static_cast<size_t>(sy) * sw + sx) * 3], 3);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// batched entry points (thread pool fan-out)
// ---------------------------------------------------------------------------

// Decode N images (JPEG or PNG autodetected) and letterbox each into a
// (N, dh, dw, 3) uint8 output. sizes[i] = byte length of blob i; blobs are
// concatenated in `data` at offsets[i]. Returns number of failures.
int cv_decode_letterbox_batch(const uint8_t* data, const long* offsets,
                              const long* sizes, int n, uint8_t* out, int dh,
                              int dw, uint8_t fill, int n_threads) {
  std::atomic<int> failures(0);
  ThreadPool& tp = pool(n_threads);
  for (int i = 0; i < n; ++i) {
    tp.submit([&, i] {
      const uint8_t* blob = data + offsets[i];
      int h = 0, w = 0;
      if (cv_probe(blob, sizes[i], &h, &w) != 0) {
        failures.fetch_add(1);
        return;
      }
      std::vector<uint8_t> buf(static_cast<size_t>(h) * w * 3);
      int rc;
      if (sizes[i] >= 8 && blob[0] == 0x89 && blob[1] == 'P')
        rc = cv_decode_png(blob, sizes[i], buf.data(), h, w, &h, &w);
      else
        rc = cv_decode_jpeg(blob, sizes[i], buf.data(), h, w, &h, &w);
      if (rc != 0) {
        failures.fetch_add(1);
        return;
      }
      cv_letterbox(buf.data(), h, w, out + static_cast<size_t>(i) * dh * dw * 3,
                   dh, dw, fill);
    });
  }
  tp.wait();
  return failures.load();
}

}  // extern "C"
