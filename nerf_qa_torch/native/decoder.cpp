// Native data layer: parallel image decode + resize worker pool.
//
// The PyTorch port's copy of the JAX package's decoder (native/decoder.cpp
// at the repository root), built from this file and never from that one.
// The reference's data plane is PIL decode inside torch DataLoader worker
// processes (nerf_qa/data.py:64-84 + num_workers=4 loaders). This is a
// C++ thread pool that decodes PNG/JPEG (libpng/libjpeg), composites RGBA
// onto white (data.py:67-75 semantics), bilinearly resizes with torch
// align_corners=False geometry (data.py:81-82), and writes float32 NHWC
// batches straight into a caller-provided buffer — zero Python-side
// copies. Exposed over a plain C ABI for ctypes.
//
// Two changes from the JAX package's copy. get_pool keeps one pool per
// thread count, so a call's `threads` argument takes effect on every call
// (the JAX copy sizes a single pool by the first call of the process).
// to_float_rgb and resize_bilinear round as the PIL route does (a division
// by 255, the H lerp before the W lerp, no fused multiply-add), so that a
// PNG decodes and resizes to the same bits through either route.
//
// Build: nerf_qa_torch/data/native.py compiles this file with g++ at first
// use (-O3 -march=native -ffp-contract=off -shared -fPIC -std=c++17
// -lpng -ljpeg -lz -lpthread) into build/native/ under the repository
// root.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, c in {3, 4}
  bool ok = false;
};

Image decode_png(const char* path) {
  Image out;
  FILE* fp = fopen(path, "rb");
  if (!fp) return out;
  png_byte header[8];
  if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    fclose(fp);
    return out;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return out;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_set_expand(png);           // palette/gray->8-bit RGB(A)
  png_set_strip_16(png);         // 16-bit -> 8-bit
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);

  out.h = png_get_image_height(png, info);
  out.w = png_get_image_width(png, info);
  out.c = png_get_channels(png, info);
  out.data.resize(size_t(out.h) * out.w * out.c);
  std::vector<png_bytep> rows(out.h);
  for (int y = 0; y < out.h; ++y)
    rows[y] = out.data.data() + size_t(y) * out.w * out.c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  out.ok = (out.c == 3 || out.c == 4);
  return out;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// DCT-domain scaled decode: pick the largest 1/d (d in {8,4,2}) whose
// output still covers (min_h, min_w), so the subsequent bilinear resize
// only ever downsamples. libjpeg skips most IDCT work at reduced scale
// (1/8 decodes DC-only) — this is the cheap path for 1080p -> 256²
// feeds where full-resolution pixels are immediately thrown away.
void select_dct_scale(jpeg_decompress_struct* cinfo, int min_h, int min_w) {
  if (min_h <= 0 || min_w <= 0) return;
  for (int d = 8; d >= 2; d /= 2) {
    unsigned sh = (cinfo->image_height + d - 1) / d;
    unsigned sw = (cinfo->image_width + d - 1) / d;
    if (sh >= unsigned(min_h) && sw >= unsigned(min_w)) {
      cinfo->scale_num = 1;
      cinfo->scale_denom = unsigned(d);
      return;
    }
  }
}

Image decode_jpeg(const char* path, int min_h = 0, int min_w = 0) {
  Image out;
  FILE* fp = fopen(path, "rb");
  if (!fp) return out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  select_dct_scale(&cinfo, min_h, min_w);
  jpeg_start_decompress(&cinfo);
  out.h = cinfo.output_height;
  out.w = cinfo.output_width;
  out.c = 3;
  out.data.resize(size_t(out.h) * out.w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out.data.data() + size_t(cinfo.output_scanline) * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  out.ok = true;
  return out;
}

// min_h/min_w > 0 allow a DCT-scaled JPEG decode (fast feed path); PNG
// has no scaled-decode equivalent and always decodes at full size.
Image decode_any(const char* path, int min_h = 0, int min_w = 0) {
  size_t n = strlen(path);
  if (n >= 4 && (strcmp(path + n - 4, ".png") == 0 ||
                 strcmp(path + n - 4, ".PNG") == 0))
    return decode_png(path);
  return decode_jpeg(path, min_h, min_w);
}

// RGBA -> white-composited RGB float [0,1]; RGB -> float.
std::vector<float> to_float_rgb(const Image& img) {
  std::vector<float> out(size_t(img.h) * img.w * 3);
  const uint8_t* src = img.data.data();
  float* dst = out.data();
  // a division, as numpy's uint8 / 255.0 in float32 (equal bits)
  if (img.c == 3) {
    size_t n = size_t(img.h) * img.w * 3;
    for (size_t i = 0; i < n; ++i) dst[i] = src[i] / 255.0f;
  } else {
    size_t px = size_t(img.h) * img.w;
    for (size_t i = 0; i < px; ++i) {
      float a = src[i * 4 + 3] / 255.0f;
      for (int k = 0; k < 3; ++k) {
        float v = src[i * 4 + k] / 255.0f;
        dst[i * 3 + k] = v * a + (1.0f - a);  // composite onto white
      }
    }
  }
  return out;
}

// Bilinear resize, align_corners=False (torch F.interpolate semantics),
// rounded as data/imaging.resize_image rounds: the H lerp of both source
// columns, then the W lerp, each product and sum in float32 (the build
// passes -ffp-contract=off so that no multiply-add is fused).
void resize_bilinear(const float* src, int sh, int sw, float* dst, int dh,
                     int dw) {
  if (sh == dh && sw == dw) {
    memcpy(dst, src, size_t(dh) * dw * 3 * sizeof(float));
    return;
  }
  std::vector<int> x0(dw), x1(dw);
  std::vector<float> tx(dw);
  const double sx = double(sw) / dw;
  for (int x = 0; x < dw; ++x) {
    double s = (x + 0.5) * sx - 0.5;
    s = s < 0 ? 0 : (s > sw - 1 ? sw - 1 : s);
    x0[x] = int(s);
    x1[x] = x0[x] + 1 < sw ? x0[x] + 1 : sw - 1;
    tx[x] = float(s - x0[x]);
  }
  const double sy = double(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    double s = (y + 0.5) * sy - 0.5;
    s = s < 0 ? 0 : (s > sh - 1 ? sh - 1 : s);
    int y0 = int(s);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float ty = float(s - y0);
    const float* r0 = src + size_t(y0) * sw * 3;
    const float* r1 = src + size_t(y1) * sw * 3;
    float* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float* p00 = r0 + x0[x] * 3;
      const float* p01 = r0 + x1[x] * 3;
      const float* p10 = r1 + x0[x] * 3;
      const float* p11 = r1 + x1[x] * 3;
      float fx = tx[x];
      for (int k = 0; k < 3; ++k) {
        float left = p00[k] * (1 - ty) + p10[k] * ty;
        float right = p01[k] * (1 - ty) + p11[k] * ty;
        drow[x * 3 + k] = left * (1 - fx) + right * fx;
      }
    }
  }
}

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

std::map<int, ThreadPool*> pools;  // by thread count; live for the process
std::mutex pool_mu;

ThreadPool& get_pool(int threads) {
  std::lock_guard<std::mutex> lk(pool_mu);
  int n = threads > 0 ? threads : 4;
  ThreadPool*& pool = pools[n];
  if (!pool) pool = new ThreadPool(n);
  return *pool;
}

// ---------------------------------------------------------------------------
// MP4 (ISO base media) demux. The reference decodes mp4s with OpenCV
// (nerf_qa/data.py:378-392); this environment has no cv2/ffmpeg, so the
// native layer demuxes the container itself: it walks the box tree to the
// video track's sample tables (stsd/stsz/stsc/stco) and, for Motion-JPEG
// tracks, decodes each sample with the libjpeg path above. Compressed
// codecs (avc1/hev1/...) are reported to Python, which falls back to an
// ffmpeg backend when one exists.

Image decode_jpeg_mem(const uint8_t* buf, size_t len, int min_h = 0,
                      int min_w = 0) {
  Image out;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return out;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  select_dct_scale(&cinfo, min_h, min_w);
  jpeg_start_decompress(&cinfo);
  out.h = cinfo.output_height;
  out.w = cinfo.output_width;
  out.c = 3;
  out.data.resize(size_t(out.h) * out.w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out.data.data() + size_t(cinfo.output_scanline) * out.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out.ok = true;
  return out;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

uint64_t be64(const uint8_t* p) {
  return (uint64_t(be32(p)) << 32) | be32(p + 4);
}

// Find the first child box of the given type in [p, end); returns its
// payload pointer and size, or nullptr.
const uint8_t* find_box(const uint8_t* p, const uint8_t* end,
                        const char* type, uint64_t* out_size) {
  while (p + 8 <= end) {
    uint64_t size = be32(p);
    const uint8_t* payload = p + 8;
    if (size == 1) {
      if (p + 16 > end) return nullptr;
      size = be64(p + 8);
      payload = p + 16;
    } else if (size == 0) {
      size = uint64_t(end - p);
    }
    if (size < 8 || p + size > end) return nullptr;
    if (memcmp(p + 4, type, 4) == 0) {
      *out_size = size - (payload - p);
      return payload;
    }
    p += size;
  }
  return nullptr;
}

struct Mp4Track {
  char codec[5] = {0, 0, 0, 0, 0};
  std::vector<uint64_t> offsets;  // absolute file offsets per sample
  std::vector<uint32_t> sizes;    // bytes per sample
  bool ok = false;
};

// Parse the first video trak's sample tables out of moov.
Mp4Track parse_moov(const uint8_t* moov, uint64_t moov_size) {
  Mp4Track t;
  const uint8_t* p = moov;
  const uint8_t* end = moov + moov_size;
  while (p + 8 <= end) {
    uint64_t tsz;
    const uint8_t* trak = find_box(p, end, "trak", &tsz);
    if (!trak) return t;
    p = trak + tsz;  // next search starts after this trak
    uint64_t sz;
    const uint8_t* mdia = find_box(trak, trak + tsz, "mdia", &sz);
    if (!mdia) continue;
    const uint8_t* mdia_end = mdia + sz;
    const uint8_t* hdlr = find_box(mdia, mdia_end, "hdlr", &sz);
    if (!hdlr || sz < 12 || memcmp(hdlr + 8, "vide", 4) != 0) continue;
    const uint8_t* minf = find_box(mdia, mdia_end, "minf", &sz);
    if (!minf) continue;
    const uint8_t* stbl = find_box(minf, minf + sz, "stbl", &sz);
    if (!stbl) continue;
    const uint8_t* stbl_end = stbl + sz;

    uint64_t stsd_sz;
    const uint8_t* stsd = find_box(stbl, stbl_end, "stsd", &stsd_sz);
    if (!stsd || stsd_sz < 16 || be32(stsd + 4) < 1) continue;
    memcpy(t.codec, stsd + 12, 4);  // first sample entry's fourcc

    uint64_t stsz_sz;
    const uint8_t* stsz = find_box(stbl, stbl_end, "stsz", &stsz_sz);
    if (!stsz || stsz_sz < 12) continue;
    uint32_t uniform = be32(stsz + 4);
    uint32_t n_samples = be32(stsz + 8);
    if (n_samples == 0) continue;
    t.sizes.resize(n_samples);
    if (uniform) {
      for (uint32_t i = 0; i < n_samples; ++i) t.sizes[i] = uniform;
    } else {
      if (stsz_sz < 12 + 4ull * n_samples) continue;
      for (uint32_t i = 0; i < n_samples; ++i)
        t.sizes[i] = be32(stsz + 12 + 4 * i);
    }

    uint64_t stco_sz;
    bool co64 = false;
    const uint8_t* stco = find_box(stbl, stbl_end, "stco", &stco_sz);
    if (!stco) {
      stco = find_box(stbl, stbl_end, "co64", &stco_sz);
      co64 = true;
    }
    if (!stco || stco_sz < 8) continue;
    uint32_t n_chunks = be32(stco + 4);
    if (stco_sz < 8 + (co64 ? 8ull : 4ull) * n_chunks) continue;

    uint64_t stsc_sz;
    const uint8_t* stsc = find_box(stbl, stbl_end, "stsc", &stsc_sz);
    if (!stsc || stsc_sz < 8) continue;
    uint32_t n_runs = be32(stsc + 4);
    if (stsc_sz < 8 + 12ull * n_runs || n_runs == 0) continue;

    // expand chunk runs -> per-sample absolute offsets
    t.offsets.resize(n_samples);
    uint32_t sample = 0;
    for (uint32_t run = 0; run < n_runs && sample < n_samples; ++run) {
      uint32_t first = be32(stsc + 8 + 12 * run);
      uint32_t per = be32(stsc + 8 + 12 * run + 4);
      uint32_t last = (run + 1 < n_runs)
                          ? be32(stsc + 8 + 12 * (run + 1))
                          : n_chunks + 1;
      for (uint32_t chunk = first; chunk < last && sample < n_samples;
           ++chunk) {
        if (chunk > n_chunks) break;
        uint64_t off = co64 ? be64(stco + 8 + 8 * (chunk - 1))
                            : be32(stco + 8 + 4 * (chunk - 1));
        for (uint32_t s = 0; s < per && sample < n_samples; ++s) {
          t.offsets[sample] = off;
          off += t.sizes[sample];
          ++sample;
        }
      }
    }
    if (sample != n_samples) continue;
    t.ok = true;
    return t;
  }
  return t;
}

Mp4Track parse_mp4(const char* path) {
  Mp4Track t;
  FILE* fp = fopen(path, "rb");
  if (!fp) return t;
  uint8_t hdr[16];
  for (;;) {
    long pos = ftell(fp);
    if (fread(hdr, 1, 8, fp) != 8) break;
    uint64_t size = be32(hdr);
    uint64_t header = 8;
    if (size == 1) {
      if (fread(hdr + 8, 1, 8, fp) != 8) break;
      size = be64(hdr + 8);
      header = 16;
    }
    if (size < header) break;
    if (memcmp(hdr + 4, "moov", 4) == 0) {
      std::vector<uint8_t> moov(size - header);
      if (fread(moov.data(), 1, moov.size(), fp) != moov.size()) break;
      t = parse_moov(moov.data(), moov.size());
      break;
    }
    if (fseek(fp, long(pos + size), SEEK_SET) != 0) break;
  }
  fclose(fp);
  return t;
}

bool is_mjpeg(const char* codec) {
  return memcmp(codec, "jpeg", 4) == 0 || memcmp(codec, "mjpa", 4) == 0 ||
         memcmp(codec, "mjpg", 4) == 0 || memcmp(codec, "MJPG", 4) == 0;
}

bool read_sample(FILE* fp, uint64_t off, uint32_t size,
                 std::vector<uint8_t>* buf) {
  buf->resize(size);
  if (fseek(fp, long(off), SEEK_SET) != 0) return false;
  return fread(buf->data(), 1, size, fp) == size;
}

}  // namespace

extern "C" {

// Decode one image, resize to (out_h, out_w), write float32 HWC RGB into
// out (caller-allocated, out_h*out_w*3 floats). out_h/out_w <= 0 keeps the
// source size IF it matches the buffer dims passed in src_h/src_w probes.
// fast != 0 permits a DCT-domain scaled JPEG decode (largest 1/{2,4,8}
// whose output still covers the target — e.g. 1080p -> 256² decodes at
// 480x270), trading exact full-res bilinear geometry for a large decode
// speedup; PNG is unaffected. Returns 0 on success.
int nqa_decode_resize2(const char* path, float* out, int out_h, int out_w,
                       int fast) {
  Image img = fast ? decode_any(path, out_h, out_w) : decode_any(path);
  if (!img.ok) return 1;
  std::vector<float> rgb = to_float_rgb(img);
  resize_bilinear(rgb.data(), img.h, img.w, out, out_h, out_w);
  return 0;
}

int nqa_decode_resize(const char* path, float* out, int out_h, int out_w) {
  return nqa_decode_resize2(path, out, out_h, out_w, 0);
}

// Probe image dimensions from the header only (no pixel decode — this
// runs per-image on the FR loaders' hot path via load_prepared).
// Returns 0 on success.
int nqa_image_size(const char* path, int* h, int* w) {
  size_t n = strlen(path);
  bool is_png = n >= 4 && (strcmp(path + n - 4, ".png") == 0 ||
                           strcmp(path + n - 4, ".PNG") == 0);
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  if (is_png) {
    png_byte header[8];
    if (fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
      fclose(fp);
      return 1;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    png_infop info = png_create_info_struct(png);
    if (setjmp(png_jmpbuf(png))) {
      png_destroy_read_struct(&png, &info, nullptr);
      fclose(fp);
      return 1;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);
    *h = int(png_get_image_height(png, info));
    *w = int(png_get_image_width(png, info));
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 0;
  }
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  *h = int(cinfo.image_height);
  *w = int(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

// Parallel batch: decode+resize n images into out (n*out_h*out_w*3 f32,
// NHWC). fast: see nqa_decode_resize2. Returns number of failures.
int nqa_decode_resize_batch2(const char** paths, int n, float* out,
                             int out_h, int out_w, int threads, int fast) {
  ThreadPool& tp = get_pool(threads);
  std::atomic<int> failures{0};
  std::atomic<int> done{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  size_t stride = size_t(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    const char* p = paths[i];
    float* dst = out + stride * i;
    tp.submit([p, dst, out_h, out_w, fast, &failures, &done, &done_cv,
               &done_mu] {
      if (nqa_decode_resize2(p, dst, out_h, out_w, fast) != 0) failures++;
      {
        std::lock_guard<std::mutex> lk(done_mu);
        done++;
      }
      done_cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return done.load() == n; });
  return failures.load();
}

int nqa_decode_resize_batch(const char** paths, int n, float* out, int out_h,
                            int out_w, int threads) {
  return nqa_decode_resize_batch2(paths, n, out, out_h, out_w, threads, 0);
}

// Probe an mp4: fills the video codec fourcc (NUL-terminated, caller
// provides >= 5 bytes), sample count, and frame dimensions (decoded from
// the first sample for MJPEG; 0 for other codecs). Returns 0 on success,
// 1 when the container has no parseable video track.
int nqa_mp4_probe(const char* path, char* codec, int* n_frames, int* h,
                  int* w) {
  Mp4Track t = parse_mp4(path);
  if (!t.ok) return 1;
  memcpy(codec, t.codec, 5);
  *n_frames = int(t.sizes.size());
  *h = 0;
  *w = 0;
  if (is_mjpeg(t.codec) && !t.sizes.empty()) {
    FILE* fp = fopen(path, "rb");
    if (fp) {
      std::vector<uint8_t> buf;
      if (read_sample(fp, t.offsets[0], t.sizes[0], &buf)) {
        Image img = decode_jpeg_mem(buf.data(), buf.size());
        if (img.ok) {
          *h = img.h;
          *w = img.w;
        }
      }
      fclose(fp);
    }
  }
  return 0;
}

// Decode MJPEG samples [start, start+n) to float32 NHWC RGB in [0,1] at
// (out_h, out_w). fast: see nqa_decode_resize2. Returns frames written,
// -1 on parse failure, -2 for a non-MJPEG codec (caller falls back to
// ffmpeg).
int nqa_mp4_decode_frames2(const char* path, int start, int n, float* out,
                           int out_h, int out_w, int threads, int fast) {
  Mp4Track t = parse_mp4(path);
  if (!t.ok) return -1;
  if (!is_mjpeg(t.codec)) return -2;
  int total = int(t.sizes.size());
  if (start < 0 || start >= total) return 0;
  if (n <= 0 || start + n > total) n = total - start;

  ThreadPool& tp = get_pool(threads);
  std::atomic<int> failures{0};
  std::atomic<int> done{0};
  std::mutex done_mu;
  std::condition_variable done_cv;
  size_t stride = size_t(out_h) * out_w * 3;
  for (int i = 0; i < n; ++i) {
    uint64_t off = t.offsets[start + i];
    uint32_t size = t.sizes[start + i];
    float* dst = out + stride * i;
    tp.submit([path, off, size, dst, out_h, out_w, fast, &failures, &done,
               &done_cv, &done_mu] {
      // per-task FILE*: no shared seek state across pool threads
      FILE* fp = fopen(path, "rb");
      std::vector<uint8_t> buf;
      bool ok = fp && read_sample(fp, off, size, &buf);
      if (fp) fclose(fp);
      if (ok) {
        Image img = fast
            ? decode_jpeg_mem(buf.data(), buf.size(), out_h, out_w)
            : decode_jpeg_mem(buf.data(), buf.size());
        if (img.ok) {
          std::vector<float> rgb = to_float_rgb(img);
          resize_bilinear(rgb.data(), img.h, img.w, dst, out_h, out_w);
        } else {
          ok = false;
        }
      }
      if (!ok) failures++;
      {
        std::lock_guard<std::mutex> lk(done_mu);
        done++;
      }
      done_cv.notify_one();
    });
  }
  std::unique_lock<std::mutex> lk(done_mu);
  done_cv.wait(lk, [&] { return done.load() == n; });
  return failures.load() ? -3 : n;
}

int nqa_mp4_decode_frames(const char* path, int start, int n, float* out,
                          int out_h, int out_w, int threads) {
  return nqa_mp4_decode_frames2(path, start, n, out, out_h, out_w, threads,
                                0);
}

}  // extern "C"
