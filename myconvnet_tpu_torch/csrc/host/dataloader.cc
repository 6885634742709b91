// Host data runtime of the PyTorch port: shuffling, threaded batch
// assembly, a host normalize, and JPEG/PNG decoding.  Plain C++ for the
// host CPU (no CUDA); the port's kernel build (ops/kernels/_build.py)
// compiles csrc/*.cu only, so this file stays out of it.
//
//   * mcn_shuffle_indices  - per-epoch permutation (splitmix64 +
//     Fisher-Yates), deterministic in the seed.
//   * mcn_gather_batch     - gather N items of item_bytes each from a
//     source pool into one contiguous batch buffer, fanned out over
//     worker threads: the hot memcpy of every in-memory host batch.
//   * mcn_u8_to_f32_normalize - host-side normalize for the CPU path
//     (the card normalizes on the device).
//   * mcn_decode_jpeg_batch - threaded libjpeg decode (DCT prescaled) +
//     bilinear cover-resize + center crop, the host decode geometry of
//     data/pipeline.py's cover_resize_center_crop.
//   * mcn_png_info / mcn_decode_png - libpng decode, RGB or the raw
//     palette indices of a segmentation mask.
//
// The same source and flags as the JAX package's host library, so both
// decode a JPEG or PNG to the same bytes.  g++ builds it at first use:
//   g++ -O3 -shared -fPIC -pthread -std=c++17 [-DMCN_WITH_JPEG]
//       [-DMCN_WITH_PNG] -o libmcn_data.so dataloader.cc [-ljpeg] [-lpng]
// (myconvnet_tpu_torch/data/native_loader.py, which binds it with ctypes).

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#ifdef MCN_WITH_JPEG
#include <jpeglib.h>
#endif
#ifdef MCN_WITH_PNG
#include <png.h>
#endif

extern "C" {

// ---------------------------------------------------------------- shuffle

static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void mcn_shuffle_indices(uint64_t seed, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s = seed ^ 0xD1B54A32D192ED03ull;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(&s) % static_cast<uint64_t>(i + 1);
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
}

// ----------------------------------------------------------------- gather

struct GatherArgs {
  const uint8_t* src;
  const int64_t* idx;
  uint8_t* dst;
  int64_t item_bytes;
  int64_t begin, end;
};

static void gather_range(const GatherArgs a) {
  for (int64_t i = a.begin; i < a.end; ++i) {
    std::memcpy(a.dst + i * a.item_bytes,
                a.src + a.idx[i] * a.item_bytes,
                static_cast<size_t>(a.item_bytes));
  }
}

void mcn_gather_batch(const uint8_t* src, const int64_t* idx,
                      int64_t batch, int64_t item_bytes, uint8_t* dst,
                      int n_threads) {
  if (n_threads <= 1 || batch < 2 * n_threads) {
    gather_range({src, idx, dst, item_bytes, 0, batch});
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < batch ? b + chunk : batch;
    if (b >= e) break;
    ts.emplace_back(gather_range,
                    GatherArgs{src, idx, dst, item_bytes, b, e});
  }
  for (auto& t : ts) t.join();
}

// ------------------------------------------------------- host normalize

struct NormArgs {
  const uint8_t* src;
  float* dst;
  const float* scale;   // per-channel: 1/(255*std)
  const float* shift;   // per-channel: -mean/std
  int64_t channels;
  int64_t begin, end;   // in pixels (channels-last groups)
};

static void norm_range(const NormArgs a) {
  for (int64_t p = a.begin; p < a.end; ++p) {
    const uint8_t* s = a.src + p * a.channels;
    float* d = a.dst + p * a.channels;
    for (int64_t c = 0; c < a.channels; ++c) {
      d[c] = static_cast<float>(s[c]) * a.scale[c] + a.shift[c];
    }
  }
}

void mcn_u8_to_f32_normalize(const uint8_t* src, float* dst,
                             const float* scale, const float* shift,
                             int64_t pixels, int64_t channels,
                             int n_threads) {
  if (n_threads <= 1 || pixels < 1 << 16) {
    norm_range({src, dst, scale, shift, channels, 0, pixels});
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (pixels + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < pixels ? b + chunk : pixels;
    if (b >= e) break;
    ts.emplace_back(norm_range,
                    NormArgs{src, dst, scale, shift, channels, b, e});
  }
  for (auto& t : ts) t.join();
}

// -------------------------------------------------- JPEG decode (libjpeg)
//
// mcn_decode_jpeg_resize: decode one JPEG and scale-crop it to exactly
// (th, tw) RGB — the reference pipeline's decode->resize stage, native.
// Uses libjpeg's DCT prescaling (1/1..1/8) to land near the target
// cheaply, then a fixed-point bilinear "cover" resize + center crop
// (matching data/pipeline.py decode_image semantics).
// Returns 0 on success, nonzero on decode failure.

#ifdef MCN_WITH_JPEG

struct McnJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void mcn_jpeg_fail(j_common_ptr cinfo) {
  McnJpegErr* e = reinterpret_cast<McnJpegErr*>(cinfo->err);
  longjmp(e->jump, 1);
}

static void bilinear_cover_resize(const uint8_t* src, int sh, int sw,
                                  uint8_t* dst, int th, int tw) {
  // scale = max(th/sh, tw/sw) ("cover"), center-crop the overhang.
  const double scale =
      th / static_cast<double>(sh) > tw / static_cast<double>(sw)
          ? th / static_cast<double>(sh)
          : tw / static_cast<double>(sw);
  const double inv = 1.0 / scale;
  const double y_off = (sh - th * inv) * 0.5;
  const double x_off = (sw - tw * inv) * 0.5;
  for (int y = 0; y < th; ++y) {
    double fy = y_off + (y + 0.5) * inv - 0.5;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = sh - 1;
    const int y0 = static_cast<int>(fy);
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = static_cast<float>(fy - y0);
    for (int x = 0; x < tw; ++x) {
      double fx = x_off + (x + 0.5) * inv - 0.5;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = sw - 1;
      const int x0 = static_cast<int>(fx);
      const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      const float wx = static_cast<float>(fx - x0);
      const uint8_t* p00 = src + (y0 * sw + x0) * 3;
      const uint8_t* p01 = src + (y0 * sw + x1) * 3;
      const uint8_t* p10 = src + (y1 * sw + x0) * 3;
      const uint8_t* p11 = src + (y1 * sw + x1) * 3;
      uint8_t* d = dst + (y * tw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float top = p00[c] + (p01[c] - p00[c]) * wx;
        const float bot = p10[c] + (p11[c] - p10[c]) * wx;
        const float v = top + (bot - top) * wy;
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

int mcn_decode_jpeg_resize(const uint8_t* data, int64_t len, int th,
                           int tw, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  McnJpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = mcn_jpeg_fail;
  // both buffers live BEFORE setjmp: a longjmp out of a scope declared
  // after it would skip the destructor and leak on every corrupt image
  std::vector<uint8_t> rgb;
  std::vector<uint8_t> row;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT prescale: pick the smallest 1/d (d in 1,2,4,8) that still
  // "covers" the target on both axes.
  for (int d = 8; d >= 1; d /= 2) {
    if (static_cast<int>(cinfo.image_height) / d >= th &&
        static_cast<int>(cinfo.image_width) / d >= tw) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = d;
      break;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = 1;
  }
  jpeg_start_decompress(&cinfo);
  const int sh = static_cast<int>(cinfo.output_height);
  const int sw = static_cast<int>(cinfo.output_width);
  const int sc = cinfo.output_components;
  rgb.resize(static_cast<size_t>(sh) * sw * 3);
  row.resize(static_cast<size_t>(sw) * sc);
  for (int y = 0; y < sh; ++y) {
    uint8_t* rp = row.data();
    jpeg_read_scanlines(&cinfo, &rp, 1);
    uint8_t* dst = rgb.data() + static_cast<size_t>(y) * sw * 3;
    if (sc == 3) {
      std::memcpy(dst, row.data(), static_cast<size_t>(sw) * 3);
    } else {  // grayscale -> RGB
      for (int x = 0; x < sw; ++x) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = row[x * sc];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  if (sh == th && sw == tw) {
    std::memcpy(out, rgb.data(), static_cast<size_t>(th) * tw * 3);
  } else {
    bilinear_cover_resize(rgb.data(), sh, sw, out, th, tw);
  }
  return 0;
}

struct DecodeJob {
  const uint8_t* const* datas;
  const int64_t* lens;
  uint8_t* out;
  int th, tw;
  int64_t begin, end;
  int* status;
};

static void decode_range(const DecodeJob j) {
  const int64_t item = static_cast<int64_t>(j.th) * j.tw * 3;
  for (int64_t i = j.begin; i < j.end; ++i) {
    j.status[i] = mcn_decode_jpeg_resize(j.datas[i], j.lens[i], j.th,
                                         j.tw, j.out + i * item);
  }
}

void mcn_decode_jpeg_batch(const uint8_t* const* datas,
                           const int64_t* lens, int64_t n, int th, int tw,
                           uint8_t* out, int* status, int n_threads) {
  if (n_threads <= 1 || n < 2) {
    decode_range({datas, lens, out, th, tw, 0, n, status});
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b = t * chunk;
    int64_t e = b + chunk < n ? b + chunk : n;
    if (b >= e) break;
    ts.emplace_back(decode_range,
                    DecodeJob{datas, lens, out, th, tw, b, e, status});
  }
  for (auto& t : ts) t.join();
}

int mcn_has_jpeg(void) { return 1; }

#else  // !MCN_WITH_JPEG

int mcn_has_jpeg(void) { return 0; }

#endif

// ---------------------------------------------------- PNG decode (libpng)
//
// mcn_decode_png: decode one PNG from memory.  mode 0 -> RGB8 [h*w*3]
// (palette/gray/16-bit/alpha all expanded).  mode 1 -> RAW single
// channel [h*w]: palette INDICES (not colors) or gray values — exactly
// what VOC-style segmentation masks need (the class id IS the palette
// index; expanding to RGB would destroy it).
// Two-call protocol: mcn_png_info for dims, then decode into a caller
// buffer of h*w*(mode ? 1 : 3) bytes.  Returns 0 on success.

#ifdef MCN_WITH_PNG

struct McnPngMem {
  const uint8_t* data;
  size_t len, off;
};

static void mcn_png_read(png_structp p, png_bytep out, png_size_t n) {
  McnPngMem* m = static_cast<McnPngMem*>(png_get_io_ptr(p));
  if (m->off + n > m->len) png_error(p, "mcn: truncated png");
  std::memcpy(out, m->data + m->off, n);
  m->off += n;
}

static int mcn_png_open(const uint8_t* data, int64_t len, png_structp* pp,
                        png_infop* ip, McnPngMem* mem) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return 2;
  *pp = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                               nullptr);
  if (!*pp) return 3;
  *ip = png_create_info_struct(*pp);
  if (!*ip) {
    png_destroy_read_struct(pp, nullptr, nullptr);
    return 3;
  }
  mem->data = data;
  mem->len = static_cast<size_t>(len);
  mem->off = 0;
  png_set_read_fn(*pp, mem, mcn_png_read);
  return 0;
}

int mcn_png_info(const uint8_t* data, int64_t len, int* h, int* w) {
  png_structp p;
  png_infop info;
  McnPngMem mem;
  int rc = mcn_png_open(data, len, &p, &info, &mem);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 1;
  }
  png_read_info(p, info);
  *h = static_cast<int>(png_get_image_height(p, info));
  *w = static_cast<int>(png_get_image_width(p, info));
  png_destroy_read_struct(&p, &info, nullptr);
  return 0;
}

int mcn_decode_png(const uint8_t* data, int64_t len, int mode,
                   uint8_t* out, int64_t cap) {
  png_structp p;
  png_infop info;
  McnPngMem mem;
  std::vector<png_bytep> rows;
  int rc = mcn_png_open(data, len, &p, &info, &mem);
  if (rc) return rc;
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 1;
  }
  png_read_info(p, info);
  const png_uint_32 h = png_get_image_height(p, info);
  const int color = png_get_color_type(p, info);
  const int depth = png_get_bit_depth(p, info);
  if (mode == 1) {
    // raw indices/gray: no palette expansion; sub-byte depths unpack to
    // one byte per pixel.  16-bit gray DECLINES (stripping to the high
    // byte would corrupt label ids > 255 — the PIL fallback preserves
    // full values).
    if ((color != PNG_COLOR_TYPE_PALETTE &&
         color != PNG_COLOR_TYPE_GRAY) || depth == 16) {
      png_destroy_read_struct(&p, &info, nullptr);
      return 4;  // caller falls back to PIL
    }
    if (depth < 8) png_set_packing(p);
  } else {
    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(p);
    if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
      png_set_expand_gray_1_2_4_to_8(p);
    if (png_get_valid(p, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(p);
    if (depth == 16) png_set_strip_16(p);
    if (color == PNG_COLOR_TYPE_GRAY ||
        color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(p);
    png_set_strip_alpha(p);
  }
  png_set_interlace_handling(p);
  png_read_update_info(p, info);
  const size_t rowbytes = png_get_rowbytes(p, info);
  const size_t want = rowbytes * h;
  if (cap < static_cast<int64_t>(want)) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 5;
  }
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + y * rowbytes;
  png_read_image(p, rows.data());
  png_destroy_read_struct(&p, &info, nullptr);
  return 0;
}

int mcn_has_png(void) { return 1; }

#else  // !MCN_WITH_PNG

int mcn_has_png(void) { return 0; }

#endif

}  // extern "C"
