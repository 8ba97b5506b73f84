// Native image decoding for the training data path.
//
// The reference gets decode parallelism for free from torch DataLoader
// workers (sgm/data/*, num_workers in configs); our loaders are
// process-local, so decode happens here: libpng/libjpeg-turbo decoders and
// a std::thread batch fan-out, exposed over a C ABI for ctypes
// (v3d_tpu/native/imgdec.py).  Output is always RGBA8 (alpha = 255 for
// formats without one) — GObjaverse/Objaverse orbit renders carry the
// object matte in the alpha channel.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 imgdec.cc -o libimgdec.so
//        -lpng16 -ljpeg -pthread

#include <png.h>

#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <cstdint>
#include <thread>
#include <vector>

// jpeglib needs stdio types declared first
extern "C" {
#include <jpeglib.h>
}

namespace {

bool is_png(const uint8_t* data, int64_t len) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  return len >= 8 && std::memcmp(data, sig, 8) == 0;
}

bool is_jpeg(const uint8_t* data, int64_t len) {
  return len >= 3 && data[0] == 0xff && data[1] == 0xd8 && data[2] == 0xff;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// ---------------------------------------------------------------- PNG
int png_probe(const uint8_t* data, int64_t len, int* w, int* h) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, (size_t)len)) return -1;
  *w = (int)image.width;
  *h = (int)image.height;
  png_image_free(&image);
  return 0;
}

int png_decode(const uint8_t* data, int64_t len, uint8_t* out,
               int64_t out_cap, int* w, int* h) {
  png_image image;
  std::memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, (size_t)len)) return -1;
  image.format = PNG_FORMAT_RGBA;  // expands gray/palette/16-bit as needed
  const int64_t need = (int64_t)PNG_IMAGE_SIZE(image);
  if (need > out_cap) {
    png_image_free(&image);
    return -2;
  }
  if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) return -1;
  *w = (int)image.width;
  *h = (int)image.height;
  return 0;
}

// ---------------------------------------------------------------- JPEG
int jpeg_probe(const uint8_t* data, int64_t len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
  *w = (int)cinfo.image_width;
  *h = (int)cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                int64_t out_cap, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, (unsigned long)len);
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  // turbo writes 4-byte pixels directly; the X byte is undefined and gets
  // forced to 255 below
  cinfo.out_color_space = JCS_EXT_RGBX;
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);
  const int W = (int)cinfo.output_width, H = (int)cinfo.output_height;
  const int comps = cinfo.output_components;  // 4 (RGBX) or 3 (RGB)
  if ((int64_t)W * H * 4 > out_cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  std::vector<uint8_t> row(comps == 4 ? 0 : (size_t)W * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + (int64_t)cinfo.output_scanline * W * 4;
    if (comps == 4) {
      JSAMPROW r = dst;
      jpeg_read_scanlines(&cinfo, &r, 1);
    } else {
      JSAMPROW r = row.data();
      jpeg_read_scanlines(&cinfo, &r, 1);
      for (int x = 0; x < W; x++) {
        dst[4 * x + 0] = row[3 * x + 0];
        dst[4 * x + 1] = row[3 * x + 1];
        dst[4 * x + 2] = row[3 * x + 2];
      }
    }
  }
  // force opaque alpha (EXT_RGBX leaves byte 3 undefined)
  for (int64_t i = 0; i < (int64_t)W * H; i++) out[4 * i + 3] = 255;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = W;
  *h = H;
  return 0;
}

int decode_any(const uint8_t* data, int64_t len, uint8_t* out,
               int64_t out_cap, int* w, int* h) {
  if (is_png(data, len)) return png_decode(data, len, out, out_cap, w, h);
  if (is_jpeg(data, len)) return jpeg_decode(data, len, out, out_cap, w, h);
  return -3;
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize((size_t)n);
  size_t got = n ? std::fread(buf->data(), 1, (size_t)n, f) : 0;
  std::fclose(f);
  return got == (size_t)n ? 0 : -1;
}

}  // namespace

extern "C" {

// Probe dimensions without decoding.  Returns 0 on success.
int imgdec_probe(const uint8_t* data, int64_t len, int* w, int* h) {
  if (is_png(data, len)) return png_probe(data, len, w, h);
  if (is_jpeg(data, len)) return jpeg_probe(data, len, w, h);
  return -3;
}

// Decode one in-memory PNG/JPEG into caller-allocated RGBA8 `out`
// (capacity out_cap bytes).  Returns 0 on success, -2 if out is too small.
int imgdec_decode(const uint8_t* data, int64_t len, uint8_t* out,
                  int64_t out_cap, int* w, int* h) {
  return decode_any(data, len, out, out_cap, w, h);
}

// Decode `n` files in parallel into out[n, h, w, 4] (all must match w x h —
// the fixed-resolution training-archive case).  rcs[n] receives a per-item
// status (0 ok; nonzero: io/decode/size-mismatch).  Returns the failure
// count.
int imgdec_decode_batch(const char** paths, int n, uint8_t* out, int w,
                        int h, int threads, int* rcs) {
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  const int64_t item = (int64_t)w * h * 4;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    pool.emplace_back([&, t]() {
      std::vector<uint8_t> buf;
      for (int i = t; i < n; i += threads) {
        if (read_file(paths[i], &buf) != 0) {
          rcs[i] = -4;
          continue;
        }
        int dw = 0, dh = 0;
        int rc = decode_any(buf.data(), (int64_t)buf.size(),
                            out + (int64_t)i * item, item, &dw, &dh);
        rcs[i] = rc != 0 ? rc : (dw == w && dh == h ? 0 : -5);
      }
    });
  }
  for (auto& th : pool) th.join();
  int fails = 0;
  for (int i = 0; i < n; i++) fails += rcs[i] != 0;
  return fails;
}

}  // extern "C"
