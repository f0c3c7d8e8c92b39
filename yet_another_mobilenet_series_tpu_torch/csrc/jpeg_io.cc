// The port's host library: the copied native loader (yamt_loader.cc, included
// here unchanged, so its decode, crop, jitter and normalize functions are the
// ones this file calls) and what the port adds beside it:
//
// - yamt_decode_batch: JPEGs held in memory (TFRecord payloads) decoded and
//   transformed with the loader's own train transform (random-resized crop,
//   flip, colour jitter) or eval transform (resize the shorter side, centre
//   crop), by num_threads threads, into one batch. A row's draws depend on
//   (seed, its stream position) alone, as a loader batch's depend on (seed,
//   global batch, row);
// - yamt_jpeg_decode / yamt_jpeg_encode: one JPEG to RGB and back (the
//   fixtures' decoder and encoder);
// - yamt_crc32c: the CRC of the TFRecord framing;
// - yamt_codec: which JPEG library the build uses.
//
// Built by ops/host_build.py with g++ and native/Makefile's flags, against
// libjpeg where the host has it, else against nvJPEG through the libjpeg API
// in nvjpeg_compat/.

#include "yamt_loader.cc"

#include <cstdlib>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// decode_jpeg of the copied loader, reading from memory.
bool decode_jpeg_mem(const uint8_t* data, size_t size, std::vector<uint8_t>* out, int* w, int* h,
                     int target_min) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  int denom = 1;
  if (target_min > 0) {
    const int src_min = std::min<int>(cinfo.image_width, cinfo.image_height);
    while (denom < 8 && src_min / (denom * 2) >= target_min) denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// One row of a batch: Loader::fill_sample's transform on an image decoded
// from memory, with the row's generator seeded from (seed, position).
// Returns false when the JPEG does not decode (the row is then filled as the
// loader fills a failed sample).
bool fill_row(const Config& cfg, const uint8_t* data, size_t size, int64_t position, float* out_f32,
              uint8_t* out_u8) {
  const size_t tile = size_t(cfg.image_size) * cfg.image_size * 3;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  const bool ok = size > 0 && decode_jpeg_mem(data, size, &rgb, &w, &h, cfg.train ? 0 : cfg.eval_resize) &&
                  w > 0 && h > 0;
  if (!ok) {
    if (cfg.transfer_uint8) {
      for (size_t p = 0; p < tile; ++p)
        out_u8[p] = uint8_t(std::clamp(std::lround(cfg.mean[p % 3] * 255.0f), 0L, 255L));
    } else {
      std::memset(out_f32, 0, sizeof(float) * tile);
    }
    return false;
  }
  std::mt19937_64 rng(cfg.seed * 0x9E3779B97F4A7C15ULL ^ uint64_t(position) * 0x2545F4914F6CDD1DULL);
  std::vector<float> staging;
  float* dst = out_f32;
  if (cfg.transfer_uint8) {
    staging.resize(tile);
    dst = staging.data();
  }
  if (cfg.train) {
    int cx, cy, cw, ch;
    sample_rrc(rng, w, h, cfg, &cx, &cy, &cw, &ch);
    const bool flip = std::uniform_int_distribution<int>(0, 1)(rng) == 1;
    crop_resize(rgb.data(), w, h, cx, cy, cw, ch, dst, cfg.image_size, flip);
    if (cfg.color_jitter > 0.0f) {
      std::uniform_real_distribution<float> uj(1.0f - cfg.color_jitter, 1.0f + cfg.color_jitter);
      const float fb = uj(rng), fc = uj(rng), fs = uj(rng);
      color_jitter(dst, cfg.image_size, fb, fc, fs);
    }
  } else {
    const float scale = float(cfg.eval_resize) / std::min(w, h);
    const float crop_src = cfg.image_size / scale;
    const float cx = (w - crop_src) / 2.0f;
    const float cy = (h - crop_src) / 2.0f;
    crop_resize(rgb.data(), w, h, int(std::lround(cx)), int(std::lround(cy)), int(std::lround(crop_src)),
                int(std::lround(crop_src)), dst, cfg.image_size, false);
  }
  if (cfg.transfer_uint8) {
    for (size_t p = 0; p < tile; ++p) out_u8[p] = uint8_t(std::clamp(std::lround(dst[p]), 0L, 255L));
  } else {
    normalize(dst, cfg.image_size, cfg);
  }
  return true;
}

#if !defined(__SSE4_2__)
uint32_t crc32c_table[8][256];

void init_crc32c_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc32c_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      crc32c_table[t][i] = (crc32c_table[t - 1][i] >> 8) ^ crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
}
#endif

#define YAMT_STR2(x) #x
#define YAMT_STR(x) YAMT_STR2(x)

}  // namespace

extern "C" {

// Decodes rows 0..n-1 of a batch of `batch` rows from data[i] (sizes[i]
// bytes) with the train (train=1) or eval transform; rows n..batch-1 are
// padding. labels_out[i] is labels[i], or -1 for padding and, in eval, for
// a JPEG that does not decode. failed_out[i] is 1 for a row whose JPEG did not
// decode. Exactly one of images_f32 / images_u8 is written (transfer_uint8).
// Returns the number of rows that failed.
int64_t yamt_decode_batch(const uint8_t* const* data, const uint64_t* sizes, const int32_t* labels,
                          const int64_t* positions, int n, int batch, int image_size, int eval_resize,
                          int train, uint64_t seed, const float* mean, const float* std_, float area_min,
                          float area_max, float ratio_min, float ratio_max, float color_jitter_strength,
                          int transfer_uint8, int num_threads, float* images_f32, uint8_t* images_u8,
                          int32_t* labels_out, int32_t* failed_out) {
  const Config cfg{image_size, eval_resize, batch, num_threads, train, seed,
                   {mean[0], mean[1], mean[2]}, {std_[0], std_[1], std_[2]},
                   area_min, area_max, ratio_min, ratio_max,
                   train ? color_jitter_strength : 0.0f, 0, 0, transfer_uint8};
  const size_t tile = size_t(image_size) * image_size * 3;
  std::atomic<int> next{0};
  std::atomic<int64_t> failures{0};
  auto work = [&] {
    for (int i = next.fetch_add(1); i < batch; i = next.fetch_add(1)) {
      float* f = transfer_uint8 ? nullptr : images_f32 + size_t(i) * tile;
      uint8_t* u = transfer_uint8 ? images_u8 + size_t(i) * tile : nullptr;
      if (i >= n) {
        // padding, filled as the loader fills the padded tail of an eval pass
        fill_row(cfg, nullptr, 0, 0, f, u);
        labels_out[i] = -1;
        failed_out[i] = 0;
        continue;
      }
      const bool ok = fill_row(cfg, data[i], sizes[i], positions[i], f, u);
      failed_out[i] = ok ? 0 : 1;
      labels_out[i] = ok || train ? labels[i] : -1;
      if (!ok) failures.fetch_add(1);
    }
  };
  const int threads = std::max(1, std::min(num_threads, batch));
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failures.load();
}

// Decodes a JPEG to RGB rows, at the scale the eval transform decodes it at
// for a shorter side of target_min (0: full size). On success *out holds
// *w x *h x 3 bytes, to be released with yamt_free, and 0 is returned.
int yamt_jpeg_decode(const uint8_t* data, uint64_t size, int target_min, uint8_t** out, int* w, int* h) {
  std::vector<uint8_t> rgb;
  if (size == 0 || !decode_jpeg_mem(data, size, &rgb, w, h, target_min)) return -1;
  *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
  if (*out == nullptr) return -1;
  std::memcpy(*out, rgb.data(), rgb.size());
  return 0;
}

// Encodes a w x h RGB image (rows of 3*w bytes) at `quality`, 4:2:0. On
// success *out holds *size bytes, to be released with yamt_free, and 0 is
// returned.
int yamt_jpeg_encode(const uint8_t* rgb, int w, int h, int quality, uint8_t** out, uint64_t* size) {
  jpeg_compress_struct cinfo;
  JpegErr err;
  unsigned char* buffer = nullptr;
  unsigned long length = 0;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buffer, &length);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(rgb + size_t(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buffer;
  *size = length;
  return 0;
}

void yamt_free(void* p) { std::free(p); }

// CRC-32C (Castagnoli) of data[0..n), continuing from crc (0 to start).
uint32_t yamt_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  crc = ~crc;
#if defined(__SSE4_2__)
  uint64_t c = crc;
  for (; n >= 8; n -= 8, data += 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    c = _mm_crc32_u64(c, word);
  }
  crc = uint32_t(c);
  for (; n > 0; --n, ++data) crc = _mm_crc32_u8(crc, *data);
#else
  static std::once_flag once;
  std::call_once(once, init_crc32c_table);
  for (; n >= 8; n -= 8, data += 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = crc32c_table[7][lo & 0xFF] ^ crc32c_table[6][(lo >> 8) & 0xFF] ^ crc32c_table[5][(lo >> 16) & 0xFF] ^
          crc32c_table[4][lo >> 24] ^ crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
          crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
  }
  for (; n > 0; --n, ++data) crc = crc32c_table[0][(crc ^ *data) & 0xFF] ^ (crc >> 8);
#endif
  return ~crc;
}

// The JPEG library this build decodes and encodes with.
const char* yamt_codec() {
#if defined(YAMT_NVJPEG_COMPAT)
  static std::string name = std::string(yamt_nvjpeg_version()) + " (libjpeg API over nvJPEG, csrc/nvjpeg_compat)";
  return name.c_str();
#elif defined(LIBJPEG_TURBO_VERSION)
  return "libjpeg-turbo " YAMT_STR(LIBJPEG_TURBO_VERSION) " (JPEG_LIB_VERSION " YAMT_STR(JPEG_LIB_VERSION) ")";
#else
  return "libjpeg (JPEG_LIB_VERSION " YAMT_STR(JPEG_LIB_VERSION) ")";
#endif
}

// The card nvJPEG decodes on (a build against libjpeg ignores it).
void yamt_set_device(int device) {
#if defined(YAMT_NVJPEG_COMPAT)
  yamt_nvjpeg_set_device(device);
#else
  (void)device;
#endif
}

}  // extern "C"
