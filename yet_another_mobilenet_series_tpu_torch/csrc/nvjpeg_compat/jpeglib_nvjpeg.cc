// libjpeg's decompress/compress API over nvJPEG: see jpeglib.h beside this file.
//
// Each calling thread owns an nvJPEG decode state, an encoder state, a CUDA
// stream and a device buffer (made at its first call, freed when it exits);
// the library handle is shared. A call does its work and waits on its own
// stream only, so the loader's worker threads decode in parallel and never
// wait on the trainer's streams.
//
// Every API function that can fail keeps only trivially destructible locals:
// a failure calls err->error_exit, which longjmps out of it (the copied
// loader's jpeg_err_exit), and the state it owns is released by
// jpeg_destroy_decompress / jpeg_destroy_compress.

#include "jpeglib.h"

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

// libjpeg_upsample.cc
extern "C" int yamt_ycc_to_rgb(const uint8_t* y, int y_pitch, const uint8_t* cb, const uint8_t* cr, int c_pitch,
                               int width, int height, int cw, int ch, int hf, int vf, int fancy, uint8_t* rgb);

namespace {

std::atomic<int> g_device{0};

struct DecompState {
  std::vector<unsigned char> owned;  // a file's bytes (jpeg_stdio_src)
  const unsigned char* data = nullptr;
  size_t size = 0;
  // jpeg_read_header's nvjpegGetImageInfo: the chroma subsampling and each
  // component's size
  nvjpegChromaSubsampling_t subsampling = NVJPEG_CSS_UNKNOWN;
  int ncomp = 0;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  std::vector<unsigned char> planes;  // Y, Cb, Cr of an image the host converts
  std::vector<unsigned char> rgb;  // the output image, RGB rows
};

struct CompState {
  unsigned char** outbuffer = nullptr;
  unsigned long* outsize = nullptr;
  int quality = 75;
  std::vector<unsigned char> rgb;
};

nvjpegHandle_t shared_handle(const char** err) {
  static nvjpegHandle_t handle = nullptr;
  static nvjpegStatus_t status = NVJPEG_STATUS_SUCCESS;
  static std::once_flag once;
  std::call_once(once, [] {
    cudaSetDevice(g_device.load());
    status = nvjpegCreateSimple(&handle);
  });
  if (status != NVJPEG_STATUS_SUCCESS) {
    *err = "nvjpegCreateSimple failed (is there a CUDA device?)";
    return nullptr;
  }
  return handle;
}

struct ThreadCtx {
  bool ready = false;
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* dev = nullptr;
  size_t cap = 0;

  ~ThreadCtx() {
    // at process exit the runtime may be gone already: errors are ignored
    if (dev != nullptr) cudaFree(dev);
    if (enc_params != nullptr) nvjpegEncoderParamsDestroy(enc_params);
    if (enc_state != nullptr) nvjpegEncoderStateDestroy(enc_state);
    if (state != nullptr) nvjpegJpegStateDestroy(state);
    if (stream != nullptr) cudaStreamDestroy(stream);
  }
};

thread_local ThreadCtx t_ctx;

// This thread's context, made at its first use; nullptr and *err on failure.
ThreadCtx* thread_ctx(nvjpegHandle_t* handle, const char** err) {
  *handle = shared_handle(err);
  if (*handle == nullptr) return nullptr;
  ThreadCtx& c = t_ctx;
  if (!c.ready) {
    if (cudaSetDevice(g_device.load()) != cudaSuccess ||
        cudaStreamCreateWithFlags(&c.stream, cudaStreamNonBlocking) != cudaSuccess) {
      *err = "cudaStreamCreate failed";
      return nullptr;
    }
    if (nvjpegJpegStateCreate(*handle, &c.state) != NVJPEG_STATUS_SUCCESS) {
      *err = "nvjpegJpegStateCreate failed";
      return nullptr;
    }
    c.ready = true;
  }
  return &c;
}

bool reserve_device(ThreadCtx* c, size_t bytes) {
  if (bytes <= c->cap) return true;
  if (c->dev != nullptr) cudaFree(c->dev);
  c->dev = nullptr;
  c->cap = 0;
  if (cudaMalloc(reinterpret_cast<void**>(&c->dev), bytes) != cudaSuccess) return false;
  c->cap = bytes;
  return true;
}

// Whether the host converts st's planes to RGB as libjpeg does
// (libjpeg_upsample.cc), and their chroma factors across (*hf) and down
// (*vf): 4:4:4 (1, 1: no upsampling, libjpeg's colour conversion alone),
// and 4:2:0, 4:2:2 and 4:4:0, which libjpeg upsamples with its triangle
// filter. False for the rest (grayscale, 4:1:1, 4:1:0), which nvJPEG
// converts itself.
bool host_converts(const DecompState* st, int* hf, int* vf) {
  if (st->ncomp != 3) return false;
  switch (st->subsampling) {
    case NVJPEG_CSS_444: *hf = 1; *vf = 1; return true;
    case NVJPEG_CSS_420: *hf = 2; *vf = 2; return true;
    case NVJPEG_CSS_422: *hf = 2; *vf = 1; return true;
    case NVJPEG_CSS_440: *hf = 1; *vf = 2; return true;
    default: return false;
  }
}

// Decodes an image's planes (nvJPEG's YUV output: Y at full size, Cb and Cr
// at their own) on the card, then upsamples subsampled chroma (with
// libjpeg's triangle filter when fancy, else by replication) and converts
// them on the host as libjpeg does (libjpeg_upsample.cc); returns an error
// or nullptr.
const char* decode_planes(DecompState* st, ThreadCtx* c, nvjpegHandle_t handle, int w, int h, int hf, int vf,
                          bool fancy) {
  const int cw = (w + hf - 1) / hf, ch = (h + vf - 1) / vf;
  const size_t cpitch = size_t(std::max(st->widths[1], st->widths[2]));
  const size_t crows = size_t(std::max(st->heights[1], st->heights[2]));
  if (cpitch < size_t(cw) || crows < size_t(ch)) return "nvJPEG's chroma planes are smaller than libjpeg's";
  const size_t luma = size_t(w) * h, chroma = cpitch * crows;
  if (!reserve_device(c, luma + 2 * chroma)) return "cudaMalloc of the decode buffer failed";
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = size_t(w);
  img.channel[1] = c->dev + luma;
  img.pitch[1] = cpitch;
  img.channel[2] = c->dev + luma + chroma;
  img.pitch[2] = cpitch;
  if (nvjpegDecode(handle, c->state, st->data, st->size, NVJPEG_OUTPUT_YUV, &img, c->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return "nvjpegDecode failed";
  st->planes.resize(luma + 2 * chroma);
  if (cudaMemcpyAsync(st->planes.data(), c->dev, st->planes.size(), cudaMemcpyDeviceToHost, c->stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return "copying the decoded planes to the host failed";
  st->rgb.resize(luma * 3);
  const unsigned char* y = st->planes.data();
  if (yamt_ycc_to_rgb(y, w, y + luma, y + luma + chroma, int(cpitch), w, h, cw, ch, hf, vf, fancy,
                      st->rgb.data()) != 0)
    return "yamt_ycc_to_rgb refused the planes";
  return nullptr;
}

// Decodes st->data into st->rgb at full size; returns an error or nullptr.
// fancy: libjpeg's triangle filter on subsampled chroma (a full-scale
// decode); off, chroma is replicated, which a reduced-scale decode then
// box-averages: there libjpeg scales chroma up in its IDCT, unfiltered.
const char* decode_full(DecompState* st, int w, int h, bool fancy) {
  nvjpegHandle_t handle;
  const char* err = nullptr;
  ThreadCtx* c = thread_ctx(&handle, &err);
  if (c == nullptr) return err;
  int hf = 1, vf = 1;
  if (host_converts(st, &hf, &vf)) return decode_planes(st, c, handle, w, h, hf, vf, fancy);
  const size_t pitch = size_t(w) * 3;
  if (!reserve_device(c, pitch * h)) return "cudaMalloc of the decode buffer failed";
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = pitch;
  if (nvjpegDecode(handle, c->state, st->data, st->size, NVJPEG_OUTPUT_RGBI, &img, c->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return "nvjpegDecode failed";
  st->rgb.resize(pitch * h);
  if (cudaMemcpyAsync(st->rgb.data(), c->dev, pitch * h, cudaMemcpyDeviceToHost, c->stream) != cudaSuccess ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return "copying the decoded image to the host failed";
  return nullptr;
}

// Averages denom x denom blocks of the w x h image in st->rgb into an
// ow x oh one (blocks at the right and bottom edges may be partial).
void box_reduce(DecompState* st, int w, int h, int denom, int ow, int oh) {
  std::vector<unsigned char> out(size_t(ow) * oh * 3);
  for (int oy = 0; oy < oh; ++oy) {
    const int y0 = oy * denom, y1 = std::min(y0 + denom, h);
    for (int ox = 0; ox < ow; ++ox) {
      const int x0 = ox * denom, x1 = std::min(x0 + denom, w);
      const int n = (y1 - y0) * (x1 - x0);
      for (int ch = 0; ch < 3; ++ch) {
        int sum = 0;
        for (int y = y0; y < y1; ++y)
          for (int x = x0; x < x1; ++x) sum += st->rgb[(size_t(y) * w + x) * 3 + ch];
        out[(size_t(oy) * ow + ox) * 3 + ch] = static_cast<unsigned char>((sum + n / 2) / n);
      }
    }
  }
  st->rgb.swap(out);
}

const char* encode(CompState* st, int w, int h, std::vector<unsigned char>* out) {
  nvjpegHandle_t handle;
  const char* err = nullptr;
  ThreadCtx* c = thread_ctx(&handle, &err);
  if (c == nullptr) return err;
  if (c->enc_state == nullptr) {
    if (nvjpegEncoderStateCreate(handle, &c->enc_state, c->stream) != NVJPEG_STATUS_SUCCESS ||
        nvjpegEncoderParamsCreate(handle, &c->enc_params, c->stream) != NVJPEG_STATUS_SUCCESS)
      return "creating the nvJPEG encoder failed";
  }
  if (nvjpegEncoderParamsSetQuality(c->enc_params, st->quality, c->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420, c->stream) != NVJPEG_STATUS_SUCCESS)
    return "setting the nvJPEG encoder's parameters failed";
  const size_t pitch = size_t(w) * 3;
  if (!reserve_device(c, pitch * h)) return "cudaMalloc of the encode buffer failed";
  if (cudaMemcpyAsync(c->dev, st->rgb.data(), pitch * h, cudaMemcpyHostToDevice, c->stream) != cudaSuccess)
    return "copying the image to the card failed";
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = c->dev;
  img.pitch[0] = pitch;
  if (nvjpegEncodeImage(handle, c->enc_state, c->enc_params, &img, NVJPEG_INPUT_RGBI, w, h, c->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return "nvjpegEncodeImage failed";
  size_t length = 0;
  if (nvjpegEncodeRetrieveBitstream(handle, c->enc_state, nullptr, &length, c->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return "nvjpegEncodeRetrieveBitstream failed";
  out->resize(length);
  if (nvjpegEncodeRetrieveBitstream(handle, c->enc_state, out->data(), &length, c->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(c->stream) != cudaSuccess)
    return "nvjpegEncodeRetrieveBitstream failed";
  out->resize(length);
  return nullptr;
}

void fail(j_common_ptr cinfo, const char* msg) {
  std::strncpy(cinfo->err->last_message, msg, JMSG_LENGTH_MAX - 1);
  cinfo->err->last_message[JMSG_LENGTH_MAX - 1] = '\0';
  cinfo->err->error_exit(cinfo);
  std::abort();  // error_exit must not return
}

void default_error_exit(j_common_ptr cinfo) {
  std::fprintf(stderr, "jpeg (nvJPEG): %s\n", cinfo->err->last_message);
  std::exit(EXIT_FAILURE);
}

DecompState* dstate(j_decompress_ptr cinfo) { return static_cast<DecompState*>(cinfo->compat); }
CompState* cstate(j_compress_ptr cinfo) { return static_cast<CompState*>(cinfo->compat); }

}  // namespace

jpeg_error_mgr* jpeg_std_error(jpeg_error_mgr* err) {
  err->error_exit = default_error_exit;
  err->last_message[0] = '\0';
  return err;
}

void jpeg_create_decompress(j_decompress_ptr cinfo) {
  jpeg_error_mgr* err = cinfo->err;
  std::memset(cinfo, 0, sizeof(*cinfo));
  cinfo->err = err;
  cinfo->compat = new DecompState();
  cinfo->scale_num = cinfo->scale_denom = 1;
}

void jpeg_stdio_src(j_decompress_ptr cinfo, FILE* infile) {
  DecompState* st = dstate(cinfo);
  st->owned.clear();
  unsigned char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), infile)) > 0) st->owned.insert(st->owned.end(), chunk, chunk + got);
  st->data = st->owned.data();
  st->size = st->owned.size();
}

void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* inbuffer, unsigned long insize) {
  DecompState* st = dstate(cinfo);
  st->data = inbuffer;
  st->size = insize;
}

int jpeg_read_header(j_decompress_ptr cinfo, boolean) {
  DecompState* st = dstate(cinfo);
  nvjpegHandle_t handle;
  const char* err = nullptr;
  if (thread_ctx(&handle, &err) == nullptr) fail(reinterpret_cast<j_common_ptr>(cinfo), err);
  if (st->size == 0 ||
      nvjpegGetImageInfo(handle, st->data, st->size, &st->ncomp, &st->subsampling, st->widths, st->heights) !=
          NVJPEG_STATUS_SUCCESS ||
      st->widths[0] <= 0 || st->heights[0] <= 0)
    fail(reinterpret_cast<j_common_ptr>(cinfo), "not a JPEG nvJPEG can read");
  cinfo->image_width = JDIMENSION(st->widths[0]);
  cinfo->image_height = JDIMENSION(st->heights[0]);
  cinfo->num_components = st->ncomp;
  cinfo->out_color_space = JCS_RGB;
  cinfo->scale_num = cinfo->scale_denom = 1;
  return JPEG_HEADER_OK;
}

boolean jpeg_start_decompress(j_decompress_ptr cinfo) {
  const unsigned int d = cinfo->scale_denom;
  if (cinfo->out_color_space != JCS_RGB || cinfo->scale_num != 1 || (d != 1 && d != 2 && d != 4 && d != 8))
    fail(reinterpret_cast<j_common_ptr>(cinfo), "only RGB output at scale 1/1, 1/2, 1/4 or 1/8");
  const int w = int(cinfo->image_width), h = int(cinfo->image_height);
  const char* err = decode_full(dstate(cinfo), w, h, d == 1);
  if (err != nullptr) fail(reinterpret_cast<j_common_ptr>(cinfo), err);
  cinfo->output_width = (cinfo->image_width + d - 1) / d;  // libjpeg's jdiv_round_up
  cinfo->output_height = (cinfo->image_height + d - 1) / d;
  if (d > 1) box_reduce(dstate(cinfo), w, h, int(d), int(cinfo->output_width), int(cinfo->output_height));
  cinfo->output_components = 3;
  cinfo->output_scanline = 0;
  return TRUE;
}

JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY scanlines, JDIMENSION max_lines) {
  DecompState* st = dstate(cinfo);
  const size_t row = size_t(cinfo->output_width) * 3;
  JDIMENSION n = 0;
  while (n < max_lines && cinfo->output_scanline < cinfo->output_height) {
    std::memcpy(scanlines[n], st->rgb.data() + size_t(cinfo->output_scanline) * row, row);
    ++cinfo->output_scanline;
    ++n;
  }
  return n;
}

boolean jpeg_finish_decompress(j_decompress_ptr) { return TRUE; }

void jpeg_destroy_decompress(j_decompress_ptr cinfo) {
  delete dstate(cinfo);
  cinfo->compat = nullptr;
}

void jpeg_create_compress(j_compress_ptr cinfo) {
  jpeg_error_mgr* err = cinfo->err;
  std::memset(cinfo, 0, sizeof(*cinfo));
  cinfo->err = err;
  cinfo->compat = new CompState();
}

void jpeg_mem_dest(j_compress_ptr cinfo, unsigned char** outbuffer, unsigned long* outsize) {
  cstate(cinfo)->outbuffer = outbuffer;
  cstate(cinfo)->outsize = outsize;
}

void jpeg_set_defaults(j_compress_ptr cinfo) { cstate(cinfo)->quality = 75; }

void jpeg_set_quality(j_compress_ptr cinfo, int quality, boolean) {
  cstate(cinfo)->quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
}

void jpeg_start_compress(j_compress_ptr cinfo, boolean) {
  if (cinfo->in_color_space != JCS_RGB || cinfo->input_components != 3 || cinfo->image_width == 0 ||
      cinfo->image_height == 0 || cstate(cinfo)->outbuffer == nullptr)
    fail(reinterpret_cast<j_common_ptr>(cinfo), "only RGB input to a memory destination");
  cstate(cinfo)->rgb.assign(size_t(cinfo->image_width) * cinfo->image_height * 3, 0);
  cinfo->next_scanline = 0;
}

JDIMENSION jpeg_write_scanlines(j_compress_ptr cinfo, JSAMPARRAY scanlines, JDIMENSION num_lines) {
  CompState* st = cstate(cinfo);
  const size_t row = size_t(cinfo->image_width) * 3;
  JDIMENSION n = 0;
  while (n < num_lines && cinfo->next_scanline < cinfo->image_height) {
    std::memcpy(st->rgb.data() + size_t(cinfo->next_scanline) * row, scanlines[n], row);
    ++cinfo->next_scanline;
    ++n;
  }
  return n;
}

void jpeg_finish_compress(j_compress_ptr cinfo) {
  CompState* st = cstate(cinfo);
  if (cinfo->next_scanline != cinfo->image_height)
    fail(reinterpret_cast<j_common_ptr>(cinfo), "finish_compress before every scanline was written");
  std::vector<unsigned char>* bits = new std::vector<unsigned char>();
  const char* err = encode(st, int(cinfo->image_width), int(cinfo->image_height), bits);
  if (err == nullptr) {
    unsigned char* out = static_cast<unsigned char*>(std::malloc(bits->size()));
    if (out == nullptr) {
      err = "out of memory";
    } else {
      std::memcpy(out, bits->data(), bits->size());
      *st->outbuffer = out;  // the caller frees it with free(), as with libjpeg
      *st->outsize = static_cast<unsigned long>(bits->size());
    }
  }
  delete bits;
  if (err != nullptr) fail(reinterpret_cast<j_common_ptr>(cinfo), err);
}

void jpeg_destroy_compress(j_compress_ptr cinfo) {
  delete cstate(cinfo);
  cinfo->compat = nullptr;
}

const char* yamt_nvjpeg_version() {
  static std::string version = [] {
    int major = 0, minor = 0, patch = 0;
    nvjpegGetProperty(MAJOR_VERSION, &major);
    nvjpegGetProperty(MINOR_VERSION, &minor);
    nvjpegGetProperty(PATCH_LEVEL, &patch);
    return "nvJPEG " + std::to_string(major) + "." + std::to_string(minor) + "." + std::to_string(patch);
  }();
  return version.c_str();
}

void yamt_nvjpeg_set_device(int device) { g_device.store(device); }
