// The part of libjpeg's API that the port's host code calls (csrc/yamt_loader.cc,
// csrc/jpeg_io.cc), implemented over nvJPEG from the CUDA toolkit
// (jpeglib_nvjpeg.cc). It is built in place of libjpeg on a host that has the
// toolkit and no libjpeg (ops/host_build.py puts this directory first on the
// include path), so that the copied loader compiles unchanged.
//
// What differs from libjpeg:
// - decode runs on the card (nvJPEG's default backend: Huffman decoding on the
//   calling thread, the IDCT and colour conversion on a stream of its own), and
//   the RGB image is copied back to the host when decompression starts. A
//   4:4:4, 4:2:0, 4:2:2 or 4:4:0 image comes back as its YCbCr planes
//   instead, which libjpeg_upsample.cc upsamples (where subsampled) and
//   converts as libjpeg does, so only the IDCT's rounding differs from
//   libjpeg there; grayscale, 4:1:1 and 4:1:0 keep nvJPEG's conversion;
// - a scaled decode (scale_denom 2, 4, 8) averages denom x denom blocks of the
//   full-size image (its chroma replicated, not filtered), where libjpeg runs
//   a reduced IDCT; the output size is libjpeg's, ceil(size / denom);
// - encode takes RGB scanlines, 4:2:0, at the quality set.
// Only out_color_space JCS_RGB and in_color_space JCS_RGB are supported. A
// failure calls err->error_exit, as libjpeg does.

#ifndef YAMT_NVJPEG_COMPAT_JPEGLIB_H
#define YAMT_NVJPEG_COMPAT_JPEGLIB_H

#include <cstddef>
#include <cstdio>

#define YAMT_NVJPEG_COMPAT 1

typedef int boolean;
#ifndef TRUE
#define TRUE 1
#endif
#ifndef FALSE
#define FALSE 0
#endif

typedef unsigned char JSAMPLE;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;
typedef unsigned int JDIMENSION;

enum J_COLOR_SPACE { JCS_UNKNOWN, JCS_GRAYSCALE, JCS_RGB, JCS_YCbCr, JCS_CMYK, JCS_YCCK };

#define JPEG_HEADER_OK 1
#define JMSG_LENGTH_MAX 200

struct jpeg_common_struct;
typedef jpeg_common_struct* j_common_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo);
  char last_message[JMSG_LENGTH_MAX];  // what failed, set before error_exit
};

// The fields every struct below begins with.
struct jpeg_common_struct {
  jpeg_error_mgr* err;
  void* compat;  // the implementation's state
};

struct jpeg_decompress_struct {
  jpeg_error_mgr* err;
  void* compat;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int num_components;
  J_COLOR_SPACE out_color_space;
  unsigned int scale_num;
  unsigned int scale_denom;
  JDIMENSION output_width;
  JDIMENSION output_height;
  int output_components;
  JDIMENSION output_scanline;
};
typedef jpeg_decompress_struct* j_decompress_ptr;

struct jpeg_compress_struct {
  jpeg_error_mgr* err;
  void* compat;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int input_components;
  J_COLOR_SPACE in_color_space;
  JDIMENSION next_scanline;
};
typedef jpeg_compress_struct* j_compress_ptr;

jpeg_error_mgr* jpeg_std_error(jpeg_error_mgr* err);

void jpeg_create_decompress(j_decompress_ptr cinfo);
void jpeg_stdio_src(j_decompress_ptr cinfo, FILE* infile);
void jpeg_mem_src(j_decompress_ptr cinfo, const unsigned char* inbuffer, unsigned long insize);
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY scanlines, JDIMENSION max_lines);
boolean jpeg_finish_decompress(j_decompress_ptr cinfo);
void jpeg_destroy_decompress(j_decompress_ptr cinfo);

void jpeg_create_compress(j_compress_ptr cinfo);
void jpeg_mem_dest(j_compress_ptr cinfo, unsigned char** outbuffer, unsigned long* outsize);
void jpeg_set_defaults(j_compress_ptr cinfo);
void jpeg_set_quality(j_compress_ptr cinfo, int quality, boolean force_baseline);
void jpeg_start_compress(j_compress_ptr cinfo, boolean write_all_tables);
JDIMENSION jpeg_write_scanlines(j_compress_ptr cinfo, JSAMPARRAY scanlines, JDIMENSION num_lines);
void jpeg_finish_compress(j_compress_ptr cinfo);
void jpeg_destroy_compress(j_compress_ptr cinfo);

// "nvJPEG <major>.<minor>.<patch>" of the library loaded.
const char* yamt_nvjpeg_version();
// The card that decodes and encodes (default 0); set before the first call.
void yamt_nvjpeg_set_device(int device);

#endif  // YAMT_NVJPEG_COMPAT_JPEGLIB_H
