// libjpeg's own view of a JPEG, for holding libjpeg_upsample.cc to it (the
// tests build this file with g++ and -ljpeg, where libjpeg is installed; the
// loader never links it):
//
// - yamt_libjpeg_info: width, height, components, and each component's
//   sampling factors and downsampled size;
// - yamt_libjpeg_planes: the components after libjpeg's IDCT and before
//   its upsampling and colour conversion (raw_data_out), as tight planes;
// - yamt_libjpeg_rgb: libjpeg's RGB decode with its defaults, or with
//   do_fancy_upsampling off.
//
// Each returns 0, or -1 when libjpeg raises (its message is dropped).

#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) { longjmp(reinterpret_cast<ErrorMgr*>(cinfo->err)->jump, 1); }

// Runs fn(cinfo) on a decompressor reading data; -1 if libjpeg raised.
template <typename Fn>
int with_decompressor(const unsigned char* data, unsigned long size, Fn fn) {
  jpeg_decompress_struct cinfo;
  ErrorMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = error_exit;
  jpeg_create_decompress(&cinfo);
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_mem_src(&cinfo, data, size);
  jpeg_read_header(&cinfo, TRUE);
  fn(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

// info: width, height, components, then per component (at most 3) h_samp,
// v_samp, downsampled width, downsampled height: 3 + 4 * 3 ints.
extern "C" int yamt_libjpeg_info(const unsigned char* data, unsigned long size, int* info) {
  return with_decompressor(data, size, [&](j_decompress_ptr cinfo) {
    cinfo->raw_data_out = TRUE;
    jpeg_start_decompress(cinfo);
    info[0] = int(cinfo->image_width);
    info[1] = int(cinfo->image_height);
    info[2] = cinfo->num_components;
    for (int c = 0; c < cinfo->num_components && c < 3; ++c) {
      const jpeg_component_info& comp = cinfo->comp_info[c];
      info[3 + 4 * c] = comp.h_samp_factor;
      info[4 + 4 * c] = comp.v_samp_factor;
      info[5 + 4 * c] = int(comp.downsampled_width);
      info[6 + 4 * c] = int(comp.downsampled_height);
    }
    jpeg_abort_decompress(cinfo);
  });
}

// planes[c]: downsampled width x height bytes of component c, c < 3.
extern "C" int yamt_libjpeg_planes(const unsigned char* data, unsigned long size, unsigned char** planes) {
  return with_decompressor(data, size, [&](j_decompress_ptr cinfo) {
    cinfo->raw_data_out = TRUE;
    jpeg_start_decompress(cinfo);
    const int ncomp = cinfo->num_components < 3 ? cinfo->num_components : 3;
    const int lines = cinfo->max_v_samp_factor * DCTSIZE;
    std::vector<std::vector<JSAMPLE>> bufs(cinfo->num_components);
    std::vector<std::vector<JSAMPROW>> rows(cinfo->num_components);
    std::vector<JSAMPARRAY> image(cinfo->num_components);
    for (int c = 0; c < cinfo->num_components; ++c) {
      const jpeg_component_info& comp = cinfo->comp_info[c];
      const size_t pitch = size_t(comp.width_in_blocks) * DCTSIZE;
      const int n = comp.v_samp_factor * DCTSIZE;
      bufs[c].resize(pitch * n);
      for (int i = 0; i < n; ++i) rows[c].push_back(bufs[c].data() + i * pitch);
      image[c] = rows[c].data();
    }
    int group = 0;
    while (cinfo->output_scanline < cinfo->output_height) {
      jpeg_read_raw_data(cinfo, image.data(), JDIMENSION(lines));
      for (int c = 0; c < ncomp; ++c) {
        const jpeg_component_info& comp = cinfo->comp_info[c];
        const int n = comp.v_samp_factor * DCTSIZE;
        for (int i = 0; i < n; ++i) {
          const int row = group * n + i;
          if (row < int(comp.downsampled_height))
            std::memcpy(planes[c] + size_t(row) * comp.downsampled_width, rows[c][i], comp.downsampled_width);
        }
      }
      ++group;
    }
    jpeg_finish_decompress(cinfo);
  });
}

// rgb: width x height x 3 bytes.
extern "C" int yamt_libjpeg_rgb(const unsigned char* data, unsigned long size, int fancy, unsigned char* rgb) {
  return with_decompressor(data, size, [&](j_decompress_ptr cinfo) {
    cinfo->out_color_space = JCS_RGB;
    cinfo->do_fancy_upsampling = fancy ? TRUE : FALSE;
    jpeg_start_decompress(cinfo);
    const size_t row = size_t(cinfo->output_width) * 3;
    while (cinfo->output_scanline < cinfo->output_height) {
      JSAMPROW line = rgb + size_t(cinfo->output_scanline) * row;
      jpeg_read_scanlines(cinfo, &line, 1);
    }
    jpeg_finish_decompress(cinfo);
  });
}
