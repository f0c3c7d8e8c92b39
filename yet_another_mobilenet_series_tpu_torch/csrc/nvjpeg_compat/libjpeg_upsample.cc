// libjpeg's way from YCbCr planes to RGB, on the host, for the nvJPEG build
// of the loader: nvJPEG decodes a JPEG's planes (IDCT) on the card, and this
// file upsamples its chroma (where subsampled) and converts it as libjpeg does
// at scale 1/1 with its defaults (do_fancy_upsampling on):
//
// - jdsample.c's "fancy" triangle filter: h2v1_fancy_upsample,
//   h1v2_fancy_upsample and h2v2_fancy_upsample, with their edge columns,
//   their alternating rounding biases, and the plain replication libjpeg
//   falls back to where a chroma row is at most 2 samples wide (h2v1, h2v2);
// - jdmainct.c's context rows: the row above the first chroma row is that
//   row itself, the row below the last is the last;
// - jdcolor.c's ycc_rgb_convert: fixed point with SCALEBITS 16, clamped to
//   0..255. Its Cr_r_tab / Cb_b_tab / Cr_g_tab / Cb_g_tab tables are
//   computed in place, with the tables' own integer expressions, so that
//   the compiler can vectorize the loops.
//
// With fancy off (libjpeg's do_fancy_upsampling = FALSE, whose merged
// upsampler gives the same pixels) chroma is replicated instead: at a
// reduced scale libjpeg scales chroma up in its IDCT and filters nothing,
// which replication followed by a box average matches.
//
// Plain C++ with a C entry point and no library: it builds with g++ on any
// host, and tests hold it to libjpeg's own decodes bit for bit.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = int32_t(1) << (kScaleBits - 1);

constexpr int32_t fix(double x) { return int32_t(x * (1 << kScaleBits) + 0.5); }

inline uint8_t clamp255(int32_t v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One output row of a chroma plane at full width (2 * cw samples for
// hf == 2, cw for hf == 1) into out. `near` is the chroma row nearest the
// output row and `far` the next nearest (above for an even output row of a
// vf == 2 plane, below for an odd one, `below`); with vf == 1 far is near.
// cs is scratch of cw + 2 int16 (the column sums with one edge sample
// repeated on each side, which gives libjpeg's edge columns).
void upsample_row(const uint8_t* near, const uint8_t* far, int cw, int hf, int vf, bool below, bool fancy,
                  int16_t* cs, uint8_t* out) {
  if (!fancy || (hf == 2 && cw <= 2)) {  // libjpeg's replication (h2v1_upsample, h2v2_upsample)
    if (hf == 1) {
      for (int x = 0; x < cw; ++x) out[x] = near[x];
    } else {
      for (int x = 0; x < cw; ++x) out[2 * x] = out[2 * x + 1] = near[x];
    }
    return;
  }
  if (hf == 1 && vf == 1) {
    for (int x = 0; x < cw; ++x) out[x] = near[x];
  } else if (hf == 1) {  // h1v2_fancy_upsample
    const int bias = below ? 2 : 1;
    for (int x = 0; x < cw; ++x) out[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
  } else if (vf == 1) {  // h2v1_fancy_upsample: 3/4 nearer + 1/4 further, biases 1 and 2
    int16_t* v = cs + 1;
    for (int x = 0; x < cw; ++x) v[x] = near[x];
    v[-1] = v[0];
    v[cw] = v[cw - 1];
    for (int x = 0; x < cw; ++x) {
      out[2 * x] = uint8_t((v[x] * 3 + v[x - 1] + 1) >> 2);
      out[2 * x + 1] = uint8_t((v[x] * 3 + v[x + 1] + 2) >> 2);
    }
  } else {  // h2v2_fancy_upsample: 9/16, 3/16, 3/16, 1/16, biases 8 and 7
    int16_t* v = cs + 1;
    for (int x = 0; x < cw; ++x) v[x] = int16_t(near[x] * 3 + far[x]);
    v[-1] = v[0];
    v[cw] = v[cw - 1];
    for (int x = 0; x < cw; ++x) {
      out[2 * x] = uint8_t((v[x] * 3 + v[x - 1] + 8) >> 4);
      out[2 * x + 1] = uint8_t((v[x] * 3 + v[x + 1] + 7) >> 4);
    }
  }
}

// jdcolor.c's ycc_rgb_convert of one row.
void ycc_rgb_row(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int width, uint8_t* rgb) {
  for (int x = 0; x < width; ++x) {
    const int32_t yy = y[x], b = int32_t(cb[x]) - 128, r = int32_t(cr[x]) - 128;
    rgb[3 * x] = clamp255(yy + ((fix(1.40200) * r + kOneHalf) >> kScaleBits));            // Cr_r_tab
    rgb[3 * x + 1] = clamp255(yy + ((-fix(0.34414) * b + kOneHalf - fix(0.71414) * r)     // Cb_g_tab
                                    >> kScaleBits));                                        // + Cr_g_tab
    rgb[3 * x + 2] = clamp255(yy + ((fix(1.77200) * b + kOneHalf) >> kScaleBits));        // Cb_b_tab
  }
}

}  // namespace

// RGB rows (width * 3 bytes each, height rows) from a Y plane of width x
// height and Cb / Cr planes of cw x ch samples, where chroma is subsampled
// by hf horizontally and vf vertically (each 1 or 2), cw = ceil(width / hf)
// and ch = ceil(height / vf), upsampled with libjpeg's triangle filter
// (fancy != 0) or replicated. Pitches are in bytes. Returns 0, or -1 for
// arguments outside that contract.
extern "C" int yamt_ycc_to_rgb(const uint8_t* y, int y_pitch, const uint8_t* cb, const uint8_t* cr, int c_pitch,
                               int width, int height, int cw, int ch, int hf, int vf, int fancy, uint8_t* rgb) {
  if (width <= 0 || height <= 0 || (hf != 1 && hf != 2) || (vf != 1 && vf != 2) || cw != (width + hf - 1) / hf ||
      ch != (height + vf - 1) / vf || y_pitch < width || c_pitch < cw)
    return -1;
  std::vector<uint8_t> up(size_t(cw) * hf * 2);
  std::vector<int16_t> cs(size_t(cw) + 2);
  uint8_t* up_cb = up.data();
  uint8_t* up_cr = up_cb + size_t(cw) * hf;
  for (int oy = 0; oy < height; ++oy) {
    const int r = oy / vf;
    const bool below = vf == 2 && (oy & 1);
    int f = r;
    if (vf == 2) f = below ? (r + 1 < ch ? r + 1 : ch - 1) : (r > 0 ? r - 1 : 0);
    upsample_row(cb + size_t(r) * c_pitch, cb + size_t(f) * c_pitch, cw, hf, vf, below, fancy != 0, cs.data(),
                 up_cb);
    upsample_row(cr + size_t(r) * c_pitch, cr + size_t(f) * c_pitch, cw, hf, vf, below, fancy != 0, cs.data(),
                 up_cr);
    ycc_rgb_row(y + size_t(oy) * y_pitch, up_cb, up_cr, width, rgb + size_t(oy) * width * 3);
  }
  return 0;
}
