// The PNG row filters undone on the host, for data/codec.py:decode_png: None,
// Sub, Up, Average and Paeth, as the PNG specification defines them (section
// 9). Each byte of an Average or Paeth row needs its left neighbour's result,
// so a row is one sequential pass, which numpy cannot vectorise.
//
// Built with the host compiler by data/native_ops.py:build, like native/warp.cc.

#include <cstdint>
#include <cstdlib>

// raw: height rows of (filter byte, stride bytes), as zlib inflates them.
// out: height rows of stride bytes. bpp: bytes per pixel (the left neighbour's
// distance). Returns 0, or 1 + the row whose filter type is not 0-4.
extern "C" int poem_png_unfilter(const uint8_t* raw, int height, int stride, int bpp,
                                 uint8_t* out) {
  const uint8_t* prev = nullptr;  // the row above, already undone; zeros above row 0
  for (int r = 0; r < height; ++r, raw += stride + 1, out += stride) {
    const uint8_t* x = raw + 1;
    switch (raw[0]) {
      case 0:
        for (int i = 0; i < stride; ++i) out[i] = x[i];
        break;
      case 1:
        for (int i = 0; i < stride; ++i) out[i] = uint8_t(x[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; ++i) out[i] = uint8_t(x[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0, b = prev ? prev[i] : 0;
          out[i] = uint8_t(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0, b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          out[i] = uint8_t(x[i] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return r + 1;
    }
    prev = out;
  }
  return 0;
}
