// PNG row unfilter, host C++ in the kernel library.
//
// Replaces: no Pallas kernel. The JAX package decodes its images on the
//   host through PIL (sm3det_tpu/utils/image.py:47); the port's PNG reader
//   (sm3det_tpu_torch/utils/image.py) inflates IDAT with zlib and undoes
//   the row filters here. Its plain version is png_unfilter_ref there.
//
// Why the host: decoding runs in the data loaders' producer threads, which
//   must add no device work and no sync to the loop. ctypes releases the
//   GIL for the call, so producer threads decode in parallel.
//
// Contract: src holds height rows of 1 + row_bytes bytes (the filter type,
//   then the filtered bytes); dst gets height x row_bytes bytes. bpp is the
//   bytes a pixel (the distance to the left neighbour, at least 1). Returns
//   0, or 1 + the row whose filter type is not 0-4.
//
// Bound: one pass over the bytes; Sub, Average and Paeth depend on the
//   byte bpp to the left, so a row is sequential. None and Up are copies.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

extern "C" int sm3det_png_unfilter(const uint8_t* src, uint8_t* dst,
                                   int height, int row_bytes, int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* f = src + static_cast<size_t>(y) * (row_bytes + 1);
    const int type = f[0];
    ++f;
    uint8_t* cur = dst + static_cast<size_t>(y) * row_bytes;
    const uint8_t* up = y > 0 ? cur - row_bytes : nullptr;
    switch (type) {
      case 0:
        std::memcpy(cur, f, row_bytes);
        break;
      case 1:
        for (int x = 0; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(f[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(f[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = static_cast<uint8_t>(f[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < row_bytes; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          cur[x] = static_cast<uint8_t>(f[x] + paeth(a, b, c));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
