// PNG scanline unfiltering (ISO/IEC 15948 section 9) for
// fovtrace_torch/scene/image_io.py: the filters are sequential along a
// row (each byte predicts from the decoded byte bpp to its left), which a
// Python loop decodes at about a microsecond a byte.
//
// raw:  h rows of 1 + stride bytes (filter type, then the filtered row)
// out:  h rows of stride decoded bytes
// Returns 0, or 1 + the row index whose filter type is not 0-4.

#include <cstdint>
#include <cstdlib>

extern "C" int64_t fov_png_unfilter(const uint8_t* raw, int64_t h,
                                    int64_t stride, int64_t bpp,
                                    uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ft = in[0];
    ++in;
    uint8_t* row = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = prev ? prev[x] : 0;
      const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      row[x] = (uint8_t)(in[x] + pred);
    }
  }
  return 0;
}
