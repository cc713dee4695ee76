/* PNG scanline un-filtering (PNG 1.2 section 6) for io/png.py.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes, which drops
 * the interpreter lock for the call, so a frame loader's threads decode in
 * parallel.  The numpy twin is io/png._unfilter_plain.
 */
#include <stdint.h>
#include <stdlib.h>

/* raw: h rows of 1 + stride bytes (filter type, then the filtered bytes);
 * out: h rows of stride bytes.  bpp is the filter's byte distance (bytes
 * per complete pixel, at least 1).  Returns 0, or 1 + the first row whose
 * filter type is not 0-4 (out is then left partly written). */
int fl_png_unfilter(const uint8_t *raw, uint8_t *out, int h, int stride,
                    int bpp) {
  for (int r = 0; r < h; ++r) {
    const uint8_t *in = raw + (size_t)r * (stride + 1);
    uint8_t *cur = out + (size_t)r * stride;
    const uint8_t *up = r > 0 ? cur - stride : NULL;
    const uint8_t *x = in + 1;
    int i;
    switch (in[0]) {
      case 0:
        for (i = 0; i < stride; ++i) cur[i] = x[i];
        break;
      case 1:
        for (i = 0; i < stride && i < bpp; ++i) cur[i] = x[i];
        for (; i < stride; ++i) cur[i] = (uint8_t)(x[i] + cur[i - bpp]);
        break;
      case 2:
        for (i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(x[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          cur[i] = (uint8_t)(x[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(x[i] + pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}
