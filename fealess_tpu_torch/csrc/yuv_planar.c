/* Raw planar YUV frames for io/rawvideo.py: FFmpeg's rawvideo decoder
 * hands cv2 the file's planes as they are, and swscale converts them to
 * BGR24 (yuv_bgr.h).  Host C, no CUDA: built with the host compiler into a
 * shared library at first use (ops/_build.build_host) and called through
 * ctypes. */
#include "yuv_bgr.h"

/* yuv420p (chroma at half width and half height, rounded up) to BGR
 * (H, W, 3); strides: luma, chroma.  full_range 0 is the limited range
 * FFmpeg gives raw I420. */
int fl_yuv420p_to_bgr(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                      const long *strides, int W, int H, int full_range,
                      uint8_t *out) {
  yuv_planes_t p = {y, u, v, strides[0], strides[1]};
  return yuv_to_bgr(&p, W, H, 1, 1, full_range, out);
}
