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

/* The same planes through swscale's scaler at every size, the path NV12
 * takes (x86 has no unscaled NV12 to BGR24 converter): chroma at half
 * width through the vertical filter for an even width, full chroma
 * interpolation for an odd one.  The caller splits NV12's interleaved
 * chroma into the two planes. */
int fl_yuv420p_scaled_to_bgr(const uint8_t *y, const uint8_t *u,
                             const uint8_t *v, const long *strides, int W,
                             int H, int full_range, uint8_t *out) {
  yuv_planes_t p = {y, u, v, strides[0], strides[1]};
  if (W & 1) return full_chroma(&p, W, H, 1, 1, full_range, out);
  return subsampled_odd(&p, W, H, 1, full_range, out);
}
