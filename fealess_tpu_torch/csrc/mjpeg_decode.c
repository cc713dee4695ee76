/* Motion JPEG frames for io/mjpeg.py: what cv2.VideoCapture returns for a
 * frame of an AVI, bit for bit.  cv2 decodes it with FFmpeg's mjpeg decoder
 * and converts the decoder's planes to BGR24 with swscale
 * (CvCapture_FFMPEG::retrieveFrame: sws_getCachedContext to BGR24 at the
 * same size, SWS_BICUBIC, then sws_scale), which differs from libjpeg's
 * IDCT, upsampling and colour conversion (jpeg_decode.c) at most pixels.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.
 *
 * The stages and the FFmpeg functions they follow:
 *   jpeg_parse.h          markers and Huffman decoding (the coefficients
 *                         FFmpeg's decode_block / decode_block_progressive
 *                         / decode_block_refinement yield for a valid
 *                         file), with Annex K's tables in every slot 0/1 a
 *                         file leaves empty, progressive files included
 *                         (init_default_huffman_tables)
 *   mjpegdec.c            dequantization into int16 blocks, the DC
 *                         predictor starting at 1024 (4 << bits), so the
 *                         IDCT's level shift rides on the DC term
 *   simple_idct.h         ff_simple_idct_put_int16_8bit: rows with the
 *                         DC-only shortcut, then columns, clipped to u8
 *   yuv_bgr.h             swscale: the decoder's planes (gray8, yuvj420p,
 *                         yuvj422p, yuvj444p; yuv* without j after a
 *                         "CS=ITU601" comment) to BGR24 by the path
 *                         sws_scale takes for that format and size on
 *                         x86-64; gray8 takes the palette path, B = G = R
 *                         = Y.
 */
#include "jpeg_parse.h"
#include "simple_idct.h"
#include "yuv_bgr.h"

/* return codes past jpeg_parse.h's */
enum {
  FL_FORMAT = 7,    /* a sampling FFmpeg outputs as another pixel format */
  FL_RGB = 8,       /* an RGB JPEG (FFmpeg decodes it to GBRP) */
  FL_TRUNCATED = 9, /* entropy data that ends early: FFmpeg conceals it */
};

/* the decoder's pixel formats */
enum { PF_GRAY = 0, PF_420 = 1, PF_422 = 2, PF_444 = 3 };

/* One block: FFmpeg's dequantized int16 block (the DC with the 1024 of the
 * predictor's start, clipped as decode_block clips it), then the IDCT. */
static void idct_put(const int16_t *coef, const uint16_t *q, uint8_t *out,
                     long stride) {
  int16_t blk[DCTSIZE2];
  int dc = coef[0] * (int)q[0] + 1024;
  blk[0] = (int16_t)(dc < -32768 ? -32768 : dc > 32767 ? 32767 : dc);
  for (int i = 1; i < DCTSIZE2; ++i)
    blk[i] = (int16_t)(uint16_t)((unsigned)coef[i] * q[i]);
  simple_idct_put(blk, out, stride);
}

static int idct_component(comp_t *c) {
  long stride = (long)c->bw * 8;
  c->plane = malloc((size_t)stride * c->bh * 8);
  if (!c->plane) return FL_NOMEM;
  for (int by = 0; by < c->hib; ++by)
    for (int bx = 0; bx < c->wib; ++bx)
      idct_put(block_at(c, by, bx), c->quant,
               c->plane + (size_t)by * 8 * stride + bx * 8, stride);
  return FL_OK;
}

/* ---- entry points ---- */

static void release(dec_t *D) {
  for (int i = 0; i < MAXC; ++i) {
    free(D->c[i].coef);
    free(D->c[i].plane);
  }
}

/* FFmpeg's pix_fmt_id of the SOF: each component's h and v, reduced by a
 * common factor of 2 (ff_mjpeg_decode_sof) */
static int pixel_format(const dec_t *D) {
  if (D->ncomp == 1) return PF_GRAY;
  unsigned id = 0;
  for (int i = 0; i < 3; ++i)
    id |= (unsigned)(D->c[i].h << 4 | D->c[i].v) << (24 - 8 * i);
  if (!(id & 0xD0D0D0D0u)) id -= (id & 0xF0F0F0F0u) >> 1;
  if (!(id & 0x0D0D0D0Du)) id -= (id & 0x0F0F0F0Fu) >> 1;
  switch (id) {
    case 0x11111100: return PF_444;
    case 0x21111100: return PF_422;
    case 0x22111100: return PF_420;
    default: return -1;
  }
}

/* FFmpeg's RGB test: Adobe transform 0 or component ids 'R' 'G' 'B' */
static int is_rgb(const dec_t *D) {
  if (D->ncomp != 3) return 0;
  if (D->adobe && D->adobe_transform == 0) return 1;
  return D->c[0].id == 'R' && D->c[1].id == 'G' && D->c[2].id == 'B';
}

/* info: width, height */
int fl_mjpeg_header(const uint8_t *data, long n, int *info) {
  dec_t *D = calloc(1, sizeof *D);
  if (!D) return FL_NOMEM;
  D->d = data;
  D->n = n;
  D->ffmpeg = 1;
  int rc = parse(D, 0);
  if (rc == FL_OK && !D->seen_sof) rc = FL_NO_SOF;
  if (rc == FL_OK) {
    info[0] = D->width;
    info[1] = D->height;
  }
  release(D);
  free(D);
  return rc;
}

/* Decode to out, BGR (H, W, 3); full_range 0 after a "CS=ITU601" comment
 * (FFmpeg then outputs yuv* instead of yuvj*). */
int fl_mjpeg_decode(const uint8_t *data, long n, int full_range,
                    uint8_t *out) {
  dec_t *D = calloc(1, sizeof *D);
  if (!D) return FL_NOMEM;
  D->d = data;
  D->n = n;
  D->ffmpeg = 1;
  int rc = parse(D, 1);
  if (rc == FL_OK && !D->seen_sof) rc = FL_NO_SOF;
  int pf = rc == FL_OK ? pixel_format(D) : -1;
  if (rc == FL_OK && D->truncated) rc = FL_TRUNCATED;
  if (rc == FL_OK && is_rgb(D)) rc = FL_RGB;
  if (rc == FL_OK && pf < 0) rc = FL_FORMAT;
  int W = D->width, H = D->height;
  for (int i = 0; i < D->ncomp && rc == FL_OK; ++i)
    rc = idct_component(&D->c[i]);
  if (rc == FL_OK) {
    if (pf == PF_GRAY) {
      long ys = (long)D->c[0].bw * 8;
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          uint8_t v = D->c[0].plane[y * ys + x];
          uint8_t *o = out + ((size_t)y * W + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
    } else {
      yuv_planes_t p = {D->c[0].plane, D->c[1].plane, D->c[2].plane,
                        (long)D->c[0].bw * 8, (long)D->c[1].bw * 8};
      rc = yuv_to_bgr(&p, W, H, pf != PF_444, pf == PF_420, full_range, out);
    }
  }
  release(D);
  free(D);
  return rc;
}
