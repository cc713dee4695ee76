/* JPEG decoding for io/jpeg.py: the pipeline of libjpeg-turbo's
 * jpeg_read_scanlines at scale 1/1 with its default settings (the path
 * cv2.imread takes), bit for bit.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes, which drops
 * the interpreter lock for the call, so a frame loader's threads decode in
 * parallel.
 *
 * Read: SOF0, SOF1 and SOF2 (Huffman, 8-bit samples), one component, or
 * three as YCbCr (JFIF, Adobe transform 1, or component ids 1 2 3) or RGB
 * (Adobe transform 0, or ids 'R' 'G' 'B'); any integral sampling factors;
 * restart intervals; several scans; progressive spectral selection and
 * successive approximation with EOB runs.  A sequential scan that names
 * Huffman table 0 or 1 where no DHT defined it uses the standard table of
 * JPEG Annex K.3, which libjpeg-turbo's jinit_huff_decoder installs
 * (std_huff_tables in jstdhuff.c: the tables a Motion JPEG frame leaves
 * out); its progressive decoder installs none, and cv2 reads no
 * progressive file without them.  Entropy data that ends early
 * (or meets a marker) reads as zero bits, and the blocks after that point
 * of a scan are left as they are (zero in a sequential file), as libjpeg's
 * insufficient_data does.
 *
 * The stages and the libjpeg-turbo functions they follow:
 *   jdhuff.c / jdphuff.c   decode_mcu, decode_mcu_{DC,AC}_{first,refine}
 *   jdmarker.c             next_marker, read_restart_marker,
 *                          jpeg_resync_to_restart
 *   jidctint.c             jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2),
 *                          its output through the range-limit table
 *                          indexed with & RANGE_MASK (wraps, not clamps)
 *   jdsample.c             h2v1/h2v2/h1v2_fancy_upsample, h2v1/h2v2/int
 *                          replication; context rows and columns past the
 *                          component's edge repeat its last sample
 *   jdcolor.c              ycc_rgb_convert (SCALEBITS 16), gray_rgb,
 *                          rgb_gray_convert, grayscale (Y copied)
 *
 * A progressive file whose coefficients 1..9 are not all complete after
 * its last scan (cut short, or a progression that stops early) is decoded
 * by libjpeg with block smoothing, which is not implemented: refused.
 */
#include "jpeg_parse.h"

static void color_space(dec_t *D) {
  /* jdapimin.c default_decompress_parms */
  if (D->ncomp == 1) {
    D->space = 0;
  } else if (D->jfif) {
    D->space = 1;
  } else if (D->adobe) {
    D->space = D->adobe_transform == 0 ? 2 : 1;
  } else {
    int a = D->c[0].id, b = D->c[1].id, c = D->c[2].id;
    D->space = (a == 82 && b == 71 && c == 66) ? 2 : 1;
  }
}

/* ---- jpeg_idct_islow ---- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* the post-IDCT range-limit table: sample_range_limit + CENTERJSAMPLE,
 * indexed with & RANGE_MASK (1023) */
static uint8_t idct_limit(int64_t v) {
  int i = (int)(v & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                       int stride) {
  int ws[DCTSIZE2];
  for (int col = 0; col < 8; ++col) {
    const int16_t *ip = in + col;
    const uint16_t *qp = q + col;
    int *wp = ws + col;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int64_t)ip[0] * qp[0] * 4);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    t0 = (z2 + z3) * (1 << CONST_BITS);
    t1 = (z2 - z3) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = (int64_t)ip[56] * qp[56];
    t1 = (int64_t)ip[40] * qp[40];
    t2 = (int64_t)ip[24] * qp[24];
    t3 = (int64_t)ip[8] * qp[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
  }
  for (int row = 0; row < 8; ++row) {
    const int *wp = ws + 8 * row;
    uint8_t *op = out + (size_t)row * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = idct_limit(DESCALE((int64_t)wp[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; ++i) op[i] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * (-FIX_1_847759065);
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = wp[7];
    t1 = wp[5];
    t2 = wp[3];
    t3 = wp[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 = t0 * FIX_0_298631336;
    t1 = t1 * FIX_2_053119869;
    t2 = t2 * FIX_3_072711026;
    t3 = t3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(DESCALE(t10 + t3, sh));
    op[7] = idct_limit(DESCALE(t10 - t3, sh));
    op[1] = idct_limit(DESCALE(t11 + t2, sh));
    op[6] = idct_limit(DESCALE(t11 - t2, sh));
    op[2] = idct_limit(DESCALE(t12 + t1, sh));
    op[5] = idct_limit(DESCALE(t12 - t1, sh));
    op[3] = idct_limit(DESCALE(t13 + t0, sh));
    op[4] = idct_limit(DESCALE(t13 - t0, sh));
  }
}

static int idct_component(comp_t *c) {
  int stride = c->bw * 8;
  c->plane = malloc((size_t)stride * c->bh * 8);
  if (!c->plane) return FL_NOMEM;
  /* only the blocks the output reads: the component's own, not the
   * MCU padding */
  for (int by = 0; by < c->hib; ++by)
    for (int bx = 0; bx < c->wib; ++bx)
      idct_islow(block_at(c, by, bx), c->quant,
                 c->plane + (size_t)by * 8 * stride + bx * 8, stride);
  return FL_OK;
}

/* ---- upsampling to the full image (jdsample.c) ---- */

/* sample (y, x) of a component, clamped to its downsampled extent */
static inline int at(const comp_t *c, int y, int x) {
  if (y < 0) y = 0;
  if (y >= c->dh) y = c->dh - 1;
  if (x < 0) x = 0;
  if (x >= c->dw) x = c->dw - 1;
  return c->plane[(size_t)y * c->bw * 8 + x];
}

static int upsample(const comp_t *c, int maxh, int maxv, int W, int H,
                    uint8_t *out) {
  int fh = maxh / c->h, fv = maxv / c->v;
  if (maxh % c->h || maxv % c->v) return FL_SAMPLING;
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < H; ++y)
      memcpy(out + (size_t)y * W, c->plane + (size_t)y * c->bw * 8, W);
    return FL_OK;
  }
  int fancy_h = fh == 2 && (fv == 1 || fv == 2) && c->dw > 2;
  int fancy_v = fh == 1 && fv == 2;
  for (int y = 0; y < H; ++y) {
    uint8_t *o = out + (size_t)y * W;
    int iy = y / fv;
    if (fancy_h && fv == 1) { /* h2v1_fancy_upsample */
      for (int x = 0; x < W; ++x) {
        int j = x >> 1, v3 = at(c, iy, j) * 3;
        o[x] = (uint8_t)((x & 1) ? (v3 + at(c, iy, j + 1) + 2) >> 2
                                 : (v3 + at(c, iy, j - 1) + 1) >> 2);
      }
    } else if (fancy_h) { /* h2v2_fancy_upsample */
      int iy1 = (y & 1) ? iy + 1 : iy - 1;
      for (int x = 0; x < W; ++x) {
        int j = x >> 1;
        int th = at(c, iy, j) * 3 + at(c, iy1, j);
        if (x & 1) {
          int nx = at(c, iy, j + 1) * 3 + at(c, iy1, j + 1);
          o[x] = (uint8_t)((th * 3 + nx + 7) >> 4);
        } else {
          int ls = at(c, iy, j - 1) * 3 + at(c, iy1, j - 1);
          o[x] = (uint8_t)((th * 3 + ls + 8) >> 4);
        }
      }
    } else if (fancy_v) { /* h1v2_fancy_upsample */
      int below = y & 1, iy1 = below ? iy + 1 : iy - 1;
      for (int x = 0; x < W; ++x)
        o[x] = (uint8_t)((at(c, iy, x) * 3 + at(c, iy1, x) + 1 + below) >> 2);
    } else { /* h2v1/h2v2_upsample, int_upsample: replication */
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)at(c, iy, x / fh);
    }
  }
  return FL_OK;
}

/* ---- colour conversion (jdcolor.c) ---- */

#define SCALEBITS 16
#define ONE_HALF ((int64_t)1 << (SCALEBITS - 1))
#define FIX(x) ((int64_t)((x) * (1L << SCALEBITS) + 0.5))

static uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static void ycc_bgr(const uint8_t *Y, const uint8_t *Cb, const uint8_t *Cr,
                    size_t n, uint8_t *out) {
  static int cr_r[256], cb_b[256];
  static int64_t cr_g[256], cb_g[256];
  static int ready;
  if (!ready) { /* build_ycc_rgb_table; idempotent, so a race is benign */
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
    ready = 1;
  }
  for (size_t i = 0; i < n; ++i) {
    int y = Y[i], cb = Cb[i], cr = Cr[i];
    out[3 * i + 2] = clamp255(y + cr_r[cr]);
    out[3 * i + 1] = clamp255(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
    out[3 * i + 0] = clamp255(y + cb_b[cb]);
  }
}

static void rgb_gray(const uint8_t *R, const uint8_t *G, const uint8_t *B,
                     size_t n, uint8_t *out) {
  for (size_t i = 0; i < n; ++i)
    out[i] = (uint8_t)((FIX(0.29900) * R[i] + FIX(0.58700) * G[i] +
                        FIX(0.11400) * B[i] + ONE_HALF) >> SCALEBITS);
}

/* ---- entry points ---- */

static void release(dec_t *D) {
  for (int i = 0; i < MAXC; ++i) {
    free(D->c[i].coef);
    free(D->c[i].plane);
  }
}

/* info: width, height, components, colour space (0 gray, 1 YCbCr, 2 RGB),
 * progressive */
int fl_jpeg_header(const uint8_t *data, long n, int *info) {
  dec_t *D = calloc(1, sizeof *D);
  if (!D) return FL_NOMEM;
  D->d = data;
  D->n = n;
  int rc = parse(D, 0);
  if (rc == FL_OK && !D->seen_sof) rc = FL_NO_SOF;
  if (rc == FL_OK) {
    color_space(D);
    info[0] = D->width;
    info[1] = D->height;
    info[2] = D->ncomp;
    info[3] = D->space;
    info[4] = D->progressive;
  }
  release(D);
  free(D);
  return rc;
}

/* Decode to out: gray (H, W) when gray, else BGR (H, W, 3). */
int fl_jpeg_decode(const uint8_t *data, long n, int gray, uint8_t *out) {
  dec_t *D = calloc(1, sizeof *D);
  uint8_t *full[3] = {NULL, NULL, NULL};
  if (!D) return FL_NOMEM;
  D->d = data;
  D->n = n;
  int rc = parse(D, 1);
  if (rc == FL_OK && !D->seen_sof) rc = FL_NO_SOF;
  if (rc == FL_OK && D->progressive) {
    /* smoothing_ok: libjpeg smooths when every component's DC is known
     * and some coefficient 1..9 is incomplete */
    int dc_known = 1, incomplete = 0;
    for (int i = 0; i < D->ncomp; ++i) {
      if (D->c[i].coef_bits[0] < 0) dc_known = 0;
      for (int k = 1; k <= 9; ++k)
        if (D->c[i].coef_bits[k] != 0) incomplete = 1;
    }
    if (dc_known && incomplete) rc = FL_SMOOTHING;
  }
  if (rc == FL_OK) {
    color_space(D);
    int W = D->width, H = D->height;
    size_t npix = (size_t)W * H;
    /* libjpeg decodes only Y for gray output of a YCbCr file */
    int used = (gray && D->space != 2) ? 1 : D->ncomp;
    for (int i = 0; i < used && rc == FL_OK; ++i) {
      rc = idct_component(&D->c[i]);
      if (rc == FL_OK) {
        full[i] = malloc(npix);
        rc = full[i] ? upsample(&D->c[i], D->maxh, D->maxv, W, H, full[i])
                     : FL_NOMEM;
      }
    }
    if (rc == FL_OK) {
      if (gray) {
        if (used == 1)
          memcpy(out, full[0], npix);
        else
          rgb_gray(full[0], full[1], full[2], npix, out);
      } else if (D->ncomp == 1) {
        for (size_t i = 0; i < npix; ++i)
          out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
      } else if (D->space == 2) {
        for (size_t i = 0; i < npix; ++i) {
          out[3 * i] = full[2][i];
          out[3 * i + 1] = full[1][i];
          out[3 * i + 2] = full[0][i];
        }
      } else {
        ycc_bgr(full[0], full[1], full[2], npix, out);
      }
    }
  }
  for (int i = 0; i < 3; ++i) free(full[i]);
  release(D);
  free(D);
  return rc;
}
