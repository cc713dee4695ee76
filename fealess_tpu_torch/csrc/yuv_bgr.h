/* swscale's YUV to BGR24, bit for bit, as cv2.VideoCapture gets it
 * (CvCapture_FFMPEG::retrieveFrame: sws_getCachedContext to BGR24 at the
 * same size, SWS_BICUBIC, then sws_scale), shared by mjpeg_decode.c (the
 * mjpeg decoder's yuvj / yuv planes) and yuv_planar.c (raw yuv420p
 * frames).  yuv_to_bgr takes the path sws_scale takes for the format and
 * size on x86-64:
 *   - 4:2:0 and 4:2:2 of even height: the unscaled converter, whose SSSE3
 *     code (yuv_2_rgb.asm, what every x86-64 CPU with SSSE3 runs) computes
 *     in 16 bits with pmulhw: Y, U, V scaled by 8, offsets subtracted with
 *     saturation, each product's high half, saturating sums, packuswb;
 *   - 4:4:4, and 4:2:0 / 4:2:2 of odd height and odd width: the scaler
 *     with full chroma interpolation (forced for unsubsampled chroma and
 *     for an odd width): initFilter's bicubic filters (B 0, C 0.6),
 *     hScale8To15_c, yuv2rgb_full_X_c_template and yuv2rgb_write_full in
 *     32 bits, in C on every x86 build;
 *   - 4:2:0 / 4:2:2 of odd height and even width: chroma at half width
 *     through the vertical bicubic filter; the rows above the last two in
 *     x86's MMX output code, the last two in C with the 24-bit tables (see
 *     subsampled_odd).
 * NV12 has no unscaled converter: it takes the scaler at every height
 * (full_chroma for an odd width, subsampled_odd for an even one; see
 * yuv_planar.c).
 * full_range picks the yuvj* (JPEG) range, else the limited yuv* range.
 * The coefficients are ff_yuv2rgb_c_init_tables' for BT.601 at the default
 * contrast and saturation.  Every function is static. */
#ifndef FL_YUV_BGR_H
#define FL_YUV_BGR_H

#include <stdint.h>
#include <stdlib.h>

/* return codes (jpeg_parse.h's FL_OK and FL_NOMEM have the same values) */
enum { YUV_OK = 0, YUV_NOMEM = -2 };

/* a frame's planes: chroma shares one stride */
typedef struct {
  const uint8_t *y, *u, *v;
  long ys, cs;
} yuv_planes_t;

static inline uint8_t clip_u8(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

/* ---- swscale's YUV to BGR24 ---- */

/* ff_yuv2rgb_c_init_tables for SWS_CS_DEFAULT (ff_yuv2rgb_coeffs[5]) at
 * contrast and saturation 1 << 16, brightness 0 */
typedef struct {
  int64_t cy, oy, crv, cbu, cgu, cgv;
} coeffs_t;

static coeffs_t coefficients(int full_range) {
  coeffs_t k = {1 << 16, 0, 104597, 132201, -25675, -53279};
  if (!full_range) {
    k.cy = (k.cy * 255) / 219;
    k.oy = 16 << 16;
  } else {
    k.crv = (k.crv * 224) / 255;
    k.cbu = (k.cbu * 224) / 255;
    k.cgu = (k.cgu * 224) / 255;
    k.cgv = (k.cgv * 224) / 255;
  }
  return k;
}

static int round_int16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  return (int)(r < -32768 ? -32768 : r > 32767 ? 32767 : r);
}

/* x86's 16-bit YUV to BGR (the SSSE3 unscaled converter, yuv_2_rgb.asm,
 * and the MMX output rows, swscale_template.c YSCALEYUV2RGB*): its
 * coefficients, then one pixel from Y, U and V scaled by 8 (with the
 * rounder, where the rows add one).  pmulhw keeps a product's high half.
 * Every value stays far inside int16 for 8-bit input, so the SSSE3
 * code's saturating adds and the MMX code's wrapping ones agree with
 * plain int arithmetic. */
typedef struct {
  int yc, yo, vr, ub, ug, vg;
} simd_t;

static simd_t simd_coefficients(int full_range) {
  coeffs_t k = coefficients(full_range);
  simd_t s = {round_int16(k.cy * (1 << 13)), round_int16(k.oy * (1 << 3)),
              round_int16(k.crv * (1 << 13)), round_int16(k.cbu * (1 << 13)),
              round_int16(k.cgu * (1 << 13)), round_int16(k.cgv * (1 << 13))};
  return s;
}

static inline int mulhi(int a, int b) { return (a * b) >> 16; }

static inline void simd_pixel(const simd_t *k, int y8, int u8, int v8,
                              uint8_t *o) {
  int us = u8 - 1024, vs = v8 - 1024;
  int yy = mulhi(y8 - k->yo, k->yc);
  o[0] = clip_u8(yy + mulhi(us, k->ub));
  o[1] = clip_u8(yy + (mulhi(us, k->ug) + mulhi(vs, k->vg)));
  o[2] = clip_u8(yy + mulhi(vs, k->vr));
}

/* The unscaled converter (yuv420/yuv422 to bgr24): chroma sample
 * (x >> 1, y >> vshift) serves pixel (x, y). */
static void unscaled_ssse3(const yuv_planes_t *c, int W, int H, int vshift,
                           int full_range, uint8_t *out) {
  simd_t k = simd_coefficients(full_range);
  long ys = c->ys, cs = c->cs;
  for (int y = 0; y < H; ++y) {
    const uint8_t *py = c->y + y * ys;
    const uint8_t *pu = c->u + (y >> vshift) * cs;
    const uint8_t *pv = c->v + (y >> vshift) * cs;
    uint8_t *o = out + (size_t)y * W * 3;
    for (int x = 0; x < W; ++x)
      simd_pixel(&k, py[x] * 8, pu[x >> 1] * 8, pv[x >> 1] * 8, o + 3 * x);
  }
}

static inline int clip30(int v) {
  return v < 0 ? 0 : v > (1 << 30) - 1 ? (1 << 30) - 1 : v;
}

/* ---- swscale's scaler (utils.c initFilter, hScale8To15_c, vscale.c) ---- */

typedef struct {
  int size;      /* taps a row */
  int32_t *pos;  /* first source sample of each output sample */
  int16_t *coef; /* size taps each, summing to one */
} filter_t;

static int av_log2(unsigned v) {
  int n = 0;
  while (v >>= 1) n++;
  return n;
}

static int64_t rounded_div(int64_t a, int64_t b) {
  return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b;
}

/* get_local_pos: a chroma sample's position, 1/256 of a sample, relative
 * to the ideal left edge (MPEG-2 siting by default) */
static int local_pos(int subsample) {
  return ((128 << subsample) - 128 + 128) >> subsample;
}

/* initFilter for SWS_BICUBIC (B 0, C 0.6) without source or destination
 * vectors: filterAlign is x86's (4 horizontal, 2 vertical). */
static int init_filter(filter_t *out, int xInc, int srcW, int dstW,
                       int filterAlign, int one, int srcPos, int dstPos) {
  const int64_t fone = 1LL << (54 - (av_log2((unsigned)(srcW / dstW)) < 8
                                         ? av_log2((unsigned)(srcW / dstW))
                                         : 8));
  int filterSize;
  int64_t *filter;
  int32_t *pos = malloc(sizeof(int32_t) * (size_t)(dstW + 3));
  if (!pos) return YUV_NOMEM;
  if (abs(xInc - 0x10000) < 10 && srcPos == dstPos) {
    filterSize = 1;
    filter = calloc((size_t)dstW, sizeof(int64_t));
    if (!filter) {
      free(pos);
      return YUV_NOMEM;
    }
    for (int i = 0; i < dstW; i++) {
      filter[i] = fone;
      pos[i] = i;
    }
  } else {
    const int sizeFactor = 4;
    filterSize = xInc <= 1 << 16 ? 1 + sizeFactor
                                 : 1 + (sizeFactor * srcW + dstW - 1) / dstW;
    if (filterSize > srcW - 2) filterSize = srcW - 2;
    if (filterSize < 1) filterSize = 1;
    filter = malloc(sizeof(int64_t) * (size_t)dstW * filterSize);
    if (!filter) {
      free(pos);
      return YUV_NOMEM;
    }
    int64_t xDstInSrc = ((dstPos * (int64_t)xInc) >> 7) -
                        ((srcPos * 0x10000LL) >> 7);
    const int64_t B = 0, C = (int64_t)(0.6 * (1 << 24));
    for (int i = 0; i < dstW; i++) {
      int xx = (int)((xDstInSrc - (filterSize - 2) * (1LL << 16)) /
                     (1 << 17));
      pos[i] = xx;
      for (int j = 0; j < filterSize; j++) {
        int64_t d = (llabs(((int64_t)xx * (1 << 17)) - xDstInSrc)) << 13;
        int64_t coeff;
        if (xInc > 1 << 16) d = d * dstW / srcW;
        if (d >= 1LL << 31) {
          coeff = 0;
        } else {
          int64_t dd = (d * d) >> 30;
          int64_t ddd = (dd * d) >> 30;
          if (d < 1LL << 30)
            coeff = (12 * (1 << 24) - 9 * B - 6 * C) * ddd +
                    (-18 * (1 << 24) + 12 * B + 6 * C) * dd +
                    (6 * (1 << 24) - 2 * B) * (1 << 30);
          else
            coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd +
                    (-12 * B - 48 * C) * d + (8 * B + 24 * C) * (1 << 30);
        }
        coeff /= (1LL << 54) / fone;
        filter[i * filterSize + j] = coeff;
        xx++;
      }
      xDstInSrc += 2LL * xInc;
    }
  }
  /* step 1: drop near-zero taps on the left, count them on the right */
  int minFilterSize = 0;
  for (int i = dstW - 1; i >= 0; i--) {
    int min = filterSize;
    int64_t cutOff = 0;
    int64_t *f = filter + (size_t)i * filterSize;
    for (int j = 0; j < filterSize; j++) {
      cutOff += llabs(f[0]);
      if ((double)cutOff > 0.002 * (double)fone) break;
      if (i < dstW - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < filterSize; k++) f[k - 1] = f[k];
      f[filterSize - 1] = 0;
      pos[i]++;
    }
    cutOff = 0;
    for (int j = filterSize - 1; j > 0; j--) {
      cutOff += llabs(f[j]);
      if ((double)cutOff > 0.002 * (double)fone) break;
      min--;
    }
    if (min > minFilterSize) minFilterSize = min;
  }
  if (minFilterSize == 1 && filterAlign == 2) filterAlign = 1;
  int size = (minFilterSize + (filterAlign - 1)) & ~(filterAlign - 1);
  int64_t *g = calloc((size_t)dstW * size, sizeof(int64_t));
  if (!g) {
    free(filter);
    free(pos);
    return YUV_NOMEM;
  }
  for (int i = 0; i < dstW; i++)
    for (int j = 0; j < size && j < filterSize; j++)
      g[i * size + j] = filter[i * filterSize + j];
  free(filter);
  /* fix the borders */
  for (int i = 0; i < dstW; i++) {
    int64_t *f = g + (size_t)i * size;
    if (pos[i] < 0) {
      for (int j = 1; j < size; j++) {
        int left = j + pos[i] > 0 ? j + pos[i] : 0;
        f[left] += f[j];
        f[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + size > srcW) {
      int shift = pos[i] + (size - srcW < 0 ? size - srcW : 0);
      int64_t acc = 0;
      for (int j = size - 1; j >= 0; j--)
        if (pos[i] + j >= srcW) {
          acc += f[j];
          f[j] = 0;
        }
      for (int j = size - 1; j >= 0; j--) f[j] = j < shift ? 0 : f[j - shift];
      pos[i] -= shift;
      f[srcW - 1 - pos[i]] += acc;
    }
  }
  /* normalize to one, carrying the rounding error along the row */
  int16_t *coef = malloc(sizeof(int16_t) * (size_t)dstW * size);
  if (!coef) {
    free(g);
    free(pos);
    return YUV_NOMEM;
  }
  for (int i = 0; i < dstW; i++) {
    int64_t error = 0, sum = 0;
    for (int j = 0; j < size; j++) sum += g[i * size + j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    for (int j = 0; j < size; j++) {
      int64_t v = g[i * size + j] + error;
      int intV = (int)rounded_div(v, sum);
      coef[i * size + j] = (int16_t)intV;
      error = v - intV * sum;
    }
  }
  free(g);
  out->size = size;
  out->pos = pos;
  out->coef = coef;
  return YUV_OK;
}

static void free_filter(filter_t *f) {
  free(f->pos);
  free(f->coef);
}

/* hScale8To15_c over the rows of a plane: 15-bit samples */
static void hscale(const uint8_t *src, long stride, int rows, int dstW,
                   const filter_t *f, int16_t *dst) {
  for (int y = 0; y < rows; y++) {
    const uint8_t *s = src + y * stride;
    int16_t *d = dst + (size_t)y * dstW;
    for (int i = 0; i < dstW; i++) {
      int val = 0;
      for (int j = 0; j < f->size; j++)
        val += (int)s[f->pos[i] + j] * f->coef[f->size * i + j];
      d[i] = (int16_t)((val >> 7) < (1 << 15) - 1 ? (val >> 7) : (1 << 15) - 1);
    }
  }
}

/* The scaler with full chroma interpolation (swscale forces it for an odd
 * output width and for unsubsampled chroma): each plane scaled to the
 * output's size by bicubic filters, then yuv2rgb_full_X_c_template and
 * yuv2rgb_write_full.  Every x86 build computes this in C. */
static int full_chroma(const yuv_planes_t *c, int W, int H, int hs, int vs,
                       int full_range, uint8_t *out) {
  coeffs_t k = coefficients(full_range);
  int yc = round_int16(k.cy * (1 << 13)), yo = round_int16(k.oy * (1 << 9));
  int v2r = round_int16(k.crv * (1 << 13));
  int u2b = round_int16(k.cbu * (1 << 13));
  int u2g = round_int16(k.cgu * (1 << 13));
  int v2g = round_int16(k.cgv * (1 << 13));
  int cw = (W + (1 << hs) - 1) >> hs, ch = (H + (1 << vs) - 1) >> vs;
  long ys = c->ys;
  filter_t hc = {0}, vc = {0};
  int16_t *Uh = malloc(sizeof(int16_t) * (size_t)W * ch);
  int16_t *Vh = malloc(sizeof(int16_t) * (size_t)W * ch);
  int rc = Uh && Vh ? YUV_OK : YUV_NOMEM;
  /* luma is at the output's size, so its filters are one tap of one */
  if (rc == YUV_OK)
    rc = init_filter(&hc, (int)((((int64_t)cw << 16) + (W >> 1)) / W), cw, W,
                     4, 1 << 14, local_pos(hs), local_pos(0));
  if (rc == YUV_OK)
    rc = init_filter(&vc, (int)((((int64_t)ch << 16) + (H >> 1)) / H), ch, H,
                     2, 1 << 12, local_pos(vs), local_pos(0));
  if (rc == YUV_OK) {
    hscale(c->u, c->cs, ch, W, &hc, Uh);
    hscale(c->v, c->cs, ch, W, &hc, Vh);
    for (int y = 0; y < H; y++) {
      uint8_t *o = out + (size_t)y * W * 3;
      for (int x = 0; x < W; x++) {
        unsigned Ua = (1 << 9) - (128 << 19), Va = (1 << 9) - (128 << 19);
        /* taps past the last row carry zero (initFilter's borders) */
        for (int j = 0; j < vc.size && vc.pos[y] + j < ch; j++) {
          size_t at = (size_t)(vc.pos[y] + j) * W + x;
          Ua += Uh[at] * (unsigned)vc.coef[vc.size * y + j];
          Va += Vh[at] * (unsigned)vc.coef[vc.size * y + j];
        }
        int Y = c->y[y * ys + x] << 9, U = (int)Ua >> 10,
            V = (int)Va >> 10;
        Y -= yo;
        Y *= yc;
        Y += 1 << 21;
        int R = (int)((unsigned)Y + V * (unsigned)v2r);
        int G = (int)((unsigned)Y + V * (unsigned)v2g + U * (unsigned)u2g);
        int B = (int)((unsigned)Y + U * (unsigned)u2b);
        if ((R | G | B) & 0xC0000000) {
          R = clip30(R);
          G = clip30(G);
          B = clip30(B);
        }
        o[3 * x] = (uint8_t)(B >> 22);
        o[3 * x + 1] = (uint8_t)(G >> 22);
        o[3 * x + 2] = (uint8_t)(R >> 22);
      }
    }
  }
  free_filter(&hc);
  free_filter(&vc);
  free(Uh);
  free(Vh);
  return rc;
}

/* ff_yuv2rgb_c_init_tables' 24-bit tables: the C output functions' R, G
 * and B are a clipping luma table indexed by Y plus per-chroma offsets */
typedef struct {
  uint8_t y[2048];
  int yoffs;
  int64_t crv, cbu, cgu, cgv;
} tables_t;

static void c_tables(tables_t *t, int full_range) {
  coeffs_t k = coefficients(full_range);
  t->yoffs = (full_range ? 384 : 326) + 512;
  int64_t cy = k.cy > 1 ? k.cy : 1;
  t->crv = (k.crv * (1 << 16) + 0x8000) / cy;
  t->cbu = (k.cbu * (1 << 16) + 0x8000) / cy;
  t->cgu = (k.cgu * (1 << 16) + 0x8000) / cy;
  t->cgv = (k.cgv * (1 << 16) + 0x8000) / cy;
  int64_t yb = -(384 << 16) - 512 * k.cy - k.oy;
  for (int i = 0; i < 2048; i++) {
    t->y[i] = clip_u8((int)((yb + 0x8000) >> 16));
    yb += k.cy;
  }
}

static void c_write(const tables_t *t, int Y, int U, int V, uint8_t *o) {
  int64_t u = U < 0 ? 0 : U > 255 ? 255 : U, v = V < 0 ? 0 : V > 255 ? 255 : V;
  int r = (int)(t->yoffs - (t->crv >> 9) + ((v * t->crv) >> 16));
  int g = (int)(t->yoffs - (t->cgu >> 9) + ((u * t->cgu) >> 16) -
                (t->cgv >> 9) + ((v * t->cgv) >> 16));
  int b = (int)(t->yoffs - (t->cbu >> 9) + ((u * t->cbu) >> 16));
  o[0] = t->y[b + Y];
  o[1] = t->y[g + Y];
  o[2] = t->y[r + Y];
}

/* 4:2:0 / 4:2:2 of odd height and even width: chroma at half width, its
 * rows through the vertical bicubic filter; vscale.c's packed_vscale
 * picks the output function a row (one tap: yuv2packed1; two summing to
 * 4096: yuv2packed1 with that alpha; else yuv2packedX).  Rows above the
 * last two run x86's MMX code (swscale_template.c YSCALEYUV2RGB1 /
 * YSCALEYUV2RGB1b / YSCALEYUV2PACKEDX + YSCALEYUV2RGBX, vRounder 4); the
 * last two its C code (yuv2rgb_1_c / yuv2rgb_X_c and the tables). */
static int subsampled_odd(const yuv_planes_t *c, int W, int H, int vs,
                          int full_range, uint8_t *out) {
  simd_t k = simd_coefficients(full_range);
  int ch = (H + (1 << vs) - 1) >> vs;
  filter_t vc = {0};
  tables_t t;
  c_tables(&t, full_range);
  int rc = init_filter(&vc, (int)((((int64_t)ch << 16) + (H >> 1)) / H), ch,
                       H, 2, 1 << 12, local_pos(vs), local_pos(0));
  if (rc) return rc;
  long ys = c->ys, cs = c->cs;
  for (int y = 0; y < H; y++) {
    const int16_t *f = vc.coef + vc.size * y;
    int p = vc.pos[y], alpha = 0, packedX = 0;
    if (vc.size == 2 && f[0] + f[1] == 4096 && (unsigned)f[1] <= 4096u)
      alpha = f[1];
    else if (vc.size != 1)
      packedX = 1;
    /* taps past the last chroma row carry zero (initFilter's borders) */
    int taps = p + vc.size <= ch ? vc.size : ch - p;
    const uint8_t *py = c->y + y * ys;
    uint8_t *o = out + (size_t)y * W * 3;
    for (int x = 0; x < W; x++) {
      const uint8_t *u0 = c->u + p * cs + (x >> 1);
      const uint8_t *v0 = c->v + p * cs + (x >> 1);
      int Y = py[x], U, V;
      if (y < H - 2) { /* MMX */
        int y8 = Y << 3;
        if (packedX) {
          y8 += 4; /* vRounder */
          U = V = 4;
          for (int j = 0; j < taps; j++) {
            U += mulhi(u0[j * cs] << 7, f[j]);
            V += mulhi(v0[j * cs] << 7, f[j]);
          }
        } else if (alpha < 2048) {
          U = u0[0] << 3;
          V = v0[0] << 3;
        } else {
          U = (u0[0] + u0[cs]) << 2;
          V = (v0[0] + v0[cs]) << 2;
        }
        simd_pixel(&k, y8, U, V, o + 3 * x);
        continue;
      }
      /* C */
      if (packedX) {
        unsigned ua = 1 << 18, va = 1 << 18;
        for (int j = 0; j < taps; j++) {
          ua += (unsigned)(u0[j * cs] << 7) * (unsigned)f[j];
          va += (unsigned)(v0[j * cs] << 7) * (unsigned)f[j];
        }
        U = (int)ua >> 19;
        V = (int)va >> 19;
      } else if (alpha == 0) {
        U = u0[0];
        V = v0[0];
      } else {
        int a1 = 4096 - alpha;
        U = ((u0[0] << 7) * a1 + (u0[cs] << 7) * alpha + (128 << 11)) >> 19;
        V = ((v0[0] << 7) * a1 + (v0[cs] << 7) * alpha + (128 << 11)) >> 19;
      }
      c_write(&t, Y, U, V, o + 3 * x);
    }
  }
  free_filter(&vc);
  return YUV_OK;
}

/* The planes (chroma subsampled by 1 << hs across and 1 << vs down; hs 0
 * and vs 1 is no format FFmpeg's decoders give here) to BGR (H, W, 3) by
 * sws_scale's path for the format and size. */
static int yuv_to_bgr(const yuv_planes_t *c, int W, int H, int hs, int vs,
                      int full_range, uint8_t *out) {
  if (!hs) return full_chroma(c, W, H, 0, 0, full_range, out);
  if (!(H & 1)) {
    unscaled_ssse3(c, W, H, vs, full_range, out);
    return YUV_OK;
  }
  if (W & 1) return full_chroma(c, W, H, 1, vs, full_range, out);
  return subsampled_odd(c, W, H, vs, full_range, out);
}

#endif
