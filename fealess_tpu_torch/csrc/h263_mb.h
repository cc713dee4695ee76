/* The macroblock layer that MPEG-4 Part 2 (mpeg4_decode.c) and H.263
 * baseline with Sorenson Spark (h263_decode.c) share, as FFmpeg's h263dec
 * shares it between its mpeg4, h263 and flv decoders:
 *   tables       H.263 Table 16 (MPEG-4 Table B-17, the inter TCOEF VLC,
 *                which H.263 takes for intra blocks too), Tables 7 and 8
 *                (MCBPC), 12 (CBPY), 14 (MVD) and the zigzag scan
 *   bits         a big-endian bit reader over a buffer with 8 zero bytes
 *                past its end, and one-lookup VLC tables
 *   motion       ff_h263_pred_motion's median for one 16x16 vector,
 *                ff_h263_decode_motion (f_code and its wrap), and
 *                mpeg_motion: luma at half-pel, chroma at
 *                (mv >> 1) | (mv & 1) half-pel, reference samples at
 *                coordinates clamped to the macroblock-aligned picture
 *                (emulated_edge_mc with h_edge_pos = mb_width * 16); the
 *                rounding type picks put_pixels (rounding up) or
 *                put_no_rnd_pixels, whose x2 / y2 forms on x86 are the
 *                MMXEXT ones (pavgb of an operand less one, saturated)
 *   reconstruction  an intra macroblock's DC times its scaler and its AC
 *                dequantised (dct_unquantize_h263_intra_c) into
 *                ff_simple_idct_put, an inter one's dequantised blocks
 *                into ff_simple_idct_add (simple_idct.h); a decoder whose
 *                codec has a transform of its own (WMV8's) sets
 *                mb_t.idct_put and idct_add after mb_alloc
 * A decoder embeds an mb_t and points mb_t.paths at seven of its syntax
 * path counters, in the order of the MB_* names below. */
#ifndef FL_H263_MB_H
#define FL_H263_MB_H

#include "simple_idct.h"

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- tables ---- */

/* H.263 Table 16 (MPEG-4 Part 2 Table B-17, inter TCOEF): code, length,
 * run and level of each index; index 102 is the escape, from index 58 on
 * the code ends the block (LAST) */
#define TC_ESCAPE 102
#define TC_INTER_LAST 58
static const uint16_t inter_code[103] = {
    2, 15, 21, 23, 31, 37, 36, 33, 32, 7, 6, 32,
    6, 20, 30, 15, 33, 80, 14, 29, 14, 81, 13, 35,
    13, 12, 34, 82, 11, 12, 83, 19, 11, 84, 18, 10,
    17, 9, 16, 8, 22, 85, 21, 20, 28, 27, 33, 32,
    31, 30, 29, 28, 27, 26, 34, 35, 86, 87, 7, 25,
    5, 15, 4, 14, 13, 12, 19, 18, 17, 16, 26, 25,
    24, 23, 22, 21, 20, 19, 24, 23, 22, 21, 20, 19,
    18, 17, 7, 6, 5, 4, 36, 37, 38, 39, 88, 89,
    90, 91, 92, 93, 94, 95, 3,
};
static const uint8_t inter_len[103] = {
    2, 4, 6, 7, 8, 9, 9, 10, 10, 11, 11, 11,
    3, 6, 8, 10, 11, 12, 4, 8, 10, 12, 5, 9,
    10, 5, 9, 12, 5, 10, 12, 6, 10, 12, 6, 10,
    6, 10, 6, 10, 7, 12, 7, 7, 8, 8, 9, 9,
    9, 9, 9, 9, 9, 9, 11, 11, 12, 12, 4, 9,
    11, 6, 11, 6, 6, 6, 7, 7, 7, 7, 8, 8,
    8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9,
    9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12,
    12, 12, 12, 12, 12, 12, 7,
};
static const uint8_t inter_run[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3,
    3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7,
    8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0,
    0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 38, 39, 40,
};
static const uint8_t inter_level[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
    1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
    3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};

/* H.263 Tables 7 and 8 (MCBPC) and 12 (CBPY), 14 (MVD) */
static const uint16_t intra_mcbpc_code[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
static const uint8_t intra_mcbpc_len[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
static const uint16_t inter_mcbpc_code[28] = {
    1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4, 3, 2,
    2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
static const uint8_t inter_mcbpc_len[28] = {
    1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9, 9, 9,
    3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
static const uint16_t cbpy_code[16] = {3, 5, 4, 9, 3, 7, 2, 11,
                                       2, 3, 5, 10, 4, 8, 6, 3};
static const uint8_t cbpy_len[16] = {4, 5, 5, 4, 5, 4, 6, 4,
                                     5, 6, 4, 4, 4, 4, 4, 2};
static const uint16_t mv_code[33] = {
    1, 1, 1, 1, 3, 5, 4, 3, 11, 10, 9, 17, 16, 15, 14, 13, 12, 11, 10,
    9, 8, 7, 6, 5, 4, 7, 6, 5, 4, 3, 2, 3, 2};
static const uint8_t mv_len[33] = {
    1, 2, 3, 4, 6, 7, 7, 7, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10,
    10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 12, 12};
/* the MCBPC stuffing codes: intra and inter */
#define MCBPC_INTRA_STUFFING 8
#define MCBPC_INTER_STUFFING 20

static const uint8_t zigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ---- bits ---- */

typedef struct {
  const uint8_t *buf; /* 8 zero bytes past the end */
  long nbits;
  long pos;
} br_t;

static inline uint32_t br_show(const br_t *b, int n) {
  long byte = b->pos >> 3;
  uint64_t v = 0;
  if (byte <= (b->nbits >> 3)) {
    const uint8_t *p = b->buf + byte;
    v = ((uint64_t)p[0] << 56) | ((uint64_t)p[1] << 48) |
        ((uint64_t)p[2] << 40) | ((uint64_t)p[3] << 32) |
        ((uint64_t)p[4] << 24) | ((uint64_t)p[5] << 16) |
        ((uint64_t)p[6] << 8) | (uint64_t)p[7];
  }
  return n ? (uint32_t)((v << (b->pos & 7)) >> (64 - n)) : 0;
}

static inline uint32_t br_get(br_t *b, int n) {
  uint32_t v = br_show(b, n);
  b->pos += n;
  return v;
}

/* get_xbits: n bits, a leading 0 making it negative */
static inline int br_xbits(br_t *b, int n) {
  int v = (int)br_get(b, n);
  return (v >> (n - 1)) ? v : v - (1 << n) + 1;
}

/* get_sbits: n bits as a two's complement number */
static inline int br_sbits(br_t *b, int n) {
  int v = (int)br_get(b, n);
  return v >= (1 << (n - 1)) ? v - (1 << n) : v;
}

/* bits left before the packet's end (may go negative: past the end the
 * reader gives zeros, as FFmpeg's padded buffers do) */
static inline long br_left(const br_t *b) { return b->nbits - b->pos; }

/* ---- VLCs: one lookup of `bits` bits ---- */

typedef struct {
  int bits;
  int16_t sym[1 << 13];
  uint8_t len[1 << 13];
} vlc_t;

static void vlc_build(vlc_t *v, int bits, int n, const uint16_t *code,
                      const uint8_t *len) {
  v->bits = bits;
  for (int i = 0; i < (1 << bits); ++i) v->sym[i] = -1;
  for (int s = 0; s < n; ++s) {
    if (!len[s]) continue;
    int shift = bits - len[s];
    for (int k = 0; k < (1 << shift); ++k) {
      v->sym[(code[s] << shift) | k] = (int16_t)s;
      v->len[(code[s] << shift) | k] = len[s];
    }
  }
}

static inline int vlc_get(br_t *b, const vlc_t *v) {
  uint32_t idx = br_show(b, v->bits);
  int s = v->sym[idx];
  if (s >= 0) b->pos += v->len[idx];
  return s;
}

/* the VLCs of the macroblock header both decoders read */
typedef struct {
  vlc_t inter_tc, intra_mcbpc, inter_mcbpc, cbpy, mvd;
} mb_vlcs_t;

static void mb_vlcs_build(mb_vlcs_t *v) {
  vlc_build(&v->inter_tc, 12, 103, inter_code, inter_len);
  vlc_build(&v->intra_mcbpc, 9, 9, intra_mcbpc_code, intra_mcbpc_len);
  vlc_build(&v->inter_mcbpc, 13, 28, inter_mcbpc_code, inter_mcbpc_len);
  vlc_build(&v->cbpy, 6, 16, cbpy_code, cbpy_len);
  vlc_build(&v->mvd, 12, 33, mv_code, mv_len);
}

/* ---- pictures and the macroblock state ---- */

/* the syntax path counters mb_t.paths points at, in this order */
enum { MB_MV_ZERO_CODE, MB_MV_CODED, MB_MC_FULL, MB_MC_X, MB_MC_Y,
       MB_MC_XY, MB_MC_CLAMPED };

enum { MB_OK = 0, MB_CORRUPT = -1, MB_NOMEM = -2 };

typedef struct {
  /* two pictures: luma mb_w*16 x mb_h*16, chroma half; cur is decoded
   * into, ref is predicted from */
  uint8_t *pic[2][3];
  int cur, ref, width, height, mb_w, mb_h, ys, cs;
  /* one vector per 8x8 luma block, with a border of one entry all round */
  int16_t *mv;
  int mvstride;
  /* the picture and macroblock being decoded */
  int q, rounding, fcode, mb_x, mb_y;
  int16_t block[6][64];
  int last_index[6];
  uint64_t *paths;
  /* the inverse transform into and onto the picture (mb_alloc sets
   * simple_idct.h's) */
  void (*idct_put)(int16_t *blk, uint8_t *dst, long stride);
  void (*idct_add)(int16_t *blk, uint8_t *dst, long stride);
} mb_t;

static void mb_free(mb_t *m) {
  for (int k = 0; k < 2; ++k)
    for (int p = 0; p < 3; ++p) {
      free(m->pic[k][p]);
      m->pic[k][p] = NULL;
    }
  free(m->mv ? m->mv - 2 * (m->mvstride + 1) : NULL);
  m->mv = NULL;
}

/* zeroed pictures and vectors for width x height */
static int mb_alloc(mb_t *m, int width, int height) {
  m->width = width;
  m->height = height;
  m->mb_w = (width + 15) / 16;
  m->mb_h = (height + 15) / 16;
  m->idct_put = simple_idct_put;
  m->idct_add = simple_idct_add;
  m->ys = m->mb_w * 16;
  m->cs = m->mb_w * 8;
  for (int k = 0; k < 2; ++k)
    for (int p = 0; p < 3; ++p) {
      long n = p ? (long)m->cs * m->mb_h * 8 : (long)m->ys * m->mb_h * 16;
      m->pic[k][p] = (uint8_t *)calloc((size_t)n, 1);
      if (!m->pic[k][p]) return MB_NOMEM;
    }
  m->mvstride = 2 * m->mb_w + 2;
  int16_t *mv = (int16_t *)calloc(
      (size_t)m->mvstride * (2 * m->mb_h + 2) * 2, sizeof(int16_t));
  if (!mv) return MB_NOMEM;
  m->mv = mv + 2 * (m->mvstride + 1);
  return MB_OK;
}

/* ---- motion compensation ---- */

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

/* one block of w x h from `ref` (pw x ph, stride rs) at (sx, sy) full-pel
 * with the half-pel case dxy, samples at clamped coordinates */
static void mc_block(mb_t *m, const uint8_t *ref, int rs, int pw, int ph,
                     int sx, int sy, int dxy, int w, int h, uint8_t *dst,
                     int ds) {
  int ex = w + (dxy & 1), ey = h + (dxy >> 1);
  uint8_t src[17 * 17];
  int clamped = sx < 0 || sy < 0 || sx + ex > pw || sy + ey > ph;
  for (int y = 0; y < ey; ++y) {
    const uint8_t *row = ref + (long)clampi(sy + y, 0, ph - 1) * rs;
    for (int x = 0; x < ex; ++x) src[y * 17 + x] = row[clampi(sx + x, 0, pw - 1)];
  }
  if (clamped && w == 16) ++m->paths[MB_MC_CLAMPED];
  int rnd = !m->rounding;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint8_t *s = src + y * 17 + x;
      int v;
      switch (dxy) {
        case 0:
          v = s[0];
          break;
        case 1: /* pavgb(a, b), or pavgb(a - 1 saturated, b) */
          v = rnd ? (s[0] + s[1] + 1) >> 1
                  : ((s[0] ? s[0] - 1 : 0) + s[1] + 1) >> 1;
          break;
        case 2: { /* no_rnd: the block's odd source rows less one */
          int a = s[0], c = s[17];
          if (!rnd) {
            if (y & 1)
              a = a ? a - 1 : 0;
            else
              c = c ? c - 1 : 0;
          }
          v = (a + c + 1) >> 1;
          break;
        }
        default:
          v = (s[0] + s[1] + s[17] + s[18] + 1 + rnd) >> 2;
      }
      dst[y * ds + x] = (uint8_t)v;
    }
}

/* mpeg_motion for a 16x16 vector (mx, my) in half-pels */
static void mb_motion(mb_t *m, int mx, int my) {
  int pw = m->mb_w * 16, ph = m->mb_h * 16;
  int dxy = ((my & 1) << 1) | (mx & 1);
  int sx = m->mb_x * 16 + (mx >> 1), sy = m->mb_y * 16 + (my >> 1);
  ++m->paths[MB_MC_FULL + dxy];
  mc_block(m, m->pic[m->ref][0], m->ys, pw, ph, sx, sy, dxy, 16, 16,
           m->pic[m->cur][0] + (long)m->mb_y * 16 * m->ys + m->mb_x * 16,
           m->ys);
  int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
  for (int p = 1; p < 3; ++p)
    mc_block(m, m->pic[m->ref][p], m->cs, pw / 2, ph / 2, sx >> 1, sy >> 1,
             uvdxy, 8, 8,
             m->pic[m->cur][p] + (long)m->mb_y * 8 * m->cs + m->mb_x * 8,
             m->cs);
}

/* ff_h263_pred_motion for one 16x16 vector (no resync point past the
 * picture's first macroblock) */
static void mb_pred_motion(const mb_t *m, int *px, int *py) {
  int wrap = m->mvstride;
  const int16_t *mv = m->mv + 2 * ((long)2 * m->mb_y * wrap + 2 * m->mb_x);
  const int16_t *A = mv - 2, *B = mv - 2 * wrap, *C = mv + 2 * (2 - wrap);
  if (m->mb_y == 0) {
    *px = m->mb_x == 0 ? 0 : A[0];
    *py = m->mb_x == 0 ? 0 : A[1];
    return;
  }
#define MID(a, b, c) \
  ((a) > (b) ? ((b) > (c) ? (b) : (a) > (c) ? (c) : (a)) \
             : ((a) > (c) ? (a) : (b) > (c) ? (c) : (b)))
  *px = MID(A[0], B[0], C[0]);
  *py = MID(A[1], B[1], C[1]);
#undef MID
}

static void mb_set_mv(mb_t *m, int mx, int my) {
  int wrap = m->mvstride;
  int16_t *mv = m->mv + 2 * ((long)2 * m->mb_y * wrap + 2 * m->mb_x);
  for (int k = 0; k < 4; ++k) {
    int16_t *e = mv + 2 * ((k >> 1) * wrap + (k & 1));
    e[0] = (int16_t)mx;
    e[1] = (int16_t)my;
  }
}

/* ff_h263_decode_motion, without H.263's long vectors */
static int mb_decode_motion(mb_t *m, br_t *b, const vlc_t *mvd, int pred,
                            int *out) {
  int code = vlc_get(b, mvd);
  if (code < 0) return MB_CORRUPT;
  if (code == 0) {
    ++m->paths[MB_MV_ZERO_CODE];
    *out = pred;
    return MB_OK;
  }
  ++m->paths[MB_MV_CODED];
  int sign = (int)br_get(b, 1), shift = m->fcode - 1, val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= (int)br_get(b, shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + m->fcode;
  *out = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  return MB_OK;
}

/* ---- reconstruction ---- */

/* an intra macroblock's blocks (quantised levels, the DC in block[n][0])
 * with the luma and chroma DC scalers */
static void mb_put_intra(mb_t *m, int y_dc_scale, int c_dc_scale) {
  uint8_t *y = m->pic[m->cur][0] + (long)m->mb_y * 16 * m->ys + m->mb_x * 16;
  int qmul = m->q << 1, qadd = (m->q - 1) | 1;
  for (int n = 0; n < 6; ++n) {
    int16_t *blk = m->block[n];
    blk[0] = (int16_t)(blk[0] * (n < 4 ? y_dc_scale : c_dc_scale));
    for (int i = 1; i < 64; ++i) /* dct_unquantize_h263_intra_c */
      if (blk[i])
        blk[i] = (int16_t)(blk[i] < 0 ? blk[i] * qmul - qadd
                                      : blk[i] * qmul + qadd);
    if (n < 4)
      m->idct_put(blk, y + (n >> 1) * 8 * m->ys + (n & 1) * 8, m->ys);
    else
      m->idct_put(blk, m->pic[m->cur][n - 3] + (long)m->mb_y * 8 * m->cs +
                           m->mb_x * 8,
                  m->cs);
  }
}

/* an inter macroblock's dequantised blocks onto its prediction */
static void mb_add_inter(mb_t *m) {
  uint8_t *y = m->pic[m->cur][0] + (long)m->mb_y * 16 * m->ys + m->mb_x * 16;
  for (int n = 0; n < 6; ++n) {
    if (m->last_index[n] < 0) continue;
    if (n < 4)
      m->idct_add(m->block[n], y + (n >> 1) * 8 * m->ys + (n & 1) * 8,
                  m->ys);
    else
      m->idct_add(m->block[n], m->pic[m->cur][n - 3] +
                                   (long)m->mb_y * 8 * m->cs + m->mb_x * 8,
                  m->cs);
  }
}

/* the current picture's planes, cropped: y (H x W), u and v (ceil(H/2) x
 * ceil(W/2)), each packed */
static void mb_planes(const mb_t *m, uint8_t *y, uint8_t *u, uint8_t *v) {
  int cw = (m->width + 1) / 2, ch = (m->height + 1) / 2;
  for (int r = 0; r < m->height; ++r)
    memcpy(y + (long)r * m->width, m->pic[m->cur][0] + (long)r * m->ys,
           (size_t)m->width);
  for (int r = 0; r < ch; ++r) {
    memcpy(u + (long)r * cw, m->pic[m->cur][1] + (long)r * m->cs, (size_t)cw);
    memcpy(v + (long)r * cw, m->pic[m->cur][2] + (long)r * m->cs, (size_t)cw);
  }
}

#endif
