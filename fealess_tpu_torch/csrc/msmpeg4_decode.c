/* MS MPEG-4 v2, MS MPEG-4 v3, WMV7 and WMV8 video for io/msmpeg4.py and
 * io/wmv2.py: what cv2.VideoCapture returns for the streams
 * cv2.VideoWriter writes with the fourccs MP42 / DIV2 (v2), DIV3 / MP43 /
 * DIV4 / DIV5 / DIV6 / MPG3 / AP41 / COL1 / COL0 / 3IVD (v3), WMV1 (WMV7)
 * and WMV2 (WMV8), bit for bit.  cv2 decodes them with FFmpeg's
 * msmpeg4v2, msmpeg4v3, wmv1 and wmv2 decoders (libavcodec 62.28 in cv2
 * 5.0.0, all four h263dec over msmpeg4dec) and converts their yuv420p
 * planes to BGR24 with swscale (yuv_bgr.h).  What that writer produces is
 * FFmpeg's own msmpeg4 and wmv2 encoders at their defaults: I and P
 * pictures, one slice, one quantiser a picture, no AC prediction, one
 * run/level table set a picture (WMV8: no IntraX8, no mspel, 8x8
 * transforms only, no loop filter, no skipped macroblocks).  The stream
 * carries no picture size: the container's is given at open.  WMV8's
 * settings come from the container's 4-byte extradata
 * (fl_msmpeg4_ext_header).
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.  A decoder
 * keeps the reference picture, the vectors and the picture-level state
 * (rounding, bit rate) across packets.
 *
 * The stages and the FFmpeg functions they follow:
 *   headers      ff_msmpeg4_decode_picture_header: picture type,
 *                quantiser, slice code (0x17, one slice), the run/level,
 *                DC and MV table indices (decode012), WMV1's extension
 *                header inside the I picture's header, use_skip_mb_code;
 *                ff_msmpeg4_decode_ext_header after a v2 / v3 I picture's
 *                macroblocks (fps, bit rate, flipflop_rounding); each P
 *                picture toggles no_rounding where flipflop_rounding is
 *                set; WMV8: decode_ext_header from the extradata,
 *                ff_wmv2_decode_picture_header and
 *                ff_wmv2_decode_secondary_picture_header (the skip type,
 *                the P pictures' CBP table by cbp_index and qscale band:
 *                wmv2_get_cbp_table_index; every P picture toggles
 *                no_rounding, no inter-intra prediction)
 *   macroblocks  msmpeg4v12_decode_mb (v2: MB type and intra CBPC VLCs,
 *                H.263's CBPY, msmpeg4v2_decode_motion: H.263's MVD VLC
 *                wrapped at +-64) and msmpeg4v34_decode_mb (v3, WMV1: the
 *                intra MB VLC with the coded-block prediction
 *                ff_msmpeg4_coded_block_pred, the non-intra MB VLC,
 *                ff_msmpeg4_decode_motion: the MV tables, a 6+6 bit
 *                escape, wrapped at +-64; WMV1's inter-intra direction);
 *                WMV8's wmv2_decode_mb, which is v3's without skip flags,
 *                its P pictures' MB VLC the band's ff_wmv2_inter_table,
 *                wmv2_pred_motion (h263's median without the top-left
 *                flag) and its inter blocks at abt_type 0 (8x8)
 *   blocks       ff_msmpeg4_decode_block: the DC (v2: MPEG-4's DC size
 *                VLC inverted; v3 / WMV1: the DC tables with an 8-bit
 *                escape) predicted by ff_msmpeg4_pred_dc (a scaled
 *                division, the direction by gradients, WMV1's inter-intra
 *                prediction from the neighbouring pixels), the run/level
 *                tables ff_rl_table[0..5] with their three escapes (the
 *                third fixed-length in v2 / v3, WMV1's lengths read at a
 *                picture's first third escape), zigzag scan (v2, v3) or
 *                WMV1's intra and inter scans
 *   dequant      H.263's (h263_mb.h's mb_put_intra, the inter levels out
 *                of the table), the DC scales ff_mpeg1_dc_scale_table (v2),
 *                ff_old_ff_y_dc_scale_table with ff_wmv1_c_dc_scale_table
 *                (v3: FFmpeg's default workaround_bugs) and WMV1's own
 *                (WMV1, WMV8)
 *   transform    simple_idct.h's, WMV8's own ff_wmv2_idct_c (wmv2dsp.c:
 *                put and add clamped) for its intra and inter blocks
 *   motion       h263_mb.h's ff_h263_pred_motion and mpeg_motion with the
 *                picture's rounding, reference samples at clamped
 *                coordinates
 *   output       the picture cropped to its size, yuv420p at limited
 *                range to BGR24 through yuv_bgr.h
 * The tables are msmpeg4_tables.h's, taken from that libavcodec.
 *
 * A tool no stream of that writer holds is refused with its name's code
 * (MS_REFUSED + R_*); a packet the decoder cannot read is MS_CORRUPT,
 * where FFmpeg conceals what follows or drops the packet.  Every syntax
 * path that is decoded bumps a counter (C_*), so a test holds the
 * committed sources to covering all of them.
 */
#include "h263_mb.h"
#include "msmpeg4_tables.h"
#include "simple_idct.h"
#include "yuv_bgr.h"

enum { MS_OK = 0, MS_CORRUPT = -1, MS_NOMEM = -2, MS_REFUSED = 100 };
enum { V2 = 2, V3 = 3, WMV1 = 4, WMV2 = 5 };

/* tools and kinds refused, by name in io/msmpeg4.py and io/wmv2.py */
enum {
  R_AC_PRED = 1, R_PER_MB_RL, R_SLICES, R_NO_REFERENCE, R_DC_TABLE0,
  R_MV_TABLE0, R_NO_SKIP_CODE, R_INTRAX8, R_MSPEL, R_ABT, R_LOOP_FILTER,
  R_SKIP_TYPE, R_TOP_LEFT_MV, R_NO_EXT_HEADER
};

/* syntax paths counted; C_MV_ZERO_CODE to C_MC_CLAMPED are h263_mb.h's
 * MB_*, the CBP tables WMV8's */
enum {
  C_IPIC, C_PPIC, C_ROUND0, C_ROUND1, C_EXT_HEADER, C_RL0, C_RL1, C_RL2,
  C_RL3, C_RL4, C_RL5, C_I_MB, C_P_INTRA_MB, C_P_INTER_MB, C_P_SKIP_MB,
  C_CBP_PRED, C_INTER_INTRA, C_DC_ESCAPE, C_DC_LEFT, C_DC_TOP, C_ESC1,
  C_ESC2, C_ESC3, C_ESC3_LENGTHS, C_MV_ESCAPE, C_MV_ZERO_CODE, C_MV_CODED,
  C_MC_FULL, C_MC_X, C_MC_Y, C_MC_XY, C_MC_CLAMPED, C_CBP_TABLE0,
  C_CBP_TABLE1, C_CBP_TABLE2, C_NPATHS
};

#define DC_MAX 119
#define MBAC_BITRATE (50 * 1024)
#define II_BITRATE (128 * 1024)

/* MPEG-4 Tables B-13 and B-14 (dct_dc_size), from which FFmpeg builds
 * v2's DC VLCs (init_h263_dc_for_msmpeg4) */
static const uint8_t dc_lum_code[13] = {3, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
                                        1};
static const uint8_t dc_lum_len[13] = {3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10,
                                       11};
static const uint8_t dc_chrom_code[13] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                          1};
static const uint8_t dc_chrom_len[13] = {2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                         12};

/* ---- VLCs of any length: tables of 8 bits, chained ---- */

typedef struct {
  int32_t *e; /* >= 0: (symbol << 5) | length; < 0: -(next table) */
  int ntab, cap;
} xvlc_t;

static int xvlc_table(xvlc_t *v) {
  if (v->ntab == v->cap) {
    int cap = v->cap ? 2 * v->cap : 8;
    int32_t *e = (int32_t *)realloc(v->e, (size_t)cap * 256 * sizeof(int32_t));
    if (!e) return -1;
    v->e = e;
    v->cap = cap;
  }
  for (int k = 0; k < 256; ++k) v->e[v->ntab * 256 + k] = 0x7FFFFFFF;
  return v->ntab++;
}

/* codes[s] of lens[s] bits for symbols 0..n-1 (length 0: unused) */
static int xvlc_build(xvlc_t *v, int n, const uint32_t *codes,
                      const uint8_t *lens) {
  v->e = NULL;
  v->ntab = v->cap = 0;
  if (xvlc_table(v) < 0) return MS_NOMEM;
  for (int s = 0; s < n; ++s) {
    int len = lens[s], t = 0;
    if (!len) continue;
    while (len > 8) {
      len -= 8;
      int32_t *e = &v->e[t * 256 + ((codes[s] >> len) & 0xFF)];
      if (*e == 0x7FFFFFFF) {
        int nt = xvlc_table(v);
        if (nt < 0) return MS_NOMEM;
        e = &v->e[t * 256 + ((codes[s] >> len) & 0xFF)];
        *e = -nt;
      }
      t = -*e;
    }
    uint32_t low = codes[s] & ((1u << len) - 1);
    for (int k = 0; k < (1 << (8 - len)); ++k)
      v->e[t * 256 + ((low << (8 - len)) | k)] = (s << 5) | len;
  }
  return MS_OK;
}

/* the next symbol, or -1 for a code not in the table */
static inline int xvlc_get(br_t *b, const xvlc_t *v) {
  int t = 0;
  for (;;) {
    int32_t e = v->e[t * 256 + br_show(b, 8)];
    if (e < 0) {
      b->pos += 8;
      t = -e;
      continue;
    }
    if (e == 0x7FFFFFFF) return -1;
    b->pos += e & 31;
    return e >> 5;
  }
}

static void xvlc_free(xvlc_t *v) {
  free(v->e);
  v->e = NULL;
}

/* ---- run/level tables ---- */

typedef struct {
  xvlc_t vlc;
  const int8_t *run, *level;
  int n, last;
  int8_t max_level[2][65], max_run[2][65];
} rl_t;

static int rl_build(rl_t *rl, int n, int last, const uint16_t *code,
                    const uint8_t *len, const int8_t *run,
                    const int8_t *level) {
  uint32_t codes[256];
  for (int i = 0; i <= n; ++i) codes[i] = code[i];
  rl->run = run;
  rl->level = level;
  rl->n = n;
  rl->last = last;
  memset(rl->max_level, 0, sizeof rl->max_level);
  memset(rl->max_run, 0, sizeof rl->max_run);
  for (int i = 0; i < n; ++i) { /* ff_rl_init */
    int l = i >= last;
    if (level[i] > rl->max_level[l][run[i]])
      rl->max_level[l][run[i]] = level[i];
    if (run[i] > rl->max_run[l][level[i]]) rl->max_run[l][level[i]] = run[i];
  }
  return xvlc_build(&rl->vlc, n + 1, codes, len);
}

/* ---- decoder ---- */

typedef struct {
  mb_vlcs_t v; /* H.263's CBPY and MVD for v2 */
  /* DC and MV table 1 (table 0 is refused), DC for luma and chroma */
  xvlc_t mb_i, mb_non_intra, dc_vlc[2], mv, v2_dc[2], inter_intra,
      v2_mb_type, v2_intra_cbpc, wmv2_inter[3];
  const xvlc_t *p_mb; /* the P picture's MB VLC */
  rl_t rl[6];
  mb_t m;
  int version;
  int have_ref;
  /* DC predictors (level * scale), 1024 outside the picture and in
   * non-intra blocks, and v3 / WMV1's coded-block flags, each with a
   * border of one entry all round */
  int16_t *dc[3];
  uint8_t *coded;
  int dstride[3];
  /* picture-level state */
  int pframe, rl_index, rl_chroma_index, inter_intra_pred, flipflop;
  int no_rounding, bit_rate, esc3_level_len, esc3_run_len;
  int y_dc_scale, c_dc_scale, aic_dir;
  /* WMV8's extension header: the tools its pictures may switch on */
  int mspel_bit, abt_flag, j_type_bit, per_mb_rl_bit;
  const uint8_t *intra_scan, *inter_scan;
  uint64_t count[C_NPATHS];
  int refused; /* the R_* of the last refusal */
} ms_t;

static int refuse(ms_t *d, int tool) {
  d->refused = tool;
  return MS_REFUSED + tool;
}

/* ff_inverse's division, as ff_msmpeg4_pred_dc's x86 code and get_dc's
 * FASTDIV compute it: (a * ceil(2^32 / b)) >> 32 */
static inline int fastdiv(int a, int b) {
  uint32_t inv = (uint32_t)(((1ull << 32) + (uint64_t)b - 1) / (uint64_t)b);
  return (int)(((int64_t)a * (int64_t)inv) >> 32);
}

static inline int decode012(br_t *b) {
  return br_get(b, 1) ? (int)br_get(b, 1) + 1 : 0;
}

/* ---- blocks ---- */

static int16_t *dc_at(ms_t *d, int n) {
  int p = n < 4 ? 0 : n - 3, wrap = d->dstride[p];
  return d->dc[p] + (n < 4 ? (long)(2 * d->m.mb_y + (n >> 1)) * wrap +
                                 2 * d->m.mb_x + (n & 1)
                           : (long)d->m.mb_y * wrap + d->m.mb_x);
}

/* get_dc: the rounded mean of an 8x8 block of the picture */
static int pixel_dc(const uint8_t *src, int stride, int scale) {
  int sum = 0;
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) sum += src[x + y * stride];
  return fastdiv(sum + (scale >> 1), scale);
}

/* ff_msmpeg4_pred_dc: the block's DC predictor */
static int pred_dc(ms_t *d, int n) {
  mb_t *m = &d->m;
  int scale = n < 4 ? d->y_dc_scale : d->c_dc_scale;
  int wrap = d->dstride[n < 4 ? 0 : n - 3];
  int16_t *dc = dc_at(d, n);
  int a = dc[-1], b = dc[-1 - wrap], c = dc[-wrap], pred, top;
  if (m->mb_y == 0 && !(n & 2) && d->version < WMV1) b = c = 1024;
  a = fastdiv(a + (scale >> 1), scale);
  b = fastdiv(b + (scale >> 1), scale);
  c = fastdiv(c + (scale >> 1), scale);
  if (d->version == WMV1 && d->inter_intra_pred) {
    ++d->count[C_INTER_INTRA];
    if (n == 1 || n == 2 || n == 3) {
      top = n == 2 || (n == 3 && abs(a - b) < abs(b - c));
    } else {
      const uint8_t *dest;
      int stride;
      if (n < 4) {
        stride = m->ys;
        dest = m->pic[m->cur][0] + (long)m->mb_y * 16 * stride + m->mb_x * 16;
      } else {
        stride = m->cs;
        dest = m->pic[m->cur][n - 3] + (long)m->mb_y * 8 * stride +
               m->mb_x * 8;
      }
      a = m->mb_x == 0 ? (1024 + (scale >> 1)) / scale
                       : pixel_dc(dest - 8, stride, scale * 8);
      c = m->mb_y == 0 ? (1024 + (scale >> 1)) / scale
                       : pixel_dc(dest - 8 * stride, stride, scale * 8);
      top = d->aic_dir == 3 || (d->aic_dir == 1 && n == 0) ||
            (d->aic_dir == 2 && n != 0);
    }
  } else if (d->version >= WMV1) {
    top = abs(a - b) < abs(b - c);
  } else {
    top = abs(a - b) <= abs(b - c);
  }
  if (top) {
    pred = c;
    ++d->count[C_DC_TOP];
  } else {
    pred = a;
    ++d->count[C_DC_LEFT];
  }
  return pred;
}

/* msmpeg4_decode_dc: the quantised DC, its scaled value kept as the
 * next blocks' predictor */
static int decode_dc(ms_t *d, br_t *b, int n, int *level) {
  int v;
  if (d->version == V2) {
    v = xvlc_get(b, &d->v2_dc[n >= 4]);
    if (v < 0) return MS_CORRUPT;
    v -= 256;
  } else {
    v = xvlc_get(b, &d->dc_vlc[n >= 4]);
    if (v < 0) return MS_CORRUPT;
    if (v == DC_MAX) {
      ++d->count[C_DC_ESCAPE];
      v = (int)br_get(b, 8);
      if (br_get(b, 1)) v = -v;
    } else if (v && br_get(b, 1)) {
      v = -v;
    }
  }
  v += pred_dc(d, n);
  *dc_at(d, n) = (int16_t)(v * (n < 4 ? d->y_dc_scale : d->c_dc_scale));
  *level = v;
  return MS_OK;
}

/* ff_msmpeg4_decode_block */
static int decode_block(ms_t *d, br_t *b, int n, int coded, int intra) {
  mb_t *m = &d->m;
  int16_t *blk = m->block[n];
  const rl_t *rl;
  const uint8_t *scan;
  int i, qmul, qadd, run_diff;
  if (intra) {
    int level, rc = decode_dc(d, b, n, &level);
    if (rc) return rc;
    if (level < 0 && d->inter_intra_pred) level = 0;
    int k = n < 4 ? d->rl_index : 3 + d->rl_chroma_index;
    if (level > 256 * (n < 4 ? d->y_dc_scale : d->c_dc_scale) &&
        !d->inter_intra_pred)
      return MS_CORRUPT;
    blk[0] = (int16_t)level;
    i = 0;
    if (!coded) {
      m->last_index[n] = 0;
      return MS_OK;
    }
    rl = &d->rl[k];
    ++d->count[C_RL0 + k];
    scan = d->intra_scan;
    qmul = 1;
    qadd = 0;
    run_diff = d->version >= WMV1;
  } else {
    i = -1;
    if (!coded) {
      m->last_index[n] = -1;
      return MS_OK;
    }
    rl = &d->rl[3 + d->rl_index];
    ++d->count[C_RL3 + d->rl_index];
    scan = d->inter_scan;
    qmul = m->q << 1;
    qadd = (m->q - 1) | 1;
    run_diff = d->version != V2;
  }
  for (;;) {
    int s = xvlc_get(b, &rl->vlc), run, level, last;
    if (s < 0) return MS_CORRUPT;
    if (s == rl->n) {
      uint32_t mode = br_show(b, 2);
      if (!(mode & 2)) {
        b->pos += 2;
        if (!(mode & 1)) { /* third escape: LAST, RUN, LEVEL as they are */
          last = (int)br_get(b, 1);
          if (d->version <= V3) {
            run = (int)br_get(b, 6);
            level = (int8_t)br_get(b, 8);
          } else {
            if (!d->esc3_level_len) {
              int ll;
              ++d->count[C_ESC3_LENGTHS];
              if (m->q < 8) {
                ll = (int)br_get(b, 3);
                if (!ll) ll = 8 + (int)br_get(b, 1);
              } else {
                ll = 2;
                while (ll < 8 && !br_show(b, 1)) {
                  ++ll;
                  b->pos += 1;
                }
                if (ll < 8) b->pos += 1;
              }
              d->esc3_level_len = ll;
              d->esc3_run_len = (int)br_get(b, 2) + 3;
            }
            run = (int)br_get(b, d->esc3_run_len);
            int sign = (int)br_get(b, 1);
            level = (int)br_get(b, d->esc3_level_len);
            if (sign) level = -level;
          }
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          i += run + 1 + (last ? 192 : 0);
          ++d->count[C_ESC3];
        } else { /* second escape: RUN past the table's longest */
          int t = xvlc_get(b, &rl->vlc);
          if (t < 0 || t == rl->n) return MS_CORRUPT;
          last = t >= rl->last;
          run = rl->run[t] + 1 + (last ? 192 : 0);
          level = rl->level[t] * qmul + qadd;
          i += run + rl->max_run[last][rl->level[t]] + run_diff;
          if (br_get(b, 1)) level = -level;
          ++d->count[C_ESC2];
        }
      } else { /* first escape: LEVEL past the table's largest */
        b->pos += 1;
        int t = xvlc_get(b, &rl->vlc);
        if (t < 0 || t == rl->n) return MS_CORRUPT;
        last = t >= rl->last;
        i += rl->run[t] + 1 + (last ? 192 : 0);
        level = rl->level[t] * qmul + qadd +
                rl->max_level[last][rl->run[t]] * qmul;
        if (br_get(b, 1)) level = -level;
        ++d->count[C_ESC1];
      }
    } else {
      last = s >= rl->last;
      i += rl->run[s] + 1 + (last ? 192 : 0);
      level = rl->level[s] * qmul + qadd;
      if (br_get(b, 1)) level = -level;
    }
    if (i > 62) {
      i -= 192;
      if (i & ~63) {
        /* FFmpeg ignores the overflow where the packet is not overread
         * (err_recognition 0): the block ends at 63 */
        if (br_left(b) < 0) return MS_CORRUPT;
        i = 63;
        break;
      }
      blk[scan[i]] = (int16_t)level;
      break;
    }
    blk[scan[i]] = (int16_t)level;
  }
  m->last_index[n] = i;
  return MS_OK;
}

/* ---- macroblocks ---- */

/* ff_clean_intra_table_entries for a macroblock that is not intra */
static void clean_intra(ms_t *d) {
  for (int n = 0; n < 6; ++n) *dc_at(d, n) = 1024;
  if (d->version >= V3)
    for (int n = 0; n < 4; ++n)
      d->coded[(long)(2 * d->m.mb_y + (n >> 1)) * d->dstride[0] +
               2 * d->m.mb_x + (n & 1)] = 0;
}

/* ff_msmpeg4_coded_block_pred: luma block n's coded flag from the left,
 * above-left and above blocks' */
static uint8_t *coded_pred(ms_t *d, int n, int *pred) {
  int wrap = d->dstride[0];
  uint8_t *c = d->coded + (long)(2 * d->m.mb_y + (n >> 1)) * wrap +
               2 * d->m.mb_x + (n & 1);
  *pred = c[-1 - wrap] == c[-wrap] ? c[-1] : c[-wrap];
  return c;
}

/* msmpeg4v2_decode_motion: H.263's MVD with f_code 1, wrapped at +-64 */
static int v2_motion(ms_t *d, br_t *b, int pred, int *out) {
  int code = vlc_get(b, &d->v.mvd);
  if (code < 0) return MS_CORRUPT;
  if (code == 0) {
    ++d->count[C_MV_ZERO_CODE];
    *out = pred;
    return MS_OK;
  }
  ++d->count[C_MV_CODED];
  int val = (br_get(b, 1) ? -code : code) + pred;
  *out = val <= -64 ? val + 64 : val >= 64 ? val - 64 : val;
  return MS_OK;
}

/* ff_msmpeg4_decode_motion */
static int v3_motion(ms_t *d, br_t *b, int *mx, int *my) {
  int sym = xvlc_get(b, &d->mv), x, y;
  if (sym < 0) return MS_CORRUPT;
  if (sym) {
    x = sym >> 6;
    y = sym & 63;
    ++d->count[x == 32 && y == 32 ? C_MV_ZERO_CODE : C_MV_CODED];
  } else {
    ++d->count[C_MV_ESCAPE];
    x = (int)br_get(b, 6);
    y = (int)br_get(b, 6);
  }
  x += *mx - 32;
  y += *my - 32;
  x = x <= -64 ? x + 64 : x >= 64 ? x - 64 : x;
  y = y <= -64 ? y + 64 : y >= 64 ? y - 64 : y;
  *mx = x;
  *my = y;
  return MS_OK;
}

static int decode_mb(ms_t *d, br_t *b) {
  mb_t *m = &d->m;
  int cbp, intra, rc;
  if (d->version >= V3 && br_left(b) <= 0) return MS_CORRUPT;
  if (d->pframe && d->version != WMV2 && br_get(b, 1)) {
    /* use_skip_mb_code is 1 (WMV8's skip type is none: no flags) */
    mb_set_mv(m, 0, 0);
    memset(m->last_index, 0xff, sizeof m->last_index);
    mb_motion(m, 0, 0);
    clean_intra(d);
    ++d->count[C_P_SKIP_MB];
    return MS_OK;
  }
  if (d->version == V2) { /* msmpeg4v12_decode_mb */
    if (d->pframe) {
      int code = xvlc_get(b, &d->v2_mb_type);
      if (code < 0) return MS_CORRUPT;
      intra = code >> 2;
      cbp = code & 3;
    } else {
      intra = 1;
      cbp = xvlc_get(b, &d->v2_intra_cbpc);
      if (cbp < 0) return MS_CORRUPT;
    }
    if (intra && br_get(b, 1)) return refuse(d, R_AC_PRED);
    int cbpy = vlc_get(b, &d->v.cbpy);
    if (cbpy < 0) return MS_CORRUPT;
    cbp |= cbpy << 2;
    if (!intra && (cbp & 3) != 3) cbp ^= 0x3C;
  } else { /* msmpeg4v34_decode_mb */
    if (d->pframe) {
      int code = xvlc_get(b, d->p_mb);
      if (code < 0) return MS_CORRUPT;
      intra = !(code & 0x40);
      cbp = code & 0x3F;
    } else {
      intra = 1;
      int code = xvlc_get(b, &d->mb_i);
      if (code < 0) return MS_CORRUPT;
      cbp = 0;
      for (int n = 0; n < 6; ++n) {
        int val = (code >> (5 - n)) & 1;
        if (n < 4) {
          int pred;
          uint8_t *c = coded_pred(d, n, &pred);
          if (pred) ++d->count[C_CBP_PRED];
          val ^= pred;
          *c = (uint8_t)val;
        }
        cbp |= val << (5 - n);
      }
    }
    if (intra) {
      if (br_get(b, 1)) return refuse(d, R_AC_PRED);
      if (d->inter_intra_pred) {
        d->aic_dir = xvlc_get(b, &d->inter_intra);
        if (d->aic_dir < 0) return MS_CORRUPT;
      }
    }
    /* per_mb_rl_table 1 and WMV8's per-MB ABT are refused at the
     * picture header */
  }
  int mx = 0, my = 0;
  if (!intra) {
    int px, py;
    mb_pred_motion(m, &px, &py);
    if (d->version == V2) {
      rc = v2_motion(d, b, px, &mx);
      if (!rc) rc = v2_motion(d, b, py, &my);
    } else {
      mx = px;
      my = py;
      rc = v3_motion(d, b, &mx, &my);
    }
    if (rc) return rc;
  }
  memset(m->block, 0, sizeof m->block);
  for (int n = 0; n < 6; ++n) {
    rc = decode_block(d, b, n, (cbp >> (5 - n)) & 1, intra);
    if (rc) return rc;
  }
  mb_set_mv(m, mx, my);
  if (intra) {
    mb_put_intra(m, d->y_dc_scale, d->c_dc_scale);
    ++d->count[d->pframe ? C_P_INTRA_MB : C_I_MB];
  } else {
    mb_motion(m, mx, my);
    mb_add_inter(m);
    clean_intra(d);
    ++d->count[C_P_INTER_MB];
  }
  return MS_OK;
}

/* ---- pictures ---- */

/* ff_msmpeg4_decode_ext_header: fps, bit rate and (v3 on)
 * flipflop_rounding where `bytes` bytes leave room for them */
static void ext_header(ms_t *d, br_t *b, long bytes) {
  long left = bytes * 8 - b->pos;
  int length = d->version >= V3 ? 17 : 16;
  if (left >= length && left < length + 8) {
    ++d->count[C_EXT_HEADER];
    b->pos += 5; /* fps */
    d->bit_rate = (int)br_get(b, 11) * 1024;
    d->flipflop = d->version >= V3 ? (int)br_get(b, 1) : 0;
  } else if (left < length + 8) {
    d->flipflop = 0;
  }
}

/* ff_msmpeg4_decode_picture_header.  The writer always writes DC and MV
 * table 1 and the skip flags (msmpeg4enc sets dc_table_index,
 * mv_table_index and use_skip_mb_code to 1), so the other settings are
 * refused by name rather than decoded unchecked. */
static int picture_header(ms_t *d, br_t *b) {
  mb_t *m = &d->m;
  if (br_left(b) * 8 < (long)m->mb_w * m->mb_h) return MS_CORRUPT;
  int type = (int)br_get(b, 2) + 1;
  if (type != 1 && type != 2) return MS_CORRUPT;
  d->pframe = type == 2;
  m->q = (int)br_get(b, 5);
  if (!m->q) return MS_CORRUPT;
  if (!d->pframe) {
    int code = (int)br_get(b, 5);
    if (code < 0x17) return MS_CORRUPT;
    if (code != 0x17) return refuse(d, R_SLICES);
    if (d->version == V2) {
      d->rl_chroma_index = d->rl_index = 2;
    } else {
      if (d->version == WMV1) {
        ext_header(d, b, (2 + 5 + 5 + 17 + 7) / 8);
        if (d->bit_rate > MBAC_BITRATE && br_get(b, 1))
          return refuse(d, R_PER_MB_RL);
        d->inter_intra_pred = 0;
      }
      d->rl_chroma_index = decode012(b);
      d->rl_index = decode012(b);
      if (!br_get(b, 1)) return refuse(d, R_DC_TABLE0);
    }
    d->no_rounding = 1;
  } else {
    if (!br_get(b, 1)) return refuse(d, R_NO_SKIP_CODE);
    if (d->version == V2) {
      d->rl_chroma_index = d->rl_index = 2;
    } else {
      if (d->version == WMV1 && d->bit_rate > MBAC_BITRATE && br_get(b, 1))
        return refuse(d, R_PER_MB_RL);
      d->rl_chroma_index = d->rl_index = decode012(b);
      if (!br_get(b, 1)) return refuse(d, R_DC_TABLE0);
      if (!br_get(b, 1)) return refuse(d, R_MV_TABLE0);
      if (d->version == WMV1)
        d->inter_intra_pred = (long)m->width * m->height < 320 * 240 &&
                              d->bit_rate <= II_BITRATE;
    }
    d->no_rounding = d->flipflop ? d->no_rounding ^ 1 : 0;
    ++d->count[d->no_rounding ? C_ROUND1 : C_ROUND0];
  }
  d->esc3_level_len = d->esc3_run_len = 0;
  return MS_OK;
}

/* ff_wmv2_decode_picture_header and
 * ff_wmv2_decode_secondary_picture_header.  The writer writes no IntraX8,
 * no mspel, one ABT type of 0, no run/level table per macroblock, skip
 * type none, cbp_index 0 and DC and MV table 1 (wmv2enc.c); the other
 * settings are refused by name. */
static int wmv2_picture_header(ms_t *d, br_t *b) {
  /* wmv2_get_cbp_table_index */
  static const uint8_t cbp_map[3][3] = {{0, 2, 1}, {1, 0, 2}, {2, 1, 0}};
  mb_t *m = &d->m;
  d->pframe = (int)br_get(b, 1);
  if (!d->pframe) b->pos += 7;
  m->q = (int)br_get(b, 5);
  if (!m->q) return MS_CORRUPT;
  if (!d->pframe) {
    if (d->j_type_bit && br_get(b, 1)) return refuse(d, R_INTRAX8);
    if (d->per_mb_rl_bit && br_get(b, 1)) return refuse(d, R_PER_MB_RL);
    d->rl_chroma_index = decode012(b);
    d->rl_index = decode012(b);
    if (!br_get(b, 1)) return refuse(d, R_DC_TABLE0);
    if (br_left(b) * 8 < (long)m->mb_w * m->mb_h) return MS_CORRUPT;
    d->no_rounding = 1;
  } else {
    if (br_get(b, 2)) return refuse(d, R_SKIP_TYPE);
    /* parse_mb_skip: a bit at least for each coded macroblock */
    if ((long)m->mb_w * m->mb_h > br_left(b)) return MS_CORRUPT;
    int table = cbp_map[(m->q > 10) + (m->q > 20)][decode012(b)];
    d->p_mb = &d->wmv2_inter[table];
    ++d->count[C_CBP_TABLE0 + table];
    if (d->mspel_bit && br_get(b, 1)) return refuse(d, R_MSPEL);
    /* per_mb_abt is the bit's complement; abt_type 0 is 8x8 */
    if (d->abt_flag && (!br_get(b, 1) || decode012(b)))
      return refuse(d, R_ABT);
    if (d->per_mb_rl_bit && br_get(b, 1)) return refuse(d, R_PER_MB_RL);
    d->rl_chroma_index = d->rl_index = decode012(b);
    if (br_left(b) < 2) return MS_CORRUPT;
    if (!br_get(b, 1)) return refuse(d, R_DC_TABLE0);
    if (!br_get(b, 1)) return refuse(d, R_MV_TABLE0);
    d->no_rounding ^= 1;
    ++d->count[d->no_rounding ? C_ROUND1 : C_ROUND0];
  }
  d->inter_intra_pred = 0;
  d->esc3_level_len = d->esc3_run_len = 0;
  return MS_OK;
}

static int decode_picture(ms_t *d, br_t *b, long bytes) {
  mb_t *m = &d->m;
  int rc = d->version == WMV2 ? wmv2_picture_header(d, b)
                              : picture_header(d, b);
  if (rc) return rc;
  if (d->pframe && !d->have_ref) return refuse(d, R_NO_REFERENCE);
  /* ff_set_qscale's DC scales */
  if (d->version == V2) {
    d->y_dc_scale = d->c_dc_scale = 8;
  } else if (d->version == V3) {
    d->y_dc_scale = old_y_dc_scale[m->q];
    d->c_dc_scale = wmv1_c_dc_scale[m->q];
  } else {
    d->y_dc_scale = wmv1_y_dc_scale[m->q];
    d->c_dc_scale = wmv1_c_dc_scale[m->q];
  }
  m->rounding = d->no_rounding;
  ++d->count[d->pframe ? C_PPIC : C_IPIC];
  m->cur = d->have_ref ? m->ref ^ 1 : 0;
  for (m->mb_y = 0; m->mb_y < m->mb_h; ++m->mb_y)
    for (m->mb_x = 0; m->mb_x < m->mb_w; ++m->mb_x) {
      rc = decode_mb(d, b);
      if (rc) return rc;
      if (br_left(b) < 0) return MS_CORRUPT;
    }
  if (d->version < WMV1 && !d->pframe) ext_header(d, b, bytes);
  m->ref = m->cur;
  d->have_ref = 1;
  return MS_OK;
}

/* ---- WMV8's transform: ff_wmv2_idct_c (wmv2dsp.c) ---- */

enum { WW0 = 2048, WW1 = 2841, WW2 = 2676, WW3 = 2408, WW5 = 1609,
       WW6 = 1108, WW7 = 565 };

static void wmv2_idct_row(int16_t *b) {
  int a1 = WW1 * b[1] + WW7 * b[7], a7 = WW7 * b[1] - WW1 * b[7];
  int a5 = WW5 * b[5] + WW3 * b[3], a3 = WW3 * b[5] - WW5 * b[3];
  int a2 = WW2 * b[2] + WW6 * b[6], a6 = WW6 * b[2] - WW2 * b[6];
  int a0 = WW0 * b[0] + WW0 * b[4], a4 = WW0 * b[0] - WW0 * b[4];
  int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 7)) >> 8);
  b[1] = (int16_t)((a4 + a6 + s1 + (1 << 7)) >> 8);
  b[2] = (int16_t)((a4 - a6 + s2 + (1 << 7)) >> 8);
  b[3] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 7)) >> 8);
  b[4] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 7)) >> 8);
  b[5] = (int16_t)((a4 - a6 - s2 + (1 << 7)) >> 8);
  b[6] = (int16_t)((a4 + a6 - s1 + (1 << 7)) >> 8);
  b[7] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 7)) >> 8);
}

static void wmv2_idct_col(int16_t *b) {
  int a1 = (WW1 * b[8] + WW7 * b[56] + 4) >> 3;
  int a7 = (WW7 * b[8] - WW1 * b[56] + 4) >> 3;
  int a5 = (WW5 * b[40] + WW3 * b[24] + 4) >> 3;
  int a3 = (WW3 * b[40] - WW5 * b[24] + 4) >> 3;
  int a2 = (WW2 * b[16] + WW6 * b[48] + 4) >> 3;
  int a6 = (WW6 * b[16] - WW2 * b[48] + 4) >> 3;
  int a0 = (WW0 * b[0] + WW0 * b[32]) >> 3;
  int a4 = (WW0 * b[0] - WW0 * b[32]) >> 3;
  int s1 = (int)(181u * (unsigned)(a1 - a5 + a7 - a3) + 128) >> 8;
  int s2 = (int)(181u * (unsigned)(a1 - a5 - a7 + a3) + 128) >> 8;
  b[0] = (int16_t)((a0 + a2 + a1 + a5 + (1 << 13)) >> 14);
  b[8] = (int16_t)((a4 + a6 + s1 + (1 << 13)) >> 14);
  b[16] = (int16_t)((a4 - a6 + s2 + (1 << 13)) >> 14);
  b[24] = (int16_t)((a0 - a2 + a7 + a3 + (1 << 13)) >> 14);
  b[32] = (int16_t)((a0 - a2 - a7 - a3 + (1 << 13)) >> 14);
  b[40] = (int16_t)((a4 - a6 - s2 + (1 << 13)) >> 14);
  b[48] = (int16_t)((a4 + a6 - s1 + (1 << 13)) >> 14);
  b[56] = (int16_t)((a0 + a2 - a1 - a5 + (1 << 13)) >> 14);
}

static void wmv2_idct(int16_t *blk) {
  for (int i = 0; i < 64; i += 8) wmv2_idct_row(blk + i);
  for (int i = 0; i < 8; ++i) wmv2_idct_col(blk + i);
}

/* put_pixels_clamped_c */
static void wmv2_idct_put(int16_t *blk, uint8_t *dst, long stride) {
  wmv2_idct(blk);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) dst[r * stride + c] = clip_u8(blk[8 * r + c]);
}

/* add_pixels_clamped_c */
static void wmv2_idct_add(int16_t *blk, uint8_t *dst, long stride) {
  wmv2_idct(blk);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + blk[8 * r + c]);
}

/* ---- API ---- */

static void ms_free(ms_t *d) {
  xvlc_free(&d->mb_i);
  xvlc_free(&d->mb_non_intra);
  xvlc_free(&d->mv);
  for (int k = 0; k < 2; ++k) {
    xvlc_free(&d->dc_vlc[k]);
    xvlc_free(&d->v2_dc[k]);
  }
  xvlc_free(&d->inter_intra);
  xvlc_free(&d->v2_mb_type);
  xvlc_free(&d->v2_intra_cbpc);
  for (int k = 0; k < 3; ++k) xvlc_free(&d->wmv2_inter[k]);
  for (int k = 0; k < 6; ++k) xvlc_free(&d->rl[k].vlc);
  mb_free(&d->m);
  for (int p = 0; p < 3; ++p)
    free(d->dc[p] ? d->dc[p] - d->dstride[p] - 1 : NULL);
  free(d->coded ? d->coded - d->dstride[0] - 1 : NULL);
  free(d);
}

/* init_h263_dc_for_msmpeg4: v2's DC VLC, level + 256 as the symbol */
static int v2_dc_build(xvlc_t *v, const uint8_t *code, const uint8_t *len) {
  uint32_t codes[512];
  uint8_t lens[512];
  for (int level = -256; level < 256; ++level) {
    int size = 0, l, v_ = abs(level);
    while (v_) {
      v_ >>= 1;
      ++size;
    }
    l = level < 0 ? (-level) ^ ((1 << size) - 1) : level;
    uint32_t c = code[size] ^ ((1u << len[size]) - 1);
    int n = len[size];
    if (size > 0) {
      c = (c << size) | (uint32_t)l;
      n += size;
      if (size > 8) {
        c = (c << 1) | 1;
        ++n;
      }
    }
    codes[level + 256] = c;
    lens[level + 256] = (uint8_t)n;
  }
  return xvlc_build(v, 512, codes, lens);
}

static int small_build(xvlc_t *v, int n, const uint8_t *code,
                       const uint8_t *len) {
  uint32_t codes[8];
  for (int i = 0; i < n; ++i) codes[i] = code[i];
  return xvlc_build(v, n, codes, len);
}

/* A decoder for MS MPEG-4 v2 (version 2), v3 (3), WMV7 (4) or WMV8 (5)
 * pictures of width x height; NULL where memory runs out.  WMV8 reads its
 * extension header (fl_msmpeg4_ext_header) before its first packet. */
void *fl_msmpeg4_open(int version, int width, int height) {
  if (version < V2 || version > WMV2 || width < 1 || height < 1 ||
      width > 16384 || height > 16384)
    return NULL;
  ms_t *d = (ms_t *)calloc(1, sizeof(ms_t));
  if (!d) return NULL;
  d->version = version;
  mb_vlcs_build(&d->v);
  d->m.paths = d->count + C_MV_ZERO_CODE;
  int rc = MS_OK;
  {
    uint32_t codes[128];
    for (int i = 0; i < 64; ++i) codes[i] = msmp4_mb_i_code[i];
    rc |= xvlc_build(&d->mb_i, 64, codes, msmp4_mb_i_len);
    rc |= xvlc_build(&d->mb_non_intra, 128, msmp4_mb_non_intra_code,
                     msmp4_mb_non_intra_len);
    for (int k = 0; k < 3; ++k)
      rc |= xvlc_build(&d->wmv2_inter[k], 128, wmv2_inter_code[k],
                       wmv2_inter_len[k]);
  }
  d->p_mb = &d->mb_non_intra;
  for (int c = 0; c < 2; ++c)
    rc |= xvlc_build(&d->dc_vlc[c], 120, msmp4_dc_code[1][c],
                     msmp4_dc_len[1][c]);
  { /* ff_vlc_init_from_lengths' codes */
    uint32_t codes[4096];
    uint8_t lens[4096];
    uint64_t code = 0;
    memset(lens, 0, sizeof lens);
    for (int i = 0; i < 1100; ++i) {
      int n = msmp4_mv_len[1][i], s = msmp4_mv_sym[1][i];
      /* the symbol mx << 8 | my (mx, my < 64) as mx << 6 | my */
      codes[((s >> 8) << 6) | (s & 0xFF)] = (uint32_t)(code >> (32 - n));
      lens[((s >> 8) << 6) | (s & 0xFF)] = (uint8_t)n;
      code += 1ull << (32 - n);
    }
    rc |= xvlc_build(&d->mv, 4096, codes, lens);
  }
  rc |= v2_dc_build(&d->v2_dc[0], dc_lum_code, dc_lum_len);
  rc |= v2_dc_build(&d->v2_dc[1], dc_chrom_code, dc_chrom_len);
  rc |= small_build(&d->inter_intra, 4, inter_intra_code, inter_intra_len);
  rc |= small_build(&d->v2_mb_type, 8, v2_mb_type_code, v2_mb_type_len);
  rc |= small_build(&d->v2_intra_cbpc, 4, v2_intra_cbpc_code,
                    v2_intra_cbpc_len);
  rc |= rl_build(&d->rl[0], MSMP4_RL0_N, MSMP4_RL0_LAST, msmp4_rl0_code,
                 msmp4_rl0_len, msmp4_rl0_run, msmp4_rl0_level);
  rc |= rl_build(&d->rl[1], MSMP4_RL1_N, MSMP4_RL1_LAST, msmp4_rl1_code,
                 msmp4_rl1_len, msmp4_rl1_run, msmp4_rl1_level);
  rc |= rl_build(&d->rl[2], MSMP4_RL2_N, MSMP4_RL2_LAST, msmp4_rl2_code,
                 msmp4_rl2_len, msmp4_rl2_run, msmp4_rl2_level);
  rc |= rl_build(&d->rl[3], MSMP4_RL3_N, MSMP4_RL3_LAST, msmp4_rl3_code,
                 msmp4_rl3_len, msmp4_rl3_run, msmp4_rl3_level);
  rc |= rl_build(&d->rl[4], MSMP4_RL4_N, MSMP4_RL4_LAST, msmp4_rl4_code,
                 msmp4_rl4_len, msmp4_rl4_run, msmp4_rl4_level);
  rc |= rl_build(&d->rl[5], MSMP4_RL5_N, MSMP4_RL5_LAST, msmp4_rl5_code,
                 msmp4_rl5_len, msmp4_rl5_run, msmp4_rl5_level);
  if (rc || mb_alloc(&d->m, width, height)) {
    ms_free(d);
    return NULL;
  }
  for (int p = 0; p < 3; ++p) {
    int cols = p ? d->m.mb_w : 2 * d->m.mb_w;
    int rows = p ? d->m.mb_h : 2 * d->m.mb_h;
    long n = (long)(cols + 2) * (rows + 2);
    d->dstride[p] = cols + 2;
    int16_t *dc = (int16_t *)malloc((size_t)n * sizeof(int16_t));
    if (!dc) {
      ms_free(d);
      return NULL;
    }
    for (long i = 0; i < n; ++i) dc[i] = 1024;
    d->dc[p] = dc + d->dstride[p] + 1;
    if (!p) {
      uint8_t *coded = (uint8_t *)calloc((size_t)n, 1);
      if (!coded) {
        ms_free(d);
        return NULL;
      }
      d->coded = coded + d->dstride[0] + 1;
    }
  }
  d->intra_scan = version >= WMV1 ? wmv1_scan[1] : zigzag;
  d->inter_scan = version >= WMV1 ? wmv1_scan[0] : zigzag;
  if (version == WMV2) {
    d->m.idct_put = wmv2_idct_put;
    d->m.idct_add = wmv2_idct_add;
  }
  return d;
}

/* WMV8's decode_ext_header: the settings of the stream's pictures from
 * the container's extradata (n bytes).  MS_OK, or MS_REFUSED + the R_* of
 * a tool the writer never switches on (the loop filter, the top-left MV
 * flag, a slice code other than 1) or of a stream without the header,
 * whose pictures FFmpeg then leaves undecoded. */
int fl_msmpeg4_ext_header(void *h, const uint8_t *data, long n) {
  ms_t *d = (ms_t *)h;
  uint8_t buf[12] = {0};
  if (d->version != WMV2) return MS_CORRUPT;
  if (n < 4) return refuse(d, R_NO_EXT_HEADER);
  memcpy(buf, data, 4);
  br_t b = {buf, 32, 0};
  ++d->count[C_EXT_HEADER];
  b.pos += 5 + 11; /* fps and bit rate: no WMV8 tool reads them */
  d->mspel_bit = (int)br_get(&b, 1);
  int loop_filter = (int)br_get(&b, 1);
  d->abt_flag = (int)br_get(&b, 1);
  d->j_type_bit = (int)br_get(&b, 1);
  int top_left_mv_flag = (int)br_get(&b, 1);
  d->per_mb_rl_bit = (int)br_get(&b, 1);
  int code = (int)br_get(&b, 3);
  if (loop_filter) return refuse(d, R_LOOP_FILTER);
  if (top_left_mv_flag) return refuse(d, R_TOP_LEFT_MV);
  if (code != 1) return refuse(d, R_SLICES);
  return MS_OK;
}

/* Decode one packet.  MS_OK: a frame (fl_msmpeg4_bgr converts it);
 * MS_CORRUPT; MS_NOMEM; MS_REFUSED + the tool's R_*. */
int fl_msmpeg4_decode(void *h, const uint8_t *data, long n) {
  ms_t *d = (ms_t *)h;
  uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
  if (!buf) return MS_NOMEM;
  memcpy(buf, data, (size_t)n);
  br_t b = {buf, n * 8, 0};
  int rc = decode_picture(d, &b, n);
  free(buf);
  return rc;
}

/* The last frame as BGR (H, W, 3). */
int fl_msmpeg4_bgr(void *h, uint8_t *out) {
  const mb_t *m = &((ms_t *)h)->m;
  yuv_planes_t p = {m->pic[m->cur][0], m->pic[m->cur][1], m->pic[m->cur][2],
                    m->ys, m->cs};
  return yuv_to_bgr(&p, m->width, m->height, 1, 1, 0, out);
}

/* The last frame's planes, cropped: y (H x W), u and v (ceil(H/2) x
 * ceil(W/2)), each packed. */
void fl_msmpeg4_planes(void *h, uint8_t *y, uint8_t *u, uint8_t *v) {
  mb_planes(&((ms_t *)h)->m, y, u, v);
}

/* The syntax path counters (C_NPATHS of them) and the last refusal. */
int fl_msmpeg4_counts(void *h, uint64_t *out) {
  ms_t *d = (ms_t *)h;
  memcpy(out, d->count, sizeof d->count);
  return d->refused;
}

void fl_msmpeg4_close(void *h) {
  if (h) ms_free((ms_t *)h);
}
