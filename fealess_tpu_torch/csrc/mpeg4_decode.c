/* MPEG-4 Part 2 video for io/mpeg4.py: what cv2.VideoCapture returns for
 * the streams cv2.VideoWriter writes with the fourccs mp4v, MP4V, XVID,
 * xvid, FMP4, DIVX and DX50, bit for bit.  cv2 decodes them with FFmpeg's
 * mpeg4 decoder (libavcodec 62.28 in cv2 5.0.0) and converts its yuv420p
 * planes to BGR24 with swscale (yuv_bgr.h, the raw I420 path's
 * converter).  What that writer produces is FFmpeg's own mpeg4 encoder at
 * its defaults: I- and P-VOPs only, 1MV, H.263 quantisation, no AC
 * prediction, no resync markers, even sizes, user data "Lavc62.28.101".
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.  A decoder
 * keeps the VOL, the reference picture and the prediction state across
 * packets.
 *
 * The stages and the FFmpeg functions they follow:
 *   headers      ff_mpeg4_decode_picture_header: start codes byte by byte;
 *                VOS, VO, VOL (decode_vol_header), user data
 *                (decode_user_data: the Lavc / XviD / DivX strings), GOV,
 *                then the VOP (decode_vop_header); a VOP not coded gives
 *                no picture (cv2 drops it)
 *   macroblocks  mpeg4_decode_mb: MCBPC, ac_pred_flag, CBPY, the 1MV
 *                motion vector (ff_h263_pred_motion's median,
 *                ff_h263_decode_motion with vop_fcode_forward)
 *   blocks       mpeg4_decode_block: the DC size VLC and DC prediction
 *                (ff_mpeg4_pred_dc: dc_val holds level * scale clipped to
 *                0..2047, 1024 outside the picture and in inter blocks),
 *                the intra (Table B-16) and inter (B-17) TCOEF VLCs with
 *                the three escape modes, zigzag scan
 *   dequant      H.263: inter levels come out of the table dequantised
 *                (level * 2q + ((q - 1) | 1)); intra AC the same, the DC
 *                times the DC scaler (dct_unquantize_h263_intra_c), all in
 *                int16 as FFmpeg's blocks are
 *   IDCT         ff_simple_idct_put / _add_int16_8bit (simple_idct.h,
 *                shared with mjpeg_decode.c and mpeg2_decode.c)
 *   motion       mpeg_motion at half-pel, reference samples clamped to
 *                the macroblock-aligned picture; vop_rounding_type picks
 *                put_pixels or put_no_rnd_pixels
 * The inter TCOEF, MCBPC, CBPY and MVD tables, the bit reader, the vector
 * prediction and decoding, motion compensation and the reconstruction
 * are h263_mb.h's, shared with h263_decode.c (H.263 and Sorenson Spark).
 *   output       the picture cropped to the VOL's size, yuv420p at
 *                limited range to BGR24 through yuv_bgr.h
 *
 * A tool no stream of that writer holds is refused with its name's code
 * (MP4_REFUSED + M_*), at the VOL where it shows there, else at the VOP or
 * macroblock that uses it; so are the user data and fourccs that make
 * FFmpeg switch to the Xvid IDCT or to its bug workarounds, and an odd
 * height (cv2 gives swscale the decoder's left chroma siting, which moves
 * the scaler path an odd height takes).  Every syntax path that is
 * decoded bumps a counter (C_*), so a test holds the committed clips to
 * covering all of them.
 */
#include "h263_mb.h"
#include "simple_idct.h"
#include "yuv_bgr.h"

#include <stdio.h>
#include <string.h>

enum { MP4_OK = 0, MP4_SKIPPED = 1, MP4_CORRUPT = -1, MP4_NOMEM = -2,
       MP4_REFUSED = 100 };

/* tools refused, by name in io/mpeg4.py */
enum {
  M_BVOP = 1, M_SVOP, M_QPEL, M_INTERLACE, M_MPEG_QUANT, M_4MV, M_RESYNC,
  M_PARTITION, M_SHORT_HEADER, M_SHAPE, M_NOT_8_BIT, M_XVID, M_DIVX,
  M_OLD_LAVC, M_SCALABILITY, M_COMPLEXITY, M_OBMC, M_VERID, M_DQUANT,
  M_STUFFING, M_DC_THRESHOLD, M_RESIZE, M_STUDIO, M_SIGNAL_TYPE,
  M_NO_REFERENCE, M_VBV, M_ASPECT, M_FIXED_RATE, M_AC_PRED, M_DC_SIZE,
  M_ODD_HEIGHT
};

/* syntax paths counted */
enum {
  C_VOS, C_VO, C_VOL, C_VOL_EXTRADATA, C_USER_DATA, C_GOV, C_IVOP, C_PVOP,
  C_NOT_CODED_VOP, C_I_MB, C_P_INTRA_MB, C_P_INTER_MB, C_P_SKIP_MB,
  C_INTRA_UNCODED_BLOCK, C_INTER_CODED_BLOCK, C_DC_ZERO, C_DC_TOP,
  C_DC_LEFT, C_ESC1_INTRA, C_ESC2_INTRA,
  C_ESC3_INTRA, C_ESC1_INTER, C_ESC2_INTER, C_ESC3_INTER, C_ROUND0,
  C_ROUND1, C_FCODE1, C_FCODE2UP, C_MV_ZERO_CODE, C_MV_CODED, C_MC_FULL,
  C_MC_X, C_MC_Y, C_MC_XY, C_MC_CLAMPED, C_NPATHS
};

/* ---- tables ---- */

/* Table B-16 (intra TCOEF); LAST from index 67 on */
static const uint16_t intra_code[103] = {
    2, 6, 15, 13, 12, 21, 19, 18, 23, 31, 30, 29,
    37, 36, 35, 33, 33, 32, 15, 14, 7, 6, 32, 33,
    80, 81, 82, 14, 20, 22, 28, 32, 31, 13, 34, 83,
    85, 11, 21, 30, 12, 86, 17, 27, 29, 11, 16, 34,
    10, 13, 28, 8, 18, 27, 84, 20, 26, 87, 25, 9,
    24, 35, 23, 25, 24, 7, 88, 7, 12, 22, 23, 6,
    5, 4, 89, 15, 22, 5, 14, 4, 17, 36, 16, 37,
    19, 90, 21, 91, 20, 19, 26, 21, 20, 19, 18, 17,
    38, 39, 92, 93, 94, 95, 3,
};
static const uint8_t intra_len[103] = {
    2, 3, 4, 5, 5, 6, 6, 6, 7, 8, 8, 8,
    9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11,
    12, 12, 12, 4, 6, 7, 8, 9, 9, 10, 11, 12,
    12, 5, 7, 9, 10, 12, 6, 8, 9, 10, 6, 9,
    10, 6, 9, 10, 7, 9, 12, 7, 9, 12, 8, 10,
    8, 11, 8, 9, 9, 10, 12, 4, 6, 8, 9, 10,
    11, 11, 12, 6, 9, 10, 6, 10, 7, 11, 7, 11,
    7, 12, 8, 12, 8, 8, 8, 9, 9, 9, 9, 9,
    11, 11, 12, 12, 12, 12, 7,
};
static const uint8_t intra_run[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 5, 5, 5, 6, 6, 6, 7, 7, 7, 8, 8,
    9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0,
    0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20,
};
static const uint8_t intra_level[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2,
    1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5,
    6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2,
    1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1,
};

/* Tables B-13 and B-14: dct_dc_size for luma and chroma */
static const uint16_t dc_lum_code[13] = {3, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                         1, 1};
static const uint8_t dc_lum_len[13] = {3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10,
                                       11};
static const uint16_t dc_chrom_code[13] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                           1, 1};
static const uint8_t dc_chrom_len[13] = {2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                         11, 12};

/* ff_mpeg4_y_dc_scale_table / ff_mpeg4_c_dc_scale_table */
static const uint8_t y_dc_scale[32] = {
    0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
static const uint8_t c_dc_scale[32] = {
    0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
    14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};

/* ---- decoder ---- */

typedef struct {
  const uint16_t *code;
  const uint8_t *len, *run, *level;
  int last; /* first index that ends the block */
  uint8_t max_level[2][64], max_run[2][64];
} rl_t;

typedef struct {
  mb_vlcs_t v;
  vlc_t intra_tc, dc_lum, dc_chrom;
  rl_t rl_intra, rl_inter;
  mb_t m; /* pictures, vectors and the macroblock being decoded */
  /* stream */
  int tag;             /* 1: a fourcc FFmpeg takes for Xvid, 2: DIVX */
  int have_vol, time_inc_bits;
  int vo_type, vol_control;
  int lavc_build, xvid_build, divx_version;
  int have_ref;
  /* DC predictors, each with a border of one entry all round */
  int16_t *dc[3];
  int dstride[3];
  /* the VOP */
  int pict;
  uint64_t count[C_NPATHS];
  int refused; /* the M_* of the last refusal */
} mp4_t;

static void rl_init(rl_t *rl, const uint16_t *code, const uint8_t *len,
                    const uint8_t *run, const uint8_t *level, int last) {
  rl->code = code;
  rl->len = len;
  rl->run = run;
  rl->level = level;
  rl->last = last;
  memset(rl->max_level, 0, sizeof rl->max_level);
  memset(rl->max_run, 0, sizeof rl->max_run);
  for (int i = 0; i < 102; ++i) { /* ff_rl_init */
    int l = i >= last;
    if (level[i] > rl->max_level[l][run[i]])
      rl->max_level[l][run[i]] = level[i];
    if (run[i] > rl->max_run[l][level[i]]) rl->max_run[l][level[i]] = run[i];
  }
}

static void free_pictures(mp4_t *d) {
  mb_free(&d->m);
  for (int p = 0; p < 3; ++p) {
    free(d->dc[p] ? d->dc[p] - d->dstride[p] - 1 : NULL);
    d->dc[p] = NULL;
  }
}

/* pictures and prediction arrays for the VOL's size */
static int alloc_pictures(mp4_t *d, int width, int height) {
  if (mb_alloc(&d->m, width, height)) return MP4_NOMEM;
  for (int p = 0; p < 3; ++p) {
    int cols = p ? d->m.mb_w : 2 * d->m.mb_w;
    int rows = p ? d->m.mb_h : 2 * d->m.mb_h;
    long n = (long)(cols + 2) * (rows + 2);
    d->dstride[p] = cols + 2;
    int16_t *dc = (int16_t *)malloc((size_t)n * sizeof(int16_t));
    if (!dc) return MP4_NOMEM;
    for (long i = 0; i < n; ++i) dc[i] = 1024;
    d->dc[p] = dc + d->dstride[p] + 1;
  }
  d->have_ref = 0;
  return MP4_OK;
}

static int refuse(mp4_t *d, int tool) {
  d->refused = tool;
  return MP4_REFUSED + tool;
}

/* ---- headers ---- */

static int decode_vol(mp4_t *d, br_t *b) {
  b->pos += 1; /* random_accessible_vol */
  d->vo_type = (int)br_get(b, 8);
  if (d->vo_type == 14 || d->vo_type == 15) return refuse(d, M_STUDIO);
  int verid = 1;
  if (br_get(b, 1)) { /* is_object_layer_identifier */
    verid = (int)br_get(b, 4);
    b->pos += 3;
  }
  if (br_get(b, 4) == 15) return refuse(d, M_ASPECT); /* extended PAR */
  d->vol_control = (int)br_get(b, 1);
  if (d->vol_control) {
    b->pos += 2 + 1; /* chroma_format, low_delay */
    if (br_get(b, 1)) return refuse(d, M_VBV);
  }
  if (br_get(b, 2) != 0) return refuse(d, M_SHAPE);
  b->pos += 1; /* marker */
  int resolution = (int)br_get(b, 16);
  if (!resolution) return MP4_CORRUPT;
  int bits = 0;
  while ((1 << bits) < resolution) ++bits; /* av_log2(res - 1) + 1 */
  d->time_inc_bits = bits < 1 ? 1 : bits;
  b->pos += 1;
  if (br_get(b, 1)) return refuse(d, M_FIXED_RATE);
  b->pos += 1;
  int w = (int)br_get(b, 13);
  b->pos += 1;
  int h = (int)br_get(b, 13);
  b->pos += 1;
  if (br_get(b, 1)) return refuse(d, M_INTERLACE);
  if (!br_get(b, 1)) return refuse(d, M_OBMC);
  if (br_get(b, verid == 1 ? 1 : 2)) return refuse(d, M_SVOP);
  if (br_get(b, 1)) return refuse(d, M_NOT_8_BIT);
  if (br_get(b, 1)) return refuse(d, M_MPEG_QUANT);
  if (verid != 1 && br_get(b, 1)) return refuse(d, M_QPEL);
  if (br_left(b) < 4) return MP4_CORRUPT;
  if (!br_get(b, 1)) return refuse(d, M_COMPLEXITY);
  if (!br_get(b, 1)) return refuse(d, M_RESYNC);
  if (br_get(b, 1)) return refuse(d, M_PARTITION);
  /* newpred_enable and reduced_resolution_vop_enable follow for verid 2
   * and up: such a VOL is refused whatever they say */
  if (verid != 1) return refuse(d, M_VERID);
  if (br_get(b, 1)) return refuse(d, M_SCALABILITY);
  if (!w || !h) return MP4_CORRUPT;
  /* cv2 hands swscale the decoder's chroma siting (left), which changes
   * the scaler path an odd height takes; cv2.VideoWriter writes even
   * sizes only */
  if (h & 1) return refuse(d, M_ODD_HEIGHT);
  if (d->have_vol && (w != d->m.width || h != d->m.height))
    return refuse(d, M_RESIZE);
  if (!d->have_vol) {
    int rc = alloc_pictures(d, w, h);
    if (rc) return rc;
    d->have_vol = 1;
  }
  ++d->count[C_VOL];
  return MP4_OK;
}

/* decode_user_data: the encoder strings FFmpeg acts on */
static void decode_user_data(mp4_t *d, br_t *b) {
  char buf[256];
  int i;
  for (i = 0; i < 255 && b->pos < b->nbits; ++i) {
    if (br_show(b, 23) == 0) break;
    buf[i] = (char)br_get(b, 8);
  }
  buf[i] = 0;
  ++d->count[C_USER_DATA];
  int ver = 0, ver2 = 0, ver3 = 0;
  if (!strncmp(buf, "DivX", 4)) d->divx_version = 0;
  if (!strncmp(buf, "XviD", 4)) d->xvid_build = 0;
  if (!strncmp(buf, "FFmpe", 5) || !strcmp(buf, "ffmpeg"))
    d->lavc_build = 0; /* builds from before 2008 */
  char c;
  if (sscanf(buf, "Lavc%d.%d.%d%c", &ver, &ver2, &ver3, &c) >= 3)
    d->lavc_build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) +
                    (ver3 & 0xFF);
}

/* ff_mpeg4_workaround_bugs' choices, checked before each VOP: only what
 * leaves FFmpeg on the simple IDCT with no workaround is read */
static int check_encoder(mp4_t *d) {
  if (d->xvid_build >= 0) return refuse(d, M_XVID);
  if (d->divx_version >= 0) return refuse(d, M_DIVX);
  if (d->lavc_build >= 0) {
    int lb = d->lavc_build;
    /* FF_BUG_STD_QPEL .. FF_BUG_DC_CLIP below 4713; FF_BUG_IEDGE */
    if (lb <= 4712 ||
        ((lb & 0xFF) >= 100 && lb > 3621476 && lb < 3752552 &&
         (lb < 3752037 || lb > 3752191)))
      return refuse(d, M_OLD_LAVC);
    return MP4_OK;
  }
  if (d->tag == 1) return refuse(d, M_XVID);
  if (d->tag == 2 && d->vo_type == 0 && d->vol_control == 0)
    return refuse(d, M_DIVX);
  return MP4_OK;
}

/* the start codes before the VOP; returns MP4_OK at a VOP (its header
 * bits next), MP4_SKIPPED at the end of the data */
static int decode_headers(mp4_t *d, br_t *b, int extradata) {
  uint32_t startcode = 0xff;
  int vol = 0;
  b->pos = (b->pos + 7) & ~7L;
  for (;;) {
    if (b->pos >= b->nbits) return MP4_SKIPPED;
    startcode = ((startcode << 8) | br_get(b, 8)) & 0xffffffffu;
    if ((startcode & 0xFFFFFF00u) != 0x100) continue;
    if (startcode >= 0x120 && startcode <= 0x12F) {
      if (!vol) { /* FFmpeg ignores a second VOL in one packet */
        vol = 1;
        int rc = decode_vol(d, b);
        if (rc) return rc;
        if (extradata) ++d->count[C_VOL_EXTRADATA];
      }
    } else if (startcode == 0x1B2) {
      decode_user_data(d, b);
    } else if (startcode == 0x1B3) {
      if (!br_show(b, 23)) return MP4_CORRUPT;
      b->pos += 20; /* time code, closed_gov, broken_link */
      ++d->count[C_GOV];
    } else if (startcode == 0x1B0) {
      int pl = (int)br_get(b, 8);
      if ((pl >> 4) == 0xE) return refuse(d, M_STUDIO);
      ++d->count[C_VOS];
    } else if (startcode == 0x1B5) {
      if (br_get(b, 1)) b->pos += 7;
      int type = (int)br_get(b, 4);
      if ((type == 1 || type == 2) && br_get(b, 1))
        return refuse(d, M_SIGNAL_TYPE);
      ++d->count[C_VO];
    } else if (startcode == 0x1B6) {
      return MP4_OK;
    }
    b->pos = (b->pos + 7) & ~7L;
    startcode = 0xff;
  }
}

/* ---- prediction ---- */

/* ff_mpeg4_pred_dc: returns the block's quantised DC, stores its scaled
 * value as the next blocks' predictor */
static int pred_dc(mp4_t *d, int n, int level) {
  int scale = n < 4 ? y_dc_scale[d->m.q] : c_dc_scale[d->m.q];
  int p = n < 4 ? 0 : n - 3, wrap = d->dstride[p];
  int16_t *dc = d->dc[p] + (n < 4 ? (2 * d->m.mb_y + (n >> 1)) * wrap +
                                        2 * d->m.mb_x + (n & 1)
                                  : d->m.mb_y * wrap + d->m.mb_x);
  int a = dc[-1], bb = dc[-1 - wrap], c = dc[-wrap];
  if (d->m.mb_y == 0 && n != 3) { /* the first slice line */
    if (n != 2) bb = c = 1024;
    if (n != 1 && d->m.mb_x == 0) bb = a = 1024;
  }
  if (d->m.mb_x == 0 && d->m.mb_y == 1 && (n == 0 || n == 4 || n == 5))
    bb = 1024;
  int pred;
  if (abs(a - bb) < abs(bb - c)) {
    pred = c;
    ++d->count[C_DC_TOP];
  } else {
    pred = a;
    ++d->count[C_DC_LEFT];
  }
  pred = (pred + (scale >> 1)) / scale;
  level += pred;
  int ret = level;
  level *= scale;
  if (level & ~2047) level = level < 0 ? 0 : 2047;
  dc[0] = (int16_t)level;
  return ret;
}

/* ff_clean_intra_table_entries: an inter macroblock's DC predictors
 * (AC predictors are never read: ac_pred_flag 1 is refused) */
static void clean_intra(mp4_t *d) {
  for (int n = 0; n < 6; ++n) {
    int p = n < 4 ? 0 : n - 3, wrap = d->dstride[p];
    long at = n < 4 ? (long)(2 * d->m.mb_y + (n >> 1)) * wrap + 2 * d->m.mb_x +
                          (n & 1)
                    : (long)d->m.mb_y * wrap + d->m.mb_x;
    d->dc[p][at] = 1024;
  }
}

/* ---- blocks ---- */

static int decode_block(mp4_t *d, br_t *b, int n, int coded, int intra) {
  int16_t *blk = d->m.block[n];
  const rl_t *rl;
  const vlc_t *tc;
  int i, qmul, qadd;
  if (intra) {
    int size = vlc_get(b, n < 4 ? &d->dc_lum : &d->dc_chrom);
    if (size < 0 || size > 9) return MP4_CORRUPT;
    if (size > 8) return refuse(d, M_DC_SIZE);
    int level = 0;
    if (size)
      level = br_xbits(b, size);
    else
      ++d->count[C_DC_ZERO];
    blk[0] = (int16_t)pred_dc(d, n, level);
    i = 0;
    if (!coded) {
      ++d->count[C_INTRA_UNCODED_BLOCK];
      d->m.last_index[n] = 0;
      return MP4_OK;
    }
    rl = &d->rl_intra;
    tc = &d->intra_tc;
    qmul = 1;
    qadd = 0;
  } else {
    i = -1;
    if (!coded) {
      d->m.last_index[n] = -1;
      return MP4_OK;
    }
    ++d->count[C_INTER_CODED_BLOCK];
    rl = &d->rl_inter;
    tc = &d->v.inter_tc;
    qmul = d->m.q << 1;
    qadd = (d->m.q - 1) | 1;
  }
  for (;;) {
    int s = vlc_get(b, tc), run, level, last;
    if (s < 0) return MP4_CORRUPT;
    if (s == TC_ESCAPE) {
      uint32_t cache = br_show(b, 2);
      if (cache & 2) {
        if (cache & 1) { /* third escape: LAST, RUN, LEVEL as they are */
          b->pos += 2;
          last = (int)br_get(b, 1);
          run = (int)br_get(b, 6);
          if (!br_get(b, 1)) return MP4_CORRUPT;
          level = (int)br_get(b, 12);
          level = (level ^ 0x800) - 0x800;
          if (!br_get(b, 1)) return MP4_CORRUPT;
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
          i += run + 1 + (last ? 192 : 0);
          ++d->count[intra ? C_ESC3_INTRA : C_ESC3_INTER];
        } else { /* second escape: RUN past RMAX + 1 */
          b->pos += 2;
          int t = vlc_get(b, tc);
          if (t < 0 || t == TC_ESCAPE) return MP4_CORRUPT;
          last = t >= rl->last;
          level = rl->level[t] * qmul + qadd;
          i += rl->run[t] + 1 + (last ? 192 : 0) +
               rl->max_run[last][rl->level[t]] + 1;
          if (br_get(b, 1)) level = -level;
          ++d->count[intra ? C_ESC2_INTRA : C_ESC2_INTER];
        }
      } else { /* first escape: LEVEL past LMAX */
        b->pos += 1;
        int t = vlc_get(b, tc);
        if (t < 0 || t == TC_ESCAPE) return MP4_CORRUPT;
        last = t >= rl->last;
        i += rl->run[t] + 1 + (last ? 192 : 0);
        level = rl->level[t] * qmul + qadd +
                rl->max_level[last][rl->run[t]] * qmul;
        if (br_get(b, 1)) level = -level;
        ++d->count[intra ? C_ESC1_INTRA : C_ESC1_INTER];
      }
    } else {
      last = s >= rl->last;
      i += rl->run[s] + 1 + (last ? 192 : 0);
      level = rl->level[s] * qmul + qadd;
      if (br_get(b, 1)) level = -level;
    }
    if (i > 62) {
      i -= 192;
      if (i & ~63) return MP4_CORRUPT;
      blk[zigzag[i]] = (int16_t)level;
      break;
    }
    blk[zigzag[i]] = (int16_t)level;
  }
  d->m.last_index[n] = i;
  return MP4_OK;
}

static int intra_mb(mp4_t *d, br_t *b, int cbpc) {
  if (br_get(b, 1)) return refuse(d, M_AC_PRED);
  int cbpy = vlc_get(b, &d->v.cbpy);
  if (cbpy < 0) return MP4_CORRUPT;
  int cbp = (cbpc & 3) | (cbpy << 2);
  memset(d->m.block, 0, sizeof d->m.block);
  for (int n = 0; n < 6; ++n) {
    int rc = decode_block(d, b, n, cbp & 32, 1);
    if (rc) return rc;
    cbp += cbp;
  }
  mb_set_mv(&d->m, 0, 0);
  mb_put_intra(&d->m, y_dc_scale[d->m.q], c_dc_scale[d->m.q]);
  return MP4_OK;
}

/* mpeg4_is_resync's look at the bits after a macroblock: MB stuffing and
 * resync markers are refused (the VOP's end needs no test: FFmpeg keeps
 * the frame whatever follows its last macroblock) */
static int after_mb(mp4_t *d, br_t *b) {
  uint32_t v = br_show(b, 16);
  if (v <= 0xFF && (v >> (8 - d->pict)) == 1) return refuse(d, M_STUFFING);
  long count = b->pos;
  static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                     0x7000, 0x6000, 0x4000, 0x0000};
  if (count + 8 < b->nbits && v == prefix[count & 7]) {
    br_t t = *b;
    t.pos += 1;
    t.pos = (t.pos + 7) & ~7L;
    int len = 0;
    while (len < 32 && !br_get(&t, 1)) ++len;
    int need = d->pict == 1 ? 16 : d->m.fcode + 15;
    if (len >= need) return refuse(d, M_RESYNC);
  }
  return MP4_OK;
}

static int decode_vop(mp4_t *d, br_t *b) {
  int type = (int)br_get(b, 2);
  if (type == 2) return refuse(d, M_BVOP);
  if (type == 3) return refuse(d, M_SVOP);
  while (br_get(b, 1)) /* modulo_time_base */
    if (br_left(b) <= 0) return MP4_CORRUPT;
  b->pos += 1; /* marker */
  if (!(br_show(b, d->time_inc_bits + 1) & 1)) return MP4_CORRUPT;
  b->pos += d->time_inc_bits + 1;
  if (!br_get(b, 1)) { /* vop_coded */
    ++d->count[C_NOT_CODED_VOP];
    return MP4_SKIPPED;
  }
  d->pict = type + 1; /* 1: I, 2: P */
  d->m.rounding = 0;
  if (type == 1) d->m.rounding = (int)br_get(b, 1);
  if (br_left(b) < 3) return MP4_CORRUPT;
  if (br_get(b, 3) != 0) return refuse(d, M_DC_THRESHOLD);
  d->m.q = (int)br_get(b, 5);
  if (!d->m.q) return MP4_CORRUPT;
  d->m.fcode = 1;
  if (type == 1) {
    d->m.fcode = (int)br_get(b, 3);
    if (!d->m.fcode) return MP4_CORRUPT;
    if (!d->have_ref) return refuse(d, M_NO_REFERENCE);
  }
  int rc = check_encoder(d);
  if (rc) return rc;
  ++d->count[type ? C_PVOP : C_IVOP];
  if (type) {
    ++d->count[d->m.rounding ? C_ROUND1 : C_ROUND0];
    ++d->count[d->m.fcode > 1 ? C_FCODE2UP : C_FCODE1];
  }
  if (d->have_ref) d->m.cur ^= 1;
  d->m.ref = d->m.cur ^ 1;
  for (d->m.mb_y = 0; d->m.mb_y < d->m.mb_h; ++d->m.mb_y)
    for (d->m.mb_x = 0; d->m.mb_x < d->m.mb_w; ++d->m.mb_x) {
      if (type == 0) {
        int cbpc = vlc_get(b, &d->v.intra_mcbpc);
        if (cbpc < 0) return MP4_CORRUPT;
        if (cbpc == MCBPC_INTRA_STUFFING) return refuse(d, M_STUFFING);
        if (cbpc & 4) return refuse(d, M_DQUANT);
        rc = intra_mb(d, b, cbpc);
        if (rc) return rc;
        ++d->count[C_I_MB];
      } else if (br_get(b, 1)) { /* not coded */
        ++d->count[C_P_SKIP_MB];
        mb_set_mv(&d->m, 0, 0);
        clean_intra(d);
        memset(d->m.last_index, 0xff, sizeof d->m.last_index);
        mb_motion(&d->m, 0, 0);
      } else {
        int cbpc = vlc_get(b, &d->v.inter_mcbpc);
        if (cbpc < 0) return MP4_CORRUPT;
        if (cbpc == MCBPC_INTER_STUFFING) return refuse(d, M_STUFFING);
        if (cbpc & 8) return refuse(d, M_DQUANT);
        if (cbpc & 16) return refuse(d, M_4MV);
        if (cbpc & 4) {
          rc = intra_mb(d, b, cbpc);
          if (rc) return rc;
          ++d->count[C_P_INTRA_MB];
        } else {
          int cbpy = vlc_get(b, &d->v.cbpy);
          if (cbpy < 0) return MP4_CORRUPT;
          int cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2), px, py, mx, my;
          mb_pred_motion(&d->m, &px, &py);
          rc = mb_decode_motion(&d->m, b, &d->v.mvd, px, &mx);
          if (!rc) rc = mb_decode_motion(&d->m, b, &d->v.mvd, py, &my);
          if (rc) return rc;
          memset(d->m.block, 0, sizeof d->m.block);
          for (int n = 0; n < 6; ++n) {
            rc = decode_block(d, b, n, cbp & 32, 0);
            if (rc) return rc;
            cbp += cbp;
          }
          mb_set_mv(&d->m, mx, my);
          clean_intra(d);
          mb_motion(&d->m, mx, my);
          mb_add_inter(&d->m);
          ++d->count[C_P_INTER_MB];
        }
      }
      rc = after_mb(d, b);
      if (rc) return rc;
    }
  d->have_ref = 1;
  return MP4_OK;
}

/* ---- API ---- */

/* A decoder for a stream whose container gave `tag` (1: a fourcc FFmpeg
 * takes for Xvid, 2: DIVX, else 0) and extradata (a VOL and user data, or
 * none).  *rc is MP4_OK, or what the extradata's headers refused. */
void *fl_mpeg4_open(const uint8_t *extradata, long n, int tag, int *rc) {
  mp4_t *d = (mp4_t *)calloc(1, sizeof(mp4_t));
  *rc = MP4_NOMEM;
  if (!d) return NULL;
  mb_vlcs_build(&d->v);
  vlc_build(&d->intra_tc, 12, 103, intra_code, intra_len);
  vlc_build(&d->dc_lum, 11, 13, dc_lum_code, dc_lum_len);
  vlc_build(&d->dc_chrom, 12, 13, dc_chrom_code, dc_chrom_len);
  rl_init(&d->rl_intra, intra_code, intra_len, intra_run, intra_level, 67);
  rl_init(&d->rl_inter, inter_code, inter_len, inter_run, inter_level,
          TC_INTER_LAST);
  d->m.paths = d->count + C_MV_ZERO_CODE;
  d->tag = tag;
  d->lavc_build = d->xvid_build = d->divx_version = -1;
  *rc = MP4_OK;
  if (n > 0) {
    uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
    if (!buf) {
      *rc = MP4_NOMEM;
      return d;
    }
    memcpy(buf, extradata, (size_t)n);
    br_t b = {buf, n * 8, 0};
    int r = decode_headers(d, &b, 1);
    free(buf);
    /* FFmpeg parses the extradata up to a VOP and ignores its errors */
    if (r >= MP4_REFUSED || r == MP4_NOMEM) *rc = r;
  }
  return d;
}

/* Decode one packet.  MP4_OK: a frame (fl_mpeg4_bgr converts it), its
 * size in wh[0..1]; MP4_SKIPPED: a VOP not coded; MP4_CORRUPT;
 * MP4_REFUSED + the tool's M_*. */
int fl_mpeg4_decode(void *h, const uint8_t *data, long n, int *wh) {
  mp4_t *d = (mp4_t *)h;
  if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
    return refuse(d, M_SHORT_HEADER);
  uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
  if (!buf) return MP4_NOMEM;
  memcpy(buf, data, (size_t)n);
  br_t b = {buf, n * 8, 0};
  int rc = decode_headers(d, &b, 0);
  if (rc == MP4_SKIPPED) rc = MP4_CORRUPT; /* no VOP in the packet */
  if (!rc && !d->have_vol) rc = MP4_CORRUPT;
  if (!rc) rc = decode_vop(d, &b);
  free(buf);
  if (rc) return rc;
  wh[0] = d->m.width;
  wh[1] = d->m.height;
  return MP4_OK;
}

/* The last frame as BGR (H, W, 3). */
int fl_mpeg4_bgr(void *h, uint8_t *out) {
  mp4_t *d = (mp4_t *)h;
  const mb_t *m = &d->m;
  yuv_planes_t p = {m->pic[m->cur][0], m->pic[m->cur][1], m->pic[m->cur][2],
                    m->ys, m->cs};
  return yuv_to_bgr(&p, d->m.width, d->m.height, 1, 1, 0, out);
}

/* The last frame's planes, cropped: y (H x W), u and v (ceil(H/2) x
 * ceil(W/2)), each packed. */
void fl_mpeg4_planes(void *h, uint8_t *y, uint8_t *u, uint8_t *v) {
  mb_planes(&((mp4_t *)h)->m, y, u, v);
}

/* The syntax path counters (C_NPATHS of them) and the last refusal. */
int fl_mpeg4_counts(void *h, uint64_t *out) {
  mp4_t *d = (mp4_t *)h;
  memcpy(out, d->count, sizeof d->count);
  return d->refused;
}

void fl_mpeg4_close(void *h) {
  mp4_t *d = (mp4_t *)h;
  if (!d) return;
  free_pictures(d);
  free(d);
}
