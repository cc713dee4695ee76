/* MPEG-2 video (ISO/IEC 13818-2, ITU-T H.262) for io/mpeg2.py: what
 * cv2.VideoCapture returns for the streams cv2.VideoWriter writes with the
 * fourccs MPG2, MPEG and mpg2, bit for bit.  cv2 decodes them with
 * FFmpeg's mpeg2video decoder (libavcodec 62.28 in cv2 5.0.0) and converts
 * its yuv420p planes to BGR24 with swscale (yuv_bgr.h).  What that writer
 * produces is FFmpeg's own mpeg2video encoder at cv2's settings: main
 * profile, progressive 4:2:0 frame pictures, I, P and B pictures (two B
 * pictures between anchors, a GOP of 12, closed at the start and open
 * after), default matrices, linear quantiser scale, table B-14, zigzag
 * scan, one slice per macroblock row, even sizes.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.  A decoder
 * keeps the sequence, the two anchor pictures and the output order across
 * packets.
 *
 * The stages and the FFmpeg functions (mpeg12dec.c, mpegvideo*.c) they
 * follow:
 *   packets      mpeg_decode_frame / decode_chunks: start codes in order;
 *                the sequence header (matrices in zigzag order, reset to
 *                the defaults by each header that loads none), sequence
 *                extension and display extension, quant matrix
 *                extension, GOP header (closed_gop; broken_link changes
 *                nothing), user data, picture header and picture coding
 *                extension, then the slices; an empty packet, or one that
 *                is a sequence end code alone, drains the last anchor
 *   slices       mpeg_decode_slice: quantiser_scale_code, extra slice
 *                information, macroblock address increments with escapes,
 *                the DC predictors (128) and motion vector predictors reset
 *                at each slice; a slice may run past its row as FFmpeg's
 *                does; skipped macroblocks: in a P picture a forward copy
 *                at vector 0 (the predictors reset), in a B picture the
 *                previous macroblock's directions and vectors
 *   macroblocks  mpeg_decode_mb: macroblock types of tables B-2 to B-4,
 *                the quantiser (code << 1), frame motion vectors
 *                (mpeg_decode_motion: f_code 1 to 9, modulo the range),
 *                the coded block pattern (table B-9)
 *   blocks       mpeg2_decode_block_intra / _non_intra: the DC size VLCs
 *                (tables B-12, B-13), table B-14 with its escape (6-bit
 *                run, 12-bit level), zigzag scan, dequantisation
 *                ((2 level + 1) q m >> 5 for inter, level q m >> 4 for
 *                intra AC), no saturation (FFmpeg stores the int16 of the
 *                product), mismatch control on coefficient 63
 *   IDCT         ff_simple_idct_put / _add_int16_8bit (simple_idct.h):
 *                put for every block of an intra macroblock, add for each
 *                coded block of the others
 *   motion       mpeg_motion for 16x16 frame vectors: luma at half-pel,
 *                chroma at half the vector rounded to zero; the first
 *                direction put, the second averaged into it (hpeldsp's
 *                rounding forms, (a + b + 1) >> 1 and (a + b + c + d + 2)
 *                >> 2); a vector reaching outside the macroblock-aligned
 *                picture makes FFmpeg skip that prediction (refused)
 *   order        ff_mpv_frame_start / slice_end: an I or P picture leaves
 *                one anchor late, a B picture at once, the last anchor at
 *                the drain; a B picture without a forward reference is
 *                dropped after an open GOP and predicted from a grey
 *                picture (128) after a closed one
 *   output       the picture cropped to the sequence's size, yuv420p at
 *                limited range to BGR24 through yuv_bgr.h
 *
 * A tool no stream of that writer holds is refused with its name's code
 * (M2_REFUSED + R_*).  A packet the decoder cannot read, or a picture
 * whose slices leave macroblocks out (FFmpeg conceals them), returns
 * M2_CORRUPT.  Every syntax path that is decoded bumps a counter (C_*),
 * so a test holds the committed clips to covering all of them.
 */
#include "simple_idct.h"
#include "yuv_bgr.h"

#include <string.h>

enum { M2_OK = 0, M2_NONE = 1, M2_CORRUPT = -1, M2_NOMEM = -2,
       M2_REFUSED = 100 };

/* tools refused, by name in io/mpeg2.py */
enum {
  R_FIELD_PICTURE = 1, R_INTERLACED, R_FIELD_MOTION, R_CHROMA_422,
  R_CHROMA_444, R_DC_PRECISION, R_Q_SCALE_TYPE, R_INTRA_VLC,
  R_ALTERNATE_SCAN, R_CONCEALMENT, R_SCALABLE, R_D_PICTURE, R_MPEG1,
  R_RESIZE, R_ODD_HEIGHT, R_MATRIX, R_TMPGEXS, R_MV_OUTSIDE,
  R_TWO_PICTURES, R_NO_REFERENCE, R_NO_CODING_EXT, R_NO_PICTURE
};

/* syntax paths counted */
enum {
  C_SEQ, C_SEQ_EXTRADATA, C_SEQ_EXT, C_DISPLAY_EXT, C_MATRIX_LOADED,
  C_QUANT_MATRIX_EXT, C_OTHER_EXT, C_GOP_CLOSED, C_GOP_OPEN, C_BROKEN_LINK,
  C_USER_DATA, C_SEQ_END, C_I_PIC, C_P_PIC, C_B_PIC, C_B_DROPPED,
  C_GREY_FORWARD, C_DRAIN, C_LOW_DELAY, C_SLICE, C_SLICE_EXTRA,
  C_MB_ESCAPE, C_I_MB, C_I_MB_QUANT, C_P_INTRA, C_P_FORWARD,
  C_P_FORWARD_NOT_CODED, C_P_ZERO_MV, C_P_QUANT, C_P_SKIP, C_B_INTRA,
  C_B_FORWARD, C_B_BACKWARD, C_B_BIDIR, C_B_NOT_CODED, C_B_QUANT, C_B_SKIP,
  C_DC_ZERO, C_DC_CODED, C_ESCAPE_INTRA, C_ESCAPE_INTER, C_EOB_AT_ONCE,
  C_FIRST_ONE, C_MISMATCH, C_Q_FINE, C_Q_COARSE, C_FCODE1, C_FCODE2UP,
  C_MV_ZERO_CODE, C_MV_CODED, C_MC_FULL, C_MC_X, C_MC_Y, C_MC_XY,
  C_MC_AVG, C_NPATHS
};

/* picture types and macroblock type flags (FFmpeg's MB_TYPE_* in part) */
enum { PT_I = 1, PT_P = 2, PT_B = 3 };
enum {
  MB_INTRA = 1, MB_FORWARD = 2, MB_BACKWARD = 4, MB_CBP = 8, MB_QUANT = 16,
  MB_ZERO_MV = 32, MB_SKIP = 64
};
#define NONE (-1)
#define GREY 3 /* the picture slot of the grey forward reference */

/* ---- tables ---- */

/* Table B-14 (dct_coef_next without the sign bit), in FFmpeg's order
 * (ff_mpeg1_vlc_table: by run, then level); 111 is the escape, 112 the
 * end of block */
static const uint16_t coef_code[113] = {
    0x3, 0x4, 0x5, 0x6, 0x26, 0x21, 0xa, 0x1d, 0x18, 0x13, 0x10, 0x1a,
    0x19, 0x18, 0x17, 0x1f, 0x1e, 0x1d, 0x1c, 0x1b, 0x1a, 0x19, 0x18, 0x17,
    0x16, 0x15, 0x14, 0x13, 0x12, 0x11, 0x10, 0x18, 0x17, 0x16, 0x15, 0x14,
    0x13, 0x12, 0x11, 0x10, 0x3, 0x6, 0x25, 0xc, 0x1b, 0x16, 0x15, 0x1f,
    0x1e, 0x1d, 0x1c, 0x1b, 0x1a, 0x19, 0x13, 0x12, 0x11, 0x10, 0x5, 0x4,
    0xb, 0x14, 0x14, 0x7, 0x24, 0x1c, 0x13, 0x6, 0xf, 0x12, 0x7, 0x9,
    0x12, 0x5, 0x1e, 0x14, 0x4, 0x15, 0x7, 0x11, 0x5, 0x11, 0x27, 0x10,
    0x23, 0x1a, 0x22, 0x19, 0x20, 0x18, 0xe, 0x17, 0xd, 0x16, 0x8, 0x15,
    0x1f, 0x1a, 0x19, 0x17, 0x16, 0x1f, 0x1e, 0x1d, 0x1c, 0x1b, 0x1f, 0x1e,
    0x1d, 0x1c, 0x1b, 0x1, 0x2};
static const uint8_t coef_len[113] = {
    2, 4, 5, 7, 8, 8, 10, 12, 12, 12, 12, 13, 13, 13, 13, 14, 14, 14, 14,
    14, 14, 14, 14, 14, 14, 14, 14, 14, 14, 14, 14, 15, 15, 15, 15, 15, 15,
    15, 15, 15, 3, 6, 8, 10, 12, 13, 13, 15, 15, 15, 15, 15, 15, 15, 16, 16,
    16, 16, 4, 7, 10, 12, 13, 5, 8, 12, 13, 5, 10, 12, 6, 10, 13, 6, 12, 16,
    6, 12, 7, 12, 7, 13, 8, 13, 8, 16, 8, 16, 8, 16, 10, 16, 10, 16, 10, 16,
    12, 12, 12, 12, 12, 13, 13, 13, 13, 13, 16, 16, 16, 16, 16, 6, 2};
/* the runs of the 111 codes: run 0 for levels 1-40, run 1 for 1-18, then
 * runs 2-6 for 5, 4, 3, 3, 3 levels, runs 7-16 for 2 and runs 17-31 for
 * one */
static uint8_t coef_run[111], coef_level[111];

static void coef_tables(void) {
  static const uint8_t levels[32] = {40, 18, 5, 4, 3, 3, 3, 2, 2, 2, 2,
                                     2,  2,  2, 2, 2, 2, 1, 1, 1, 1, 1,
                                     1,  1,  1, 1, 1, 1, 1, 1, 1, 1};
  int k = 0;
  for (int run = 0; run < 32; ++run)
    for (int level = 1; level <= levels[run]; ++level) {
      coef_run[k] = (uint8_t)run;
      coef_level[k++] = (uint8_t)level;
    }
}

/* Table B-1 (macroblock_address_increment): symbol s is an increment of
 * s + 1; 33 is the escape, 34 stuffing, 35 the eight zeros that start a
 * slice's end */
static const uint16_t incr_code[36] = {
    0x1, 0x3, 0x2, 0x3, 0x2, 0x3, 0x2, 0x7, 0x6, 0xb, 0xa, 0x9,
    0x8, 0x7, 0x6, 0x17, 0x16, 0x15, 0x14, 0x13, 0x12, 0x23, 0x22, 0x21,
    0x20, 0x1f, 0x1e, 0x1d, 0x1c, 0x1b, 0x1a, 0x19, 0x18, 0x8, 0xf, 0x0};
static const uint8_t incr_len[36] = {
    1, 3, 3, 4, 4, 5, 5, 7, 7, 8, 8, 8, 8, 8, 8, 10, 10, 10,
    10, 10, 10, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 11, 8};
/* Tables B-3 and B-4 (macroblock_type in P and B pictures) */
static const uint16_t ptype_code[7] = {3, 1, 1, 1, 1, 1, 2};
static const uint8_t ptype_len[7] = {5, 2, 3, 1, 6, 5, 5};
static const uint8_t ptype_flags[7] = {
    MB_INTRA, MB_FORWARD | MB_CBP | MB_ZERO_MV, MB_FORWARD,
    MB_FORWARD | MB_CBP, MB_QUANT | MB_INTRA,
    MB_QUANT | MB_FORWARD | MB_CBP | MB_ZERO_MV,
    MB_QUANT | MB_FORWARD | MB_CBP};
static const uint16_t btype_code[11] = {3, 2, 3, 2, 3, 2, 3, 1, 2, 3, 2};
static const uint8_t btype_len[11] = {5, 3, 3, 4, 4, 2, 2, 6, 6, 6, 5};
static const uint8_t btype_flags[11] = {
    MB_INTRA, MB_BACKWARD, MB_BACKWARD | MB_CBP, MB_FORWARD,
    MB_FORWARD | MB_CBP, MB_FORWARD | MB_BACKWARD,
    MB_FORWARD | MB_BACKWARD | MB_CBP, MB_QUANT | MB_INTRA,
    MB_QUANT | MB_BACKWARD | MB_CBP, MB_QUANT | MB_FORWARD | MB_CBP,
    MB_QUANT | MB_FORWARD | MB_BACKWARD | MB_CBP};
/* Table B-9 (coded_block_pattern_420): symbol is the pattern */
static const uint16_t cbp_code[64] = {
    0x1, 0xb, 0x9, 0xd, 0xd, 0x17, 0x13, 0x1f, 0xc, 0x16, 0x12, 0x1e,
    0x13, 0x1b, 0x17, 0x13, 0xb, 0x15, 0x11, 0x1d, 0x11, 0x19, 0x15, 0x11,
    0xf, 0xf, 0xd, 0x3, 0xf, 0xb, 0x7, 0x7, 0xa, 0x14, 0x10, 0x1c,
    0xe, 0xe, 0xc, 0x2, 0x10, 0x18, 0x14, 0x10, 0xe, 0xa, 0x6, 0x6,
    0x12, 0x1a, 0x16, 0x12, 0xd, 0x9, 0x5, 0x5, 0xc, 0x8, 0x4, 0x4,
    0x7, 0xa, 0x8, 0xc};
static const uint8_t cbp_len[64] = {
    9, 5, 5, 6, 4, 7, 7, 8, 4, 7, 7, 8, 5, 8, 8, 8, 4, 7, 7, 8, 5, 8,
    8, 8, 6, 8, 8, 9, 5, 8, 8, 9, 4, 7, 7, 8, 6, 8, 8, 9, 5, 8, 8, 8,
    5, 8, 8, 9, 5, 8, 8, 8, 5, 8, 8, 9, 5, 8, 8, 9, 3, 5, 5, 6};
/* Table B-10 (motion_code without the sign) */
static const uint16_t mv_code[17] = {1, 1, 1, 1, 3, 5, 4, 3, 11,
                                     10, 9, 17, 16, 15, 14, 13, 12};
static const uint8_t mv_len[17] = {1, 2, 3, 4, 6, 7, 7, 7, 9,
                                   9, 9, 10, 10, 10, 10, 10, 10};
/* Tables B-12 and B-13 (dct_dc_size_luminance / _chrominance) */
static const uint16_t dc_lum_code[12] = {0x4, 0x0, 0x1, 0x5, 0x6, 0xe,
                                         0x1e, 0x3e, 0x7e, 0xfe, 0x1fe,
                                         0x1ff};
static const uint8_t dc_lum_len[12] = {3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 9};
static const uint16_t dc_chroma_code[12] = {0x0, 0x1, 0x2, 0x6, 0xe,
                                            0x1e, 0x3e, 0x7e, 0xfe,
                                            0x1fe, 0x3fe, 0x3ff};
static const uint8_t dc_chroma_len[12] = {2, 2, 2, 3, 4, 5,
                                          6, 7, 8, 9, 10, 10};

static const uint8_t zigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
/* the default intra matrix (ff_mpeg1_default_intra_matrix, raster order);
 * the default non-intra matrix is 16 everywhere */
static const uint8_t default_intra[64] = {
    8, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83};

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

/* bits left before the data's end (negative past it: the reader then
 * gives zeros, as FFmpeg's padded buffers do) */
static inline long br_left(const br_t *b) { return b->nbits - b->pos; }

/* ---- VLCs: one lookup of `bits` bits ---- */

typedef struct {
  int bits;
  int16_t *sym;
  uint8_t *len;
} vlc_t;

static int vlc_build(vlc_t *v, int bits, int n, const uint16_t *code,
                     const uint8_t *len) {
  v->bits = bits;
  v->sym = (int16_t *)malloc(sizeof(int16_t) << bits);
  v->len = (uint8_t *)malloc((size_t)1 << bits);
  if (!v->sym || !v->len) return M2_NOMEM;
  for (int i = 0; i < (1 << bits); ++i) v->sym[i] = -1;
  for (int s = 0; s < n; ++s) {
    int shift = bits - len[s];
    for (int k = 0; k < (1 << shift); ++k) {
      v->sym[(code[s] << shift) | k] = (int16_t)s;
      v->len[(code[s] << shift) | k] = len[s];
    }
  }
  return M2_OK;
}

static void vlc_free(vlc_t *v) {
  free(v->sym);
  free(v->len);
}

static inline int vlc_get(br_t *b, const vlc_t *v) {
  uint32_t idx = br_show(b, v->bits);
  int s = v->sym[idx];
  if (s >= 0) b->pos += v->len[idx];
  return s;
}

/* ---- decoder ---- */

typedef struct {
  vlc_t coef, incr, ptype, btype, cbp, mvd, dc_lum, dc_chroma;
  /* sequence */
  int width, height, aspect, pan_w, pan_h, progressive_seq, low_delay;
  int mpeg1;       /* the last sequence header had no extension yet */
  int have_size;   /* pictures allocated for `key` */
  int key[5];      /* what FFmpeg reinitialises on: size and aspect */
  int pic_w, pic_h; /* the size the pictures were made for (key's) */
  int mb_w, mb_h, ys, cs;
  uint16_t intra_m[64], inter_m[64], chroma_intra_m[64], chroma_inter_m[64];
  int closed_gop;
  /* pictures: slots 0-2, GREY the forward reference FFmpeg makes up */
  uint8_t *pic[4][3];
  int last, next, cur, out;
  uint8_t *mb_type;    /* each macroblock's flags in the current picture */
  uint8_t *mb_done;
  /* the picture */
  int pict_type, coding_ext, f_code[2][2], first_slice;
  int qscale, last_dc[3], last_mv[2][2], mv[2][2], mv_dir;
  int mb_x, mb_y, skip_run;
  int16_t block[6][64];
  int last_index[6];
  uint64_t count[C_NPATHS];
  int refused; /* the R_* of the last refusal */
} m2_t;

static int refuse(m2_t *d, int tool) {
  d->refused = tool;
  return M2_REFUSED + tool;
}

static void free_pictures(m2_t *d) {
  for (int k = 0; k < 4; ++k)
    for (int p = 0; p < 3; ++p) {
      free(d->pic[k][p]);
      d->pic[k][p] = NULL;
    }
  free(d->mb_type);
  free(d->mb_done);
  d->mb_type = d->mb_done = NULL;
}

/* mpeg_decode_postinit at a picture: the picture slots for the
 * sequence's size; a later sequence that changes what FFmpeg
 * reinitialises on (dropping its references) is refused */
static int postinit(m2_t *d) {
  int key[5] = {d->width, d->height, d->aspect, d->pan_w, d->pan_h};
  if (d->have_size) {
    if (memcmp(key, d->key, sizeof key)) return refuse(d, R_RESIZE);
    return M2_OK;
  }
  if (!d->width || !d->height) return M2_CORRUPT;
  /* cv2 hands swscale MPEG-2's left chroma siting, which changes the
   * scaler path an odd height takes; cv2.VideoWriter writes even sizes */
  if (d->height & 1) return refuse(d, R_ODD_HEIGHT);
  memcpy(d->key, key, sizeof key);
  d->pic_w = d->width;
  d->pic_h = d->height;
  d->mb_w = (d->width + 15) / 16;
  d->mb_h = (d->height + 15) / 16;
  d->ys = d->mb_w * 16;
  d->cs = d->mb_w * 8;
  for (int k = 0; k < 3; ++k)
    for (int p = 0; p < 3; ++p) {
      long n = p ? (long)d->cs * d->mb_h * 8 : (long)d->ys * d->mb_h * 16;
      d->pic[k][p] = (uint8_t *)calloc((size_t)n, 1);
      if (!d->pic[k][p]) return M2_NOMEM;
    }
  d->mb_type = (uint8_t *)calloc((size_t)d->mb_w * d->mb_h, 1);
  d->mb_done = (uint8_t *)calloc((size_t)d->mb_w * d->mb_h, 1);
  if (!d->mb_type || !d->mb_done) return M2_NOMEM;
  d->have_size = 1;
  return M2_OK;
}

/* ---- headers ---- */

/* load_matrix: 64 values in zigzag order into `m0` (and `m1`); an intra
 * matrix's first value is taken as 8 */
static int load_matrix(br_t *b, uint16_t *m0, uint16_t *m1, int intra) {
  for (int i = 0; i < 64; ++i) {
    int v = (int)br_get(b, 8);
    if (!v) return M2_CORRUPT;
    if (intra && i == 0) v = 8;
    m0[zigzag[i]] = (uint16_t)v;
    if (m1) m1[zigzag[i]] = (uint16_t)v;
  }
  return M2_OK;
}

/* mpeg1_decode_sequence */
static int decode_sequence(m2_t *d, br_t *b) {
  int w = (int)br_get(b, 12), h = (int)br_get(b, 12);
  int aspect = (int)br_get(b, 4);
  b->pos += 4 + 18; /* frame_rate_code, bit_rate_value */
  if (!br_get(b, 1)) return M2_CORRUPT;
  b->pos += 10 + 1; /* vbv_buffer_size_value, constrained_parameters */
  if (br_get(b, 1)) {
    if (load_matrix(b, d->chroma_intra_m, d->intra_m, 1)) return M2_CORRUPT;
    ++d->count[C_MATRIX_LOADED];
  } else {
    for (int i = 0; i < 64; ++i)
      d->intra_m[i] = d->chroma_intra_m[i] = default_intra[i];
  }
  if (br_get(b, 1)) {
    if (load_matrix(b, d->chroma_inter_m, d->inter_m, 0)) return M2_CORRUPT;
    ++d->count[C_MATRIX_LOADED];
  } else {
    for (int i = 0; i < 64; ++i) d->inter_m[i] = d->chroma_inter_m[i] = 16;
  }
  if (br_show(b, 23)) return M2_CORRUPT;
  d->width = w;
  d->height = h;
  d->aspect = aspect;
  d->progressive_seq = 1;
  d->mpeg1 = 1;
  ++d->count[C_SEQ];
  return M2_OK;
}

/* mpeg_decode_sequence_extension */
static int decode_sequence_extension(m2_t *d, br_t *b) {
  b->pos += 8; /* profile_and_level_indication */
  d->progressive_seq = (int)br_get(b, 1);
  int chroma = (int)br_get(b, 2);
  if (!d->progressive_seq) return refuse(d, R_INTERLACED);
  if (chroma == 2) return refuse(d, R_CHROMA_422);
  if (chroma == 3) return refuse(d, R_CHROMA_444);
  d->width |= (int)br_get(b, 2) << 12;
  d->height |= (int)br_get(b, 2) << 12;
  b->pos += 12 + 1 + 8; /* bit_rate_extension, marker, vbv extension */
  d->low_delay = (int)br_get(b, 1);
  if (d->low_delay) ++d->count[C_LOW_DELAY];
  d->mpeg1 = 0;
  ++d->count[C_SEQ_EXT];
  return M2_OK;
}

/* mpeg_decode_sequence_display_extension: only the colour matrix can
 * change the frames (cv2 converts with the frame's matrix; 2, 5 and 6
 * are BT.601's coefficients, the ones every other frame gets) */
static int decode_display_extension(m2_t *d, br_t *b) {
  b->pos += 3; /* video_format */
  if (br_get(b, 1)) {
    b->pos += 16; /* colour_primaries, transfer_characteristics */
    int matrix = (int)br_get(b, 8);
    if (matrix != 2 && matrix != 5 && matrix != 6)
      return refuse(d, R_MATRIX);
  }
  d->pan_w = (int)br_get(b, 14);
  b->pos += 1;
  d->pan_h = (int)br_get(b, 14);
  ++d->count[C_DISPLAY_EXT];
  return M2_OK;
}

/* mpeg_decode_quant_matrix_extension */
static int decode_quant_matrix_extension(m2_t *d, br_t *b) {
  if (br_get(b, 1) && load_matrix(b, d->chroma_intra_m, d->intra_m, 1))
    return M2_CORRUPT;
  if (br_get(b, 1) && load_matrix(b, d->chroma_inter_m, d->inter_m, 0))
    return M2_CORRUPT;
  if (br_get(b, 1) && load_matrix(b, d->chroma_intra_m, NULL, 1))
    return M2_CORRUPT;
  if (br_get(b, 1) && load_matrix(b, d->chroma_inter_m, NULL, 0))
    return M2_CORRUPT;
  ++d->count[C_QUANT_MATRIX_EXT];
  return M2_OK;
}

/* mpeg1_decode_picture */
static int decode_picture_header(m2_t *d, br_t *b) {
  b->pos += 10; /* temporal_reference */
  int type = (int)br_get(b, 3);
  if (type == 4) return refuse(d, R_D_PICTURE);
  if (type < PT_I || type > PT_B) return M2_CORRUPT;
  d->pict_type = type;
  d->coding_ext = 0;
  return M2_OK;
}

/* mpeg_decode_picture_coding_extension */
static int decode_picture_coding_extension(m2_t *d, br_t *b) {
  for (int i = 0; i < 2; ++i)
    for (int k = 0; k < 2; ++k) {
      int f = (int)br_get(b, 4);
      d->f_code[i][k] = f + !f;
    }
  int dc_precision = (int)br_get(b, 2);
  int structure = (int)br_get(b, 2);
  b->pos += 1; /* top_field_first */
  int frame_pred_frame_dct = (int)br_get(b, 1);
  int concealment = (int)br_get(b, 1);
  int q_scale_type = (int)br_get(b, 1);
  int intra_vlc = (int)br_get(b, 1);
  int alternate = (int)br_get(b, 1);
  /* repeat_first_field, chroma_420_type and progressive_frame change no
   * pixel of a progressive sequence's frame picture (FFmpeg takes an
   * interlaced frame there as progressive); the composite display fields
   * are not read */
  if (structure != 3 && structure != 0) return refuse(d, R_FIELD_PICTURE);
  if (!frame_pred_frame_dct) return refuse(d, R_FIELD_MOTION);
  if (dc_precision) return refuse(d, R_DC_PRECISION);
  if (q_scale_type) return refuse(d, R_Q_SCALE_TYPE);
  if (intra_vlc) return refuse(d, R_INTRA_VLC);
  if (alternate) return refuse(d, R_ALTERNATE_SCAN);
  if (concealment) return refuse(d, R_CONCEALMENT);
  d->coding_ext = 1;
  return M2_OK;
}

/* mpeg_decode_user_data: the one string that changes FFmpeg's decoding
 * ("\0TMPGEXS\0" in the first 29 bytes of more than 29) */
static int decode_user_data(m2_t *d, const uint8_t *p, long n) {
  if (n > 29)
    for (int i = 0; i < 20; ++i)
      if (!memcmp(p + i, "\0TMPGEXS\0", 9)) return refuse(d, R_TMPGEXS);
  ++d->count[C_USER_DATA];
  return M2_OK;
}

/* ---- blocks ---- */

static int decode_dc(m2_t *d, br_t *b, int component, int *diff) {
  int size = vlc_get(b, component ? &d->dc_chroma : &d->dc_lum);
  if (size < 0) return M2_CORRUPT;
  if (size) {
    *diff = br_xbits(b, size);
    ++d->count[C_DC_CODED];
  } else {
    *diff = 0;
    ++d->count[C_DC_ZERO];
  }
  return M2_OK;
}

/* one run / level of table B-14 past the first coefficient: *i moves to
 * the coefficient's scan position, *level is its dequantised value; 1 at
 * the end of block */
static int read_coef(m2_t *d, br_t *b, int intra, int *level,
                     const uint16_t *m, int *i) {
  int s = vlc_get(b, &d->coef);
  if (s < 0) return M2_CORRUPT;
  if (s == 112) return 1;
  int j;
  if (s == 111) { /* escape: 6-bit run, 12-bit signed level */
    *i += (int)br_get(b, 6) + 1;
    int lv = (int)br_get(b, 12);
    lv = (lv ^ 0x800) - 0x800;
    if (*i > 63) return M2_CORRUPT;
    j = zigzag[*i];
    int a = lv < 0 ? -lv : lv;
    a = intra ? (a * d->qscale * m[j]) >> 4
              : ((a * 2 + 1) * d->qscale * m[j]) >> 5;
    *level = lv < 0 ? -a : a;
    ++d->count[intra ? C_ESCAPE_INTRA : C_ESCAPE_INTER];
  } else {
    *i += coef_run[s] + 1;
    if (*i > 63) return M2_CORRUPT;
    j = zigzag[*i];
    int a = coef_level[s];
    a = intra ? (a * d->qscale * m[j]) >> 4
              : ((a * 2 + 1) * d->qscale * m[j]) >> 5;
    *level = br_get(b, 1) ? -a : a;
  }
  return M2_OK;
}

/* mpeg2_decode_block_intra */
static int decode_block_intra(m2_t *d, br_t *b, int n) {
  int16_t *blk = d->block[n];
  int component = n < 4 ? 0 : (n & 1) + 1, diff;
  const uint16_t *m = n < 4 ? d->intra_m : d->chroma_intra_m;
  int rc = decode_dc(d, b, component, &diff);
  if (rc) return rc;
  d->last_dc[component] += diff;
  blk[0] = (int16_t)(uint16_t)((unsigned)d->last_dc[component] << 3);
  int mismatch = blk[0] ^ 1, i = 0, level;
  for (;;) {
    rc = read_coef(d, b, 1, &level, m, &i);
    if (rc == 1) break;
    if (rc) return rc;
    mismatch ^= level;
    blk[zigzag[i]] = (int16_t)level;
  }
  if (i == 0) ++d->count[C_EOB_AT_ONCE];
  if (mismatch & 1) ++d->count[C_MISMATCH];
  blk[63] ^= (int16_t)(mismatch & 1);
  d->last_index[n] = i;
  return M2_OK;
}

/* mpeg2_decode_block_non_intra: the first coefficient may be "1s" */
static int decode_block_inter(m2_t *d, br_t *b, int n) {
  int16_t *blk = d->block[n];
  const uint16_t *m = n < 4 ? d->inter_m : d->chroma_inter_m;
  int mismatch = 1, i = -1, level, rc;
  if (br_show(b, 1)) {
    level = (3 * d->qscale * m[0]) >> 5;
    if (br_show(b, 2) & 1) level = -level;
    b->pos += 2;
    blk[0] = (int16_t)level;
    mismatch ^= level;
    i = 0;
    ++d->count[C_FIRST_ONE];
    if (br_show(b, 2) == 2) goto end;
  }
  for (;;) {
    rc = read_coef(d, b, 0, &level, m, &i);
    if (rc) return rc < 0 ? rc : M2_CORRUPT; /* no end of block here */
    mismatch ^= level;
    blk[zigzag[i]] = (int16_t)level;
    if (br_show(b, 2) == 2) break;
  }
end:
  b->pos += 2; /* the end of block */
  if (mismatch & 1) ++d->count[C_MISMATCH];
  blk[63] ^= (int16_t)(mismatch & 1);
  d->last_index[n] = i;
  return M2_OK;
}

/* ---- motion ---- */

/* mpeg_decode_motion */
static int decode_motion(m2_t *d, br_t *b, int fcode, int pred, int *out) {
  int code = vlc_get(b, &d->mvd);
  if (code < 0) return M2_CORRUPT;
  if (code == 0) {
    ++d->count[C_MV_ZERO_CODE];
    *out = pred;
    return M2_OK;
  }
  ++d->count[C_MV_CODED];
  int sign = (int)br_get(b, 1), shift = fcode - 1, val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= (int)br_get(b, shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + shift;
  *out = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  return M2_OK;
}

/* one block of w x w from `ref` (stride rs) at (sx, sy) with the
 * half-pel case dxy, put or averaged into dst */
static void mc_block(const uint8_t *ref, long rs, int sx, int sy, int dxy,
                     int w, int avg, uint8_t *dst, long ds) {
  const uint8_t *s0 = ref + (long)sy * rs + sx;
  for (int y = 0; y < w; ++y) {
    const uint8_t *s = s0 + (long)y * rs;
    uint8_t *o = dst + (long)y * ds;
    for (int x = 0; x < w; ++x) {
      int v;
      switch (dxy) {
        case 0:
          v = s[x];
          break;
        case 1:
          v = (s[x] + s[x + 1] + 1) >> 1;
          break;
        case 2:
          v = (s[x] + s[x + rs] + 1) >> 1;
          break;
        default:
          v = (s[x] + s[x + 1] + s[x + rs] + s[x + rs + 1] + 2) >> 2;
      }
      o[x] = (uint8_t)(avg ? (o[x] + v + 1) >> 1 : v);
    }
  }
}

/* mpeg_motion for one 16x16 frame vector from picture slot `ref` */
static int motion(m2_t *d, int ref, int mx, int my, int avg) {
  int sx = d->mb_x * 16 + (mx >> 1), sy = d->mb_y * 16 + (my >> 1);
  int hmax = d->mb_w * 16 - (mx & 1) - 15, vmax = d->mb_h * 16 - (my & 1) - 15;
  if ((unsigned)sx >= (unsigned)(hmax > 0 ? hmax : 0) ||
      (unsigned)sy >= (unsigned)(vmax > 0 ? vmax : 0))
    return refuse(d, R_MV_OUTSIDE);
  int dxy = ((my & 1) << 1) | (mx & 1);
  static const int which[4] = {C_MC_FULL, C_MC_X, C_MC_Y, C_MC_XY};
  ++d->count[which[dxy]];
  if (avg) ++d->count[C_MC_AVG];
  const int cur = d->cur;
  mc_block(d->pic[ref][0], d->ys, sx, sy, dxy, 16, avg,
           d->pic[cur][0] + (long)d->mb_y * 16 * d->ys + d->mb_x * 16, d->ys);
  int cx = mx / 2, cy = my / 2;
  int uvdxy = ((cy & 1) << 1) | (cx & 1);
  int ux = d->mb_x * 8 + (cx >> 1), uy = d->mb_y * 8 + (cy >> 1);
  for (int p = 1; p < 3; ++p)
    mc_block(d->pic[ref][p], d->cs, ux, uy, uvdxy, 8, avg,
             d->pic[cur][p] + (long)d->mb_y * 8 * d->cs + d->mb_x * 8,
             d->cs);
  return M2_OK;
}

/* ---- macroblocks ---- */

static void reset_predictors(m2_t *d) {
  d->last_dc[0] = d->last_dc[1] = d->last_dc[2] = 128;
  memset(d->last_mv, 0, sizeof d->last_mv);
}

/* quantiser_scale_code to the scale (q_scale_type 0) */
static int qscale(m2_t *d, int code) {
  if (code <= 2)
    ++d->count[C_Q_FINE];
  else if (code >= 16)
    ++d->count[C_Q_COARSE];
  return code << 1;
}

/* ff_mpv_reconstruct_mb for MPEG-2: intra blocks put, or the prediction
 * then the coded blocks added */
static int reconstruct(m2_t *d, int intra) {
  uint8_t *y = d->pic[d->cur][0] + (long)d->mb_y * 16 * d->ys + d->mb_x * 16;
  long c_at = (long)d->mb_y * 8 * d->cs + d->mb_x * 8;
  if (!intra) {
    int avg = 0, rc;
    if (d->mv_dir & MB_FORWARD) {
      rc = motion(d, d->last, d->mv[0][0], d->mv[0][1], 0);
      if (rc) return rc;
      avg = 1;
    }
    if (d->mv_dir & MB_BACKWARD) {
      rc = motion(d, d->next, d->mv[1][0], d->mv[1][1], avg);
      if (rc) return rc;
    }
  }
  for (int n = 0; n < 6; ++n) {
    uint8_t *dst = n < 4 ? y + (n >> 1) * 8 * d->ys + (n & 1) * 8
                         : d->pic[d->cur][n - 3] + c_at;
    long stride = n < 4 ? d->ys : d->cs;
    if (intra)
      simple_idct_put(d->block[n], dst, stride);
    else if (d->last_index[n] >= 0)
      simple_idct_add(d->block[n], dst, stride);
  }
  return M2_OK;
}

/* mpeg_decode_mb, then the reconstruction */
static int decode_mb(m2_t *d, br_t *b) {
  long xy = (long)d->mb_y * d->mb_w + d->mb_x;
  int rc;
  if (d->skip_run-- != 0) {
    if (d->pict_type == PT_P) {
      d->mb_type[xy] = MB_FORWARD | MB_SKIP;
      ++d->count[C_P_SKIP];
    } else {
      /* the macroblock before, the last of the row above at a row's
       * start (a slice's first macroblock is never skipped) */
      int prev = d->mb_type[xy - 1];
      if (prev & MB_INTRA) return M2_CORRUPT; /* skip after intra */
      d->mb_type[xy] = (uint8_t)(prev | MB_SKIP);
      ++d->count[C_B_SKIP];
    }
    return reconstruct(d, 0);
  }
  int type;
  if (d->pict_type == PT_I) {
    if (br_get(b, 1)) {
      type = MB_INTRA;
      ++d->count[C_I_MB];
    } else {
      if (!br_get(b, 1)) return M2_CORRUPT;
      type = MB_INTRA | MB_QUANT;
      ++d->count[C_I_MB_QUANT];
    }
  } else if (d->pict_type == PT_P) {
    int s = vlc_get(b, &d->ptype);
    if (s < 0) return M2_CORRUPT;
    type = ptype_flags[s];
    ++d->count[type & MB_INTRA       ? C_P_INTRA
               : type & MB_ZERO_MV   ? C_P_ZERO_MV
               : type & MB_CBP       ? C_P_FORWARD
                                     : C_P_FORWARD_NOT_CODED];
    if (type & MB_QUANT) ++d->count[C_P_QUANT];
  } else {
    int s = vlc_get(b, &d->btype);
    if (s < 0) return M2_CORRUPT;
    type = btype_flags[s];
    int both = MB_FORWARD | MB_BACKWARD;
    ++d->count[type & MB_INTRA ? C_B_INTRA
               : (type & both) == both ? C_B_BIDIR
               : type & MB_FORWARD ? C_B_FORWARD
                                   : C_B_BACKWARD];
    if (!(type & (MB_INTRA | MB_CBP))) ++d->count[C_B_NOT_CODED];
    if (type & MB_QUANT) ++d->count[C_B_QUANT];
  }
  if (type & MB_INTRA) {
    memset(d->block, 0, sizeof d->block);
    if (type & MB_QUANT) d->qscale = qscale(d, (int)br_get(b, 5));
    memset(d->last_mv, 0, sizeof d->last_mv);
    for (int n = 0; n < 6; ++n) {
      rc = decode_block_intra(d, b, n);
      if (rc) return rc;
    }
  } else {
    if (type & MB_ZERO_MV) {
      d->mv_dir = MB_FORWARD;
      if (type & MB_QUANT) d->qscale = qscale(d, (int)br_get(b, 5));
      d->last_mv[0][0] = d->last_mv[0][1] = 0;
      d->mv[0][0] = d->mv[0][1] = 0;
    } else {
      if (type & MB_QUANT) d->qscale = qscale(d, (int)br_get(b, 5));
      d->mv_dir = type & (MB_FORWARD | MB_BACKWARD);
      for (int i = 0; i < 2; ++i) {
        if (!(type & (i ? MB_BACKWARD : MB_FORWARD))) continue;
        for (int k = 0; k < 2; ++k) {
          rc = decode_motion(d, b, d->f_code[i][k], d->last_mv[i][k],
                             &d->mv[i][k]);
          if (rc) return rc;
          d->last_mv[i][k] = d->mv[i][k];
        }
      }
    }
    d->last_dc[0] = d->last_dc[1] = d->last_dc[2] = 128;
    if (type & MB_CBP) {
      memset(d->block, 0, sizeof d->block);
      int cbp = vlc_get(b, &d->cbp);
      if (cbp <= 0) return M2_CORRUPT;
      for (int n = 0; n < 6; ++n) {
        if (cbp & (32 >> n)) {
          rc = decode_block_inter(d, b, n);
          if (rc) return rc;
        } else {
          d->last_index[n] = -1;
        }
      }
    } else {
      for (int n = 0; n < 6; ++n) d->last_index[n] = -1;
    }
  }
  d->mb_type[xy] = (uint8_t)type;
  return reconstruct(d, type & MB_INTRA);
}

/* the increment after a macroblock (mpeg_decode_slice's "skip mb
 * handling"): 1 at the slice's end */
static int read_skip_run(m2_t *d, br_t *b) {
  d->skip_run = 0;
  for (;;) {
    int code = vlc_get(b, &d->incr);
    if (code < 0) return M2_CORRUPT;
    if (code == 33) {
      d->skip_run += 33;
      ++d->count[C_MB_ESCAPE];
    } else if (code == 35) {
      if (d->skip_run || br_show(b, 15)) return M2_CORRUPT;
      return 1;
    } else if (code != 34) {
      d->skip_run += code;
      break;
    }
  }
  if (d->skip_run) {
    if (d->pict_type == PT_I) return M2_CORRUPT;
    d->last_dc[0] = d->last_dc[1] = d->last_dc[2] = 128;
    for (int n = 0; n < 6; ++n) d->last_index[n] = -1;
    if (d->pict_type == PT_P) {
      d->mv_dir = MB_FORWARD;
      d->mv[0][0] = d->mv[0][1] = 0;
      d->last_mv[0][0] = d->last_mv[0][1] = 0;
    } else {
      memcpy(d->mv, d->last_mv, sizeof d->mv);
    }
  }
  return M2_OK;
}

/* mpeg_decode_slice from the bits after the slice's start code */
static int decode_slice(m2_t *d, br_t *b, int mb_y) {
  int code = (int)br_get(b, 5);
  if (!code) return M2_CORRUPT;
  d->qscale = qscale(d, code);
  while (br_get(b, 1)) { /* extra_bit_slice (intra_slice_flag first) */
    b->pos += 8;
    ++d->count[C_SLICE_EXTRA];
  }
  d->mb_x = 0;
  for (;;) {
    if (br_left(b) <= 0) return M2_CORRUPT;
    int c = vlc_get(b, &d->incr);
    if (c < 0 || c == 35) return M2_CORRUPT;
    if (c == 33) {
      d->mb_x += 33;
      ++d->count[C_MB_ESCAPE];
    } else if (c != 34) {
      d->mb_x += c;
      break;
    }
  }
  if (d->mb_x >= d->mb_w) return M2_CORRUPT;
  reset_predictors(d);
  d->mb_y = mb_y;
  d->skip_run = 0;
  ++d->count[C_SLICE];
  for (;;) {
    int rc = decode_mb(d, b);
    if (rc) return rc;
    d->mb_done[(long)d->mb_y * d->mb_w + d->mb_x] = 1;
    if (++d->mb_x >= d->mb_w) {
      d->mb_x = 0;
      if (++d->mb_y >= d->mb_h) {
        long left = br_left(b);
        if (left < 0 || (left && br_show(b, left < 23 ? (int)left : 23)))
          return M2_CORRUPT;
        break;
      }
    }
    if (d->skip_run == -1) {
      rc = read_skip_run(d, b);
      if (rc == 1) break;
      if (rc) return rc;
    }
  }
  return br_left(b) < 0 ? M2_CORRUPT : M2_OK;
}

/* ---- pictures ---- */

static int grey_slot(m2_t *d) {
  if (!d->pic[GREY][0]) {
    for (int p = 0; p < 3; ++p) {
      long n = p ? (long)d->cs * d->mb_h * 8 : (long)d->ys * d->mb_h * 16;
      d->pic[GREY][p] = (uint8_t *)malloc((size_t)n);
      if (!d->pic[GREY][p]) return M2_NOMEM;
      memset(d->pic[GREY][p], 0x80, (size_t)n);
    }
  }
  return M2_OK;
}

/* ff_mpv_frame_start: the slot the picture is decoded into; an anchor
 * moves the references along */
static int frame_start(m2_t *d) {
  int cur = 0;
  while (cur == d->last || cur == d->next) ++cur;
  d->cur = cur;
  if (d->pict_type != PT_B) {
    d->last = d->next;
    d->next = cur;
  }
  if (d->last == NONE && d->pict_type == PT_P)
    return refuse(d, R_NO_REFERENCE);
  if (d->last == NONE && d->pict_type == PT_B) {
    int rc = grey_slot(d);
    if (rc) return rc;
    d->last = GREY;
    ++d->count[C_GREY_FORWARD];
  }
  memset(d->mb_done, 0, (size_t)d->mb_w * d->mb_h);
  ++d->count[d->pict_type == PT_I   ? C_I_PIC
             : d->pict_type == PT_P ? C_P_PIC
                                    : C_B_PIC];
  if (d->pict_type != PT_I) {
    int up = 0;
    for (int i = 0; i < (d->pict_type == PT_B ? 2 : 1); ++i)
      up |= d->f_code[i][0] > 1 || d->f_code[i][1] > 1;
    ++d->count[up ? C_FCODE2UP : C_FCODE1];
  }
  return M2_OK;
}

/* slice_end: the picture is whole; the frame FFmpeg outputs for it */
static int slice_end(m2_t *d) {
  for (long i = 0; i < (long)d->mb_w * d->mb_h; ++i)
    if (!d->mb_done[i]) return M2_CORRUPT; /* FFmpeg conceals them */
  if (d->pict_type == PT_B || d->low_delay)
    d->out = d->cur;
  else if (d->last != NONE && d->last != GREY)
    d->out = d->last;
  return M2_OK;
}

/* decode_chunks: the start codes of one packet (or the extradata) */
static int decode_chunks(m2_t *d, const uint8_t *buf, long n,
                         int extradata) {
  enum { NO_CODE, PICTURE, SLICE };
  int last_code = NO_CODE, pictures = 0, skip = 0, rc;
  long at = 0;
  d->pict_type = 0;
  d->first_slice = 0;
  for (;;) {
    long i = at;
    while (i + 3 < n && !(buf[i] == 0 && buf[i + 1] == 0 && buf[i + 2] == 1))
      ++i;
    if (i + 3 >= n) break;
    int code = buf[i + 3];
    at = i + 4;
    br_t b = {buf + at, (n - at) * 8, 0};
    rc = M2_OK;
    if (code == 0xB3) {
      if (last_code == NO_CODE) { /* FFmpeg ignores one after a picture */
        rc = decode_sequence(d, &b);
        if (!rc && extradata) ++d->count[C_SEQ_EXTRADATA];
      }
    } else if (code == 0x00) {
      if (pictures++) return refuse(d, R_TWO_PICTURES);
      if (d->mpeg1) return refuse(d, R_MPEG1);
      rc = postinit(d);
      if (!rc) rc = decode_picture_header(d, &b);
      d->first_slice = 1;
      last_code = PICTURE;
    } else if (code == 0xB5) {
      int ext = (int)br_get(&b, 4);
      if (ext == 1) {
        if (last_code == NO_CODE) rc = decode_sequence_extension(d, &b);
      } else if (ext == 2) {
        rc = decode_display_extension(d, &b);
      } else if (ext == 3) {
        rc = decode_quant_matrix_extension(d, &b);
      } else if (ext == 8) {
        if (last_code == PICTURE) rc = decode_picture_coding_extension(d, &b);
      } else if (ext == 5 || ext == 9 || ext == 10) {
        rc = refuse(d, R_SCALABLE);
      } else {
        ++d->count[C_OTHER_EXT]; /* copyright, picture display: no pixel */
      }
    } else if (code == 0xB2) {
      rc = decode_user_data(d, buf + at, n - at);
    } else if (code == 0xB8) {
      if (last_code == NO_CODE) {
        b.pos += 25; /* time_code */
        d->closed_gop = (int)br_get(&b, 1);
        int broken = (int)br_get(&b, 1);
        ++d->count[d->closed_gop ? C_GOP_CLOSED : C_GOP_OPEN];
        if (broken) ++d->count[C_BROKEN_LINK];
      }
    } else if (code == 0xB7) {
      ++d->count[C_SEQ_END];
    } else if (code >= 0x01 && code <= 0xAF && last_code != NO_CODE) {
      if (!d->coding_ext) return refuse(d, R_NO_CODING_EXT);
      int mb_y = code - 1;
      if (d->mb_h > 2800 / 16) mb_y += (buf[at] & 0xE0) << 2;
      last_code = SLICE;
      if (n - at < 2 || mb_y >= d->mb_h) return M2_CORRUPT;
      if (d->pict_type == PT_B && d->last == NONE && !d->closed_gop) {
        skip = 1; /* FFmpeg drops a B picture after an open GOP here */
        continue;
      }
      if (d->pict_type == PT_B && d->next == NONE)
        return refuse(d, R_NO_REFERENCE);
      if (d->first_slice) {
        d->first_slice = 0;
        skip = 0;
        /* mpeg_field_start's least size for the picture's data */
        if ((long long)d->mb_w * d->mb_h * 11 / (33 * 2 * 8) > n - at)
          return M2_CORRUPT;
        rc = frame_start(d);
        if (rc) return rc;
      }
      if (d->mb_h > 2800 / 16) b.pos += 3;
      rc = decode_slice(d, &b, mb_y);
      if (rc) return rc;
      at += (b.pos - 1) / 8 > 0 ? (b.pos - 1) / 8 : 0;
    }
    if (rc) return rc;
  }
  if (extradata) return M2_OK;
  if (!pictures) return refuse(d, R_NO_PICTURE);
  if (skip) {
    ++d->count[C_B_DROPPED];
    return M2_OK;
  }
  if (d->first_slice) return M2_CORRUPT; /* a picture with no slice */
  return slice_end(d);
}

/* ---- API ---- */

/* A decoder for a stream with `extradata` (a sequence header and its
 * extensions, or none).  *rc is M2_OK, or what the extradata refused. */
void *fl_mpeg2_open(const uint8_t *extradata, long n, int *rc) {
  m2_t *d = (m2_t *)calloc(1, sizeof(m2_t));
  *rc = M2_NOMEM;
  if (!d) return NULL;
  coef_tables();
  d->last = d->next = d->cur = d->out = NONE;
  int r = vlc_build(&d->coef, 16, 113, coef_code, coef_len);
  if (!r) r = vlc_build(&d->incr, 11, 36, incr_code, incr_len);
  if (!r) r = vlc_build(&d->ptype, 6, 7, ptype_code, ptype_len);
  if (!r) r = vlc_build(&d->btype, 6, 11, btype_code, btype_len);
  if (!r) r = vlc_build(&d->cbp, 9, 64, cbp_code, cbp_len);
  if (!r) r = vlc_build(&d->mvd, 10, 17, mv_code, mv_len);
  if (!r) r = vlc_build(&d->dc_lum, 9, 12, dc_lum_code, dc_lum_len);
  if (!r) r = vlc_build(&d->dc_chroma, 10, 12, dc_chroma_code, dc_chroma_len);
  if (r) return d;
  for (int i = 0; i < 64; ++i) {
    d->intra_m[i] = d->chroma_intra_m[i] = default_intra[i];
    d->inter_m[i] = d->chroma_inter_m[i] = 16;
  }
  *rc = M2_OK;
  if (n > 0) {
    uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
    if (!buf) {
      *rc = M2_NOMEM;
      return d;
    }
    memcpy(buf, extradata, (size_t)n);
    /* FFmpeg parses the extradata before the first packet and ignores its
     * errors; a refusal there shows at open */
    r = decode_chunks(d, buf, n, 1);
    free(buf);
    if (r >= M2_REFUSED || r == M2_NOMEM) *rc = r;
  }
  return d;
}

/* Decode one packet (n 0: the end of the stream).  M2_OK: a frame
 * (fl_mpeg2_bgr converts it), its size in wh[0..1]; M2_NONE: no frame;
 * M2_CORRUPT; M2_REFUSED + the tool's R_*. */
int fl_mpeg2_decode(void *h, const uint8_t *data, long n, int *wh) {
  m2_t *d = (m2_t *)h;
  d->out = NONE;
  if (n == 0 || (n == 4 && data[0] == 0 && data[1] == 0 && data[2] == 1 &&
                 data[3] == 0xB7)) {
    if (n) ++d->count[C_SEQ_END];
    if (!d->low_delay && d->next != NONE) {
      d->out = d->next;
      d->next = NONE;
      ++d->count[C_DRAIN];
    }
  } else {
    uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
    if (!buf) return M2_NOMEM;
    memcpy(buf, data, (size_t)n);
    int rc = decode_chunks(d, buf, n, 0);
    free(buf);
    if (rc) {
      d->out = NONE;
      return rc;
    }
  }
  if (d->out == NONE) return M2_NONE;
  wh[0] = d->pic_w;
  wh[1] = d->pic_h;
  return M2_OK;
}

/* The frame the last packet gave as BGR (H, W, 3). */
int fl_mpeg2_bgr(void *h, uint8_t *out) {
  m2_t *d = (m2_t *)h;
  if (d->out == NONE) return M2_CORRUPT;
  yuv_planes_t p = {d->pic[d->out][0], d->pic[d->out][1], d->pic[d->out][2],
                    d->ys, d->cs};
  return yuv_to_bgr(&p, d->pic_w, d->pic_h, 1, 1, 0, out);
}

/* The planes of the frame the last packet gave, cropped: y (H x W), u and
 * v (ceil(H/2) x ceil(W/2)), each packed. */
void fl_mpeg2_planes(void *h, uint8_t *y, uint8_t *u, uint8_t *v) {
  m2_t *d = (m2_t *)h;
  if (d->out == NONE) return;
  int cw = (d->pic_w + 1) / 2, ch = (d->pic_h + 1) / 2;
  for (int r = 0; r < d->pic_h; ++r)
    memcpy(y + (long)r * d->pic_w, d->pic[d->out][0] + (long)r * d->ys,
           (size_t)d->pic_w);
  for (int r = 0; r < ch; ++r) {
    memcpy(u + (long)r * cw, d->pic[d->out][1] + (long)r * d->cs, (size_t)cw);
    memcpy(v + (long)r * cw, d->pic[d->out][2] + (long)r * d->cs, (size_t)cw);
  }
}

/* The syntax path counters (C_NPATHS of them) and the last refusal. */
int fl_mpeg2_counts(void *h, uint64_t *out) {
  m2_t *d = (m2_t *)h;
  memcpy(out, d->count, sizeof d->count);
  return d->refused;
}

void fl_mpeg2_close(void *h) {
  m2_t *d = (m2_t *)h;
  if (!d) return;
  free_pictures(d);
  vlc_free(&d->coef);
  vlc_free(&d->incr);
  vlc_free(&d->ptype);
  vlc_free(&d->btype);
  vlc_free(&d->cbp);
  vlc_free(&d->mvd);
  vlc_free(&d->dc_lum);
  vlc_free(&d->dc_chroma);
  free(d);
}
