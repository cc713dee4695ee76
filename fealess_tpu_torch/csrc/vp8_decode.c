/* VP8 video for io/vp8.py: what cv2.VideoCapture returns for the streams
 * cv2.VideoWriter writes with the fourcc VP80 (AVI, Matroska, WebM), bit
 * for bit.  cv2 decodes them with FFmpeg's native vp8 decoder (libavcodec
 * 62.28 in cv2 5.0.0) and converts its yuv420p planes to BGR24 with
 * swscale (yuv_bgr.h, the raw I420 path's converter).  The decoding is
 * RFC 6386's; where the RFC leaves a choice open the code does what
 * FFmpeg's decoder does.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.  A decoder
 * keeps the three reference frames (last, golden, altref), the
 * probabilities and the loop-filter deltas across packets.
 *
 * The stages (RFC 6386 sections) and the FFmpeg functions they follow:
 *   bool decoder  7: vpx_rac_get_prob and its renormalisation, which read
 *                 two bytes at a time, past a partition's end into what
 *                 follows it in the packet (then into zero padding);
 *                 vpx_rac_is_end counts reads past the end, and the
 *                 eleventh check that finds one makes the packet corrupt,
 *                 where decode_mb_row_no_filter checks it
 *   headers       9, 19.2: the frame tag, the key frame's start code and
 *                 size (scale bits ignored: FFmpeg does not upscale), the
 *                 bool-coded header (vp8_decode_frame_header)
 *   modes         11, 16: key-frame modes with their above / left
 *                 contexts, inter-frame intra modes, the near-MV search
 *                 and its mode contexts (vp8_decode_mvs), SPLITMV
 *                 (decode_splitmvs), MVs (read_mv_component)
 *   tokens        13: per MB with the above / left non-zero contexts,
 *                 dequantised as they are read, in int16 as FFmpeg's
 *                 blocks are (decode_block_coeffs_internal)
 *   transforms    14.3-14.4: the inverse WHT and DCT (vp8_luma_dc_wht_c,
 *                 vp8_idct_add_c, their DC-only forms)
 *   prediction    12: intra prediction from the frame before the loop
 *                 filter, 127 above the frame and 129 left of it, the
 *                 right column's above-right pixels from the MB row above
 *                 (repeated from its last pixel in the last MB column);
 *                 18: the six-tap (version 0) or bilinear (1-3) filters,
 *                 horizontal then vertical, on the reference frame padded
 *                 by repeating its MB-aligned edge (emulated_edge_mc)
 *   loop filter   15: normal and simple filters per MB after the frame is
 *                 reconstructed (filter_mb, filter_mb_simple; the inner
 *                 edges of an MB with no coefficients that is neither
 *                 B_PRED nor SPLITMV are skipped)
 *   references    9.7-9.8: golden and altref copies from the references
 *                 before this frame, then the refreshes
 *   output        the frame cropped to its size, yuv420p at limited range
 *                 to BGR24 through yuv_bgr.h; a frame with show_frame 0 is
 *                 decoded and not output
 *
 * A tool that no committed clip holds is refused with its name's code
 * (VP8_REFUSED + R_*).  Every syntax path that is decoded bumps a counter
 * (C_*), so a test holds the committed clips to covering all of them.
 */
#include "yuv_bgr.h"

#include <string.h>

enum { VP8_OK = 0, VP8_SKIPPED = 1, VP8_CORRUPT = -1, VP8_NOMEM = -2,
       VP8_REFUSED = 100 };

/* tools refused, by name in io/vp8.py */
enum {
  R_VERSION = 1, R_SEGMENTATION, R_RESIZE, R_CLAMPING
};

/* syntax paths counted */
enum {
  C_KEY_FRAME, C_INTER_FRAME, C_HIDDEN_FRAME, C_SCALE_BITS, C_COLOR_SPACE,
  C_VERSION0,
  C_BILINEAR, C_FULL_PIXEL, C_LF_DELTA_UPDATE, C_QUANT_DELTA,
  C_REFRESH_GOLDEN, C_REFRESH_ALTREF, C_COPY_LAST_TO_GOLDEN,
  C_COPY_ALTREF_TO_GOLDEN, C_COPY_LAST_TO_ALTREF, C_COPY_GOLDEN_TO_ALTREF,
  C_SIGN_BIAS, C_KEEP_LAST, C_KEEP_PROBS, C_COEF_PROB_UPDATE,
  C_YMODE_PROB_UPDATE, C_UVMODE_PROB_UPDATE, C_MV_PROB_UPDATE,
  C_NO_SKIP_FLAG, C_MB_SKIP, C_MB_NO_COEFFS, C_KF_I16, C_KF_BPRED,
  C_INTER_I16, C_INTER_BPRED, C_I16_DC, C_I16_V, C_I16_H, C_I16_TM,
  C_B_DC, C_B_TM, C_B_VE, C_B_HE, C_B_LD, C_B_RD, C_B_VR, C_B_VL, C_B_HD,
  C_B_HU, C_UV_DC, C_UV_V, C_UV_H, C_UV_TM, C_REF_LAST, C_REF_GOLDEN,
  C_REF_ALTREF, C_ZEROMV, C_NEARESTMV, C_NEARMV, C_NEWMV, C_SPLITMV,
  C_SPLIT_16X8, C_SPLIT_8X16, C_SPLIT_8X8, C_SPLIT_4X4, C_SUB_LEFT,
  C_SUB_ABOVE, C_SUB_ZERO, C_SUB_NEW, C_MV_SHORT, C_MV_LONG, C_MV_CLAMPED,
  C_TOKEN_CAT1, C_TOKEN_CAT2, C_TOKEN_CAT3, C_TOKEN_CAT4, C_TOKEN_CAT5,
  C_TOKEN_CAT6, C_WHT, C_WHT_DC, C_IDCT, C_IDCT_DC, C_MC_FULL, C_MC_H,
  C_MC_V, C_MC_HV, C_MC_EDGE, C_LF_OFF, C_LF_NORMAL, C_LF_SIMPLE,
  C_LF_SHARPNESS, C_LF_MB_EDGE, C_LF_INNER, C_LF_HEV, C_PARTITIONS, C_NPATHS
};

/* ---- the bool decoder (FFmpeg's VPXRangeCoder) ---- */

typedef struct {
  int high, bits;
  unsigned code_word;
  const uint8_t *buffer, *end;
  int end_reached;
} rac_t;

static const uint8_t norm_shift[256] = {
    8, 7, 6, 6, 5, 5, 5, 5, 4, 4, 4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3,
    3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

/* ff_vpx_init_range_decoder: 0, or VP8_CORRUPT for an empty partition.
 * The packet buffer holds zero padding past its end, which the first
 * three-byte read and the two-byte reads may reach. */
static int rac_init(rac_t *c, const uint8_t *buf, long size) {
  c->high = 255;
  c->bits = -16;
  c->buffer = buf;
  c->end = buf + size;
  c->end_reached = 0;
  if (size < 1) return VP8_CORRUPT;
  c->code_word = ((unsigned)buf[0] << 16) | ((unsigned)buf[1] << 8) | buf[2];
  c->buffer += 3;
  return 0;
}

/* the bools a packet's partitions give, kept for the tests (which
 * re-encode a stream with a header field or the partitioning changed),
 * each with a mark where each MB starts */
typedef struct {
  uint8_t *prob, *bit;
  long *mark;
  long n, nmark, cap;
  const uint8_t *replay; /* bits to give in place of decoded ones */
  long nreplay;
} trace_t;

static inline int rac_get(rac_t *c, int prob) {
  int shift = norm_shift[c->high];
  int bits = c->bits;
  unsigned code_word = c->code_word;
  c->high <<= shift;
  code_word <<= shift;
  bits += shift;
  if (bits >= 0 && c->buffer < c->end) {
    code_word |= (((unsigned)c->buffer[0] << 8) | c->buffer[1]) << bits;
    c->buffer += 2;
    bits -= 16;
  }
  c->bits = bits;
  unsigned low = 1 + (((unsigned)(c->high - 1) * (unsigned)prob) >> 8);
  unsigned low_shift = low << 16;
  int bit = code_word >= low_shift;
  c->high = bit ? c->high - (int)low : (int)low;
  c->code_word = bit ? code_word - low_shift : code_word;
  return bit;
}

static inline void trace_put(trace_t *t, int prob, int bit) {
  if (t->n < t->cap) {
    t->prob[t->n] = (uint8_t)prob;
    t->bit[t->n] = (uint8_t)bit;
  }
  t->n++;
}

static inline void trace_mark(trace_t *t) {
  if (t->cap && t->nmark < t->cap) t->mark[t->nmark] = t->n;
  t->nmark++;
}

/* vpx_rac_is_end */
static inline int rac_is_end(rac_t *c) {
  if (c->end <= c->buffer && c->bits >= 0) c->end_reached++;
  return c->end_reached > 10;
}

/* ---- tables (RFC 6386) ---- */

static const int8_t kf_ymode_tree[8] = {-4, 2, 4, 6, -0, -1, -2, -3};
static const int8_t ymode_tree[8] = {-0, 2, 4, 6, -1, -2, -3, -4};
static const int8_t uvmode_tree[6] = {-0, 2, -1, 4, -2, -3};
/* B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU */
static const int8_t bmode_tree[18] = {-0, 2, -1, 4, -2, 6, 8, 12, -3, 10,
                                      -5, -6, -4, 14, -7, 16, -8, -9};
static const uint8_t kf_ymode_probs[4] = {145, 156, 163, 128};
static const uint8_t kf_uvmode_probs[3] = {142, 114, 183};
static const uint8_t default_ymode_probs[4] = {112, 86, 140, 37};
static const uint8_t default_uvmode_probs[3] = {162, 101, 204};
static const uint8_t bmode_probs[9] = {120, 90, 79, 133, 87, 85, 80, 111,
                                       151};
/* the sub-block mode a 16x16 mode implies for the key-frame contexts */
static const uint8_t implied_bmode[4] = {0, 2, 3, 1};
static const uint8_t mode_contexts[6][4] = {
    {7, 1, 1, 143},     {14, 18, 14, 107},  {135, 64, 57, 68},
    {60, 56, 128, 65},  {159, 134, 128, 34}, {234, 188, 128, 28}};
static const uint8_t submv_probs[5][3] = {
    {147, 136, 18}, {106, 145, 1}, {179, 121, 1}, {223, 1, 34}, {208, 1, 1}};
static const uint8_t mbsplit_probs[3] = {110, 111, 150};
/* SPLITMV partitionings: 16x8, 8x16, 8x8, 4x4, and none (one MV) */
enum { P_16X8, P_8X16, P_8X8, P_4X4, P_NONE };
static const uint8_t mbsplits[5][16] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1},
    {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0}};
static const uint8_t mbsplit_count[4] = {2, 2, 4, 16};
static const uint8_t mbfirstidx[4][16] = {
    {0, 8}, {0, 2}, {0, 2, 8, 10},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}};
static const uint8_t zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                   9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t coef_bands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                       6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t cat3_probs[] = {173, 148, 140, 0};
static const uint8_t cat4_probs[] = {176, 155, 140, 135, 0};
static const uint8_t cat5_probs[] = {180, 157, 141, 134, 130, 0};
static const uint8_t cat6_probs[] = {254, 254, 243, 230, 196, 177,
                                     153, 140, 133, 130, 129, 0};
static const uint8_t *const cat_probs[4] = {cat3_probs, cat4_probs,
                                            cat5_probs, cat6_probs};
/* six-tap filters by eighth-pixel position (sign folded as FFmpeg does:
 * taps 1 and 4 subtract) */
static const uint8_t subpel_filters[7][6] = {
    {0, 6, 123, 12, 1, 0}, {2, 11, 108, 36, 8, 1}, {0, 9, 93, 50, 6, 0},
    {3, 16, 77, 77, 16, 3}, {0, 6, 50, 93, 9, 0},  {1, 8, 36, 108, 11, 2},
    {0, 1, 12, 123, 6, 0}};
/* hev threshold by [key frame][filter level] */
static const uint8_t hev_thresh_lut[2][64] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3,
     3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2}};

/* RFC 6386's large tables: the default coefficient probabilities (13.5),
 * their update probabilities (13.4), the key-frame sub-block mode
 * probabilities (11.5), the quantiser steps (14.1) and the MV
 * probabilities and their update probabilities (17.2) */
static const uint8_t default_coef_probs[4][8][3][11] = {
    {{{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
      {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
      {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
     {{1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
      {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
      {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
     {{1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
      {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
      {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
     {{1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
      {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
      {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
     {{1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
      {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
      {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
     {{1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
      {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
      {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
      {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
      {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
     {{1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
      {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
      {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
     {{1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
      {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
      {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
     {{1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
      {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
      {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
     {{1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
      {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
      {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
     {{1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
      {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
      {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
     {{1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
      {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
      {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
     {{1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
      {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {{{253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
      {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
      {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
     {{1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
      {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
      {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
     {{1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
      {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
      {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
     {{1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
      {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
      {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
     {{1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
      {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
      {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
      {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
      {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
     {{128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
      {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {{{202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
      {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
      {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
     {{1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
      {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
      {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
     {{1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
      {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
      {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
     {{1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
      {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
      {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
     {{1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
      {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
      {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
     {{1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
      {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
      {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
     {{1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
      {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
      {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
     {{1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
      {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};
static const uint8_t coef_update_probs[4][8][3][11] = {
    {{{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
      {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
      {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
      {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
      {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
     {{255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {{{248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
     {{255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
      {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
      {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
     {{255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
      {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};
static const uint8_t kf_bmode_probs[10][10][9] = {
    {{231, 120, 48, 89, 115, 113, 120, 152, 112},
     {152, 179, 64, 126, 170, 118, 46, 70, 95},
     {175, 69, 143, 80, 85, 82, 72, 155, 103},
     {56, 58, 10, 171, 218, 189, 17, 13, 152},
     {144, 71, 10, 38, 171, 213, 144, 34, 26},
     {114, 26, 17, 163, 44, 195, 21, 10, 173},
     {121, 24, 80, 195, 26, 62, 44, 64, 85},
     {170, 46, 55, 19, 136, 160, 33, 206, 71},
     {63, 20, 8, 114, 114, 208, 12, 9, 226},
     {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {{134, 183, 89, 137, 98, 101, 106, 165, 148},
     {72, 187, 100, 130, 157, 111, 32, 75, 80},
     {66, 102, 167, 99, 74, 62, 40, 234, 128},
     {41, 53, 9, 178, 241, 141, 26, 8, 107},
     {104, 79, 12, 27, 217, 255, 87, 17, 7},
     {74, 43, 26, 146, 73, 166, 49, 23, 157},
     {65, 38, 105, 160, 51, 52, 31, 115, 128},
     {87, 68, 71, 44, 114, 51, 15, 186, 23},
     {47, 41, 14, 110, 182, 183, 21, 17, 194},
     {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {{88, 88, 147, 150, 42, 46, 45, 196, 205},
     {43, 97, 183, 117, 85, 38, 35, 179, 61},
     {39, 53, 200, 87, 26, 21, 43, 232, 171},
     {56, 34, 51, 104, 114, 102, 29, 93, 77},
     {107, 54, 32, 26, 51, 1, 81, 43, 31},
     {39, 28, 85, 171, 58, 165, 90, 98, 64},
     {34, 22, 116, 206, 23, 34, 43, 166, 73},
     {68, 25, 106, 22, 64, 171, 36, 225, 114},
     {34, 19, 21, 102, 132, 188, 16, 76, 124},
     {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {{193, 101, 35, 159, 215, 111, 89, 46, 111},
     {60, 148, 31, 172, 219, 228, 21, 18, 111},
     {112, 113, 77, 85, 179, 255, 38, 120, 114},
     {40, 42, 1, 196, 245, 209, 10, 25, 109},
     {100, 80, 8, 43, 154, 1, 51, 26, 71},
     {88, 43, 29, 140, 166, 213, 37, 43, 154},
     {61, 63, 30, 155, 67, 45, 68, 1, 209},
     {142, 78, 78, 16, 255, 128, 34, 197, 171},
     {41, 40, 5, 102, 211, 183, 4, 1, 221},
     {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {{125, 98, 42, 88, 104, 85, 117, 175, 82},
     {95, 84, 53, 89, 128, 100, 113, 101, 45},
     {75, 79, 123, 47, 51, 128, 81, 171, 1},
     {57, 17, 5, 71, 102, 57, 53, 41, 49},
     {115, 21, 2, 10, 102, 255, 166, 23, 6},
     {38, 33, 13, 121, 57, 73, 26, 1, 85},
     {41, 10, 67, 138, 77, 110, 90, 47, 114},
     {101, 29, 16, 10, 85, 128, 101, 196, 26},
     {57, 18, 10, 102, 102, 213, 34, 20, 43},
     {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {{138, 31, 36, 171, 27, 166, 38, 44, 229},
     {67, 87, 58, 169, 82, 115, 26, 59, 179},
     {63, 59, 90, 180, 59, 166, 93, 73, 154},
     {40, 40, 21, 116, 143, 209, 34, 39, 175},
     {57, 46, 22, 24, 128, 1, 54, 17, 37},
     {47, 15, 16, 183, 34, 223, 49, 45, 183},
     {46, 17, 33, 183, 6, 98, 15, 32, 183},
     {65, 32, 73, 115, 28, 128, 23, 128, 205},
     {40, 3, 9, 115, 51, 192, 18, 6, 223},
     {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {{104, 55, 44, 218, 9, 54, 53, 130, 226},
     {64, 90, 70, 205, 40, 41, 23, 26, 57},
     {54, 57, 112, 184, 5, 41, 38, 166, 213},
     {30, 34, 26, 133, 152, 116, 10, 32, 134},
     {75, 32, 12, 51, 192, 255, 160, 43, 51},
     {39, 19, 53, 221, 26, 114, 32, 73, 255},
     {31, 9, 65, 234, 2, 15, 1, 118, 73},
     {88, 31, 35, 67, 102, 85, 55, 186, 85},
     {56, 21, 23, 111, 59, 205, 45, 37, 192},
     {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {{102, 61, 71, 37, 34, 53, 31, 243, 192},
     {69, 60, 71, 38, 73, 119, 28, 222, 37},
     {68, 45, 128, 34, 1, 47, 11, 245, 171},
     {62, 17, 19, 70, 146, 85, 55, 62, 70},
     {75, 15, 9, 9, 64, 255, 184, 119, 16},
     {37, 43, 37, 154, 100, 163, 85, 160, 1},
     {63, 9, 92, 136, 28, 64, 32, 201, 85},
     {86, 6, 28, 5, 64, 255, 25, 248, 1},
     {56, 8, 17, 132, 137, 255, 55, 116, 128},
     {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {{164, 50, 31, 137, 154, 133, 25, 35, 218},
     {51, 103, 44, 131, 131, 123, 31, 6, 158},
     {86, 40, 64, 135, 148, 224, 45, 183, 128},
     {22, 26, 17, 131, 240, 154, 14, 1, 209},
     {83, 12, 13, 54, 192, 255, 68, 47, 28},
     {45, 16, 21, 91, 64, 222, 7, 1, 197},
     {56, 21, 39, 155, 60, 138, 23, 102, 213},
     {85, 26, 85, 85, 128, 128, 32, 146, 171},
     {18, 11, 7, 63, 144, 171, 4, 4, 246},
     {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {{190, 80, 35, 99, 180, 80, 126, 54, 45},
     {85, 126, 47, 87, 176, 51, 41, 20, 32},
     {101, 75, 128, 139, 118, 146, 116, 128, 85},
     {56, 41, 15, 176, 236, 85, 37, 9, 62},
     {146, 36, 19, 30, 171, 255, 97, 27, 20},
     {71, 30, 17, 119, 118, 255, 17, 18, 138},
     {101, 38, 60, 138, 55, 70, 43, 26, 142},
     {138, 45, 61, 62, 219, 1, 81, 188, 64},
     {32, 41, 20, 117, 151, 142, 20, 21, 163},
     {112, 19, 12, 61, 195, 128, 48, 4, 24}}};
static const int16_t dc_qlookup[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14,
    15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32,
    33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66,
    67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77,
    78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157,
};
static const int16_t ac_qlookup[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};
static const uint8_t default_mv_probs[2][19] = {
    {162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178,
     206, 239, 254, 254},
    {164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180,
     203, 236, 254, 254}};
static const uint8_t mv_update_probs[2][19] = {
    {237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250,
     250, 252, 254, 254},
    {231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251,
     251, 254, 254, 254}};

/* ---- decoder state ---- */

typedef struct {
  int16_t x, y;
} mv_t;

/* modes: 0-3 the 16x16 intra modes (DC, V, H, TM), then: */
enum { M_BPRED = 4, M_ZERO, M_NEAREST, M_NEAR, M_NEW, M_SPLIT };

typedef struct {
  uint8_t mode, uvmode, ref, skip, part;
  uint8_t bmodes[16];
  mv_t mv;      /* the MB's MV (the last partition's under SPLITMV) */
  mv_t bmv[16]; /* by partition */
  uint8_t level, inner_limit, inner; /* loop filter */
} mb_t;

typedef struct {
  uint8_t token[4][8][3][11];
  uint8_t ymode[4], uvmode[3];
  uint8_t mv[2][19];
} probs_t;

typedef struct {
  uint8_t *y, *u, *v;
} frame_t;

enum { REF_CURRENT, REF_LAST, REF_GOLDEN, REF_ALTREF };

typedef struct {
  int width, height, mbw, mbh, ys, cs;
  frame_t buf[4];
  int ref[4]; /* buffer of each REF_*, or -1 */
  int cur;    /* the last decoded frame's buffer */
  mb_t *mbs;  /* (mbh + 1) x (mbw + 1), row 0 and column 0 a border */
  uint8_t (*top_nnz)[9];
  uint8_t *top_bmodes; /* 4 a column */
  probs_t prob, saved;
  int lf_delta_ref[4], lf_delta_mode[4];
  /* this frame's header */
  int key, version, show, filter_simple, filter_level, sharpness;
  int lf_delta_on, mb_skip_on, prob_skip, prob_intra, prob_last;
  int prob_golden, nparts, sign_bias[4], refresh_probs;
  int16_t qmul[3][2]; /* y2, y, uv: dc, ac */
  rac_t c, parts[8];
  uint8_t *packet; /* the packet, padded */
  long packet_cap;
  uint64_t count[C_NPATHS];
  int tracing;
  trace_t trace[2]; /* the first partition, the token partitions */
} vp8_t;

/* vpx_rac_is_end, except while bits are replayed */
static inline int at_end(vp8_t *d, rac_t *c) {
  return !(d->tracing && d->trace[0].replay) && rac_is_end(c);
}

static int refuse(int tool) { return VP8_REFUSED + tool; }

/* a bool of partition c, traced (or replayed) in t when the tests ask */
static inline int traced_get(vp8_t *d, rac_t *c, trace_t *t, int prob) {
  int bit = rac_get(c, prob);
  if (!d->tracing) return bit;
  if (t->replay) bit = t->n < t->nreplay ? t->replay[t->n] : 0;
  trace_put(t, prob, bit);
  return bit;
}

/* reads from the first partition */
static inline int get_p(vp8_t *d, int prob) {
  return traced_get(d, &d->c, &d->trace[0], prob);
}

/* reads from a token partition */
static inline int get_t(vp8_t *d, rac_t *c, int prob) {
  return traced_get(d, c, &d->trace[1], prob);
}

static inline int get_bit(vp8_t *d) { return get_p(d, 128); }

static int get_uint(vp8_t *d, int bits) {
  int v = 0;
  while (bits--) v = (v << 1) | get_bit(d);
  return v;
}

/* a flag, then bits of magnitude and a sign (vp8_rac_get_sint) */
static int get_sint(vp8_t *d, int bits) {
  if (!get_bit(d)) return 0;
  int v = get_uint(d, bits);
  return get_bit(d) ? -v : v;
}

static int get_tree(vp8_t *d, const int8_t *tree, const uint8_t *probs) {
  int i = 0;
  while ((i = tree[i + get_p(d, probs[i >> 1])]) > 0) {
  }
  return -i;
}

static void free_frames(vp8_t *d) {
  for (int i = 0; i < 4; ++i) {
    free(d->buf[i].y);
    d->buf[i].y = NULL;
  }
  free(d->mbs);
  free(d->top_nnz);
  free(d->top_bmodes);
  d->mbs = NULL;
  d->top_nnz = NULL;
  d->top_bmodes = NULL;
}

static int alloc_frames(vp8_t *d, int width, int height) {
  free_frames(d);
  d->width = width;
  d->height = height;
  d->mbw = (width + 15) / 16;
  d->mbh = (height + 15) / 16;
  d->ys = d->mbw * 16;
  d->cs = d->mbw * 8;
  long yn = (long)d->ys * d->mbh * 16, cn = (long)d->cs * d->mbh * 8;
  for (int i = 0; i < 4; ++i) {
    uint8_t *p = (uint8_t *)calloc((size_t)(yn + 2 * cn), 1);
    if (!p) return VP8_NOMEM;
    d->buf[i].y = p;
    d->buf[i].u = p + yn;
    d->buf[i].v = p + yn + cn;
  }
  d->mbs = (mb_t *)calloc((size_t)(d->mbh + 1) * (d->mbw + 1), sizeof(mb_t));
  d->top_nnz = (uint8_t(*)[9])calloc((size_t)d->mbw, 9);
  d->top_bmodes = (uint8_t *)calloc((size_t)d->mbw, 4);
  if (!d->mbs || !d->top_nnz || !d->top_bmodes) return VP8_NOMEM;
  for (int i = 0; i < 4; ++i) d->ref[i] = -1;
  return VP8_OK;
}

/* ---- the frame header ---- */

static void reset_probs(vp8_t *d) {
  memcpy(d->prob.token, default_coef_probs, sizeof d->prob.token);
  memcpy(d->prob.ymode, default_ymode_probs, 4);
  memcpy(d->prob.uvmode, default_uvmode_probs, 3);
  memcpy(d->prob.mv, default_mv_probs, sizeof d->prob.mv);
}

static int clip7(int q) { return q < 0 ? 0 : q > 127 ? 127 : q; }

static int decode_quants(vp8_t *d) {
  int q = get_uint(d, 7);
  int delta[5];
  for (int i = 0; i < 5; ++i) {
    delta[i] = get_sint(d, 4);
    if (delta[i]) d->count[C_QUANT_DELTA]++;
  }
  /* ydc, y2dc, y2ac, uvdc, uvac */
  d->qmul[1][0] = dc_qlookup[clip7(q + delta[0])];
  d->qmul[1][1] = ac_qlookup[clip7(q)];
  d->qmul[0][0] = (int16_t)(dc_qlookup[clip7(q + delta[1])] * 2);
  int y2ac = ac_qlookup[clip7(q + delta[2])] * 101581 >> 16;
  d->qmul[0][1] = (int16_t)(y2ac < 8 ? 8 : y2ac);
  int uvdc = dc_qlookup[clip7(q + delta[3])];
  d->qmul[2][0] = (int16_t)(uvdc > 132 ? 132 : uvdc);
  d->qmul[2][1] = ac_qlookup[clip7(q + delta[4])];
  return VP8_OK;
}

/* ref_to_update: REF_CURRENT (refresh), another reference to copy, or
 * -1 for none */
static int ref_update(vp8_t *d, int refresh, int which) {
  if (refresh) return REF_CURRENT;
  switch (get_uint(d, 2)) {
    case 1:
      return REF_LAST;
    case 2:
      return which == REF_GOLDEN ? REF_ALTREF : REF_GOLDEN;
  }
  return -1;
}

/* The header up to the macroblocks: the tag and what follows it.  On
 * success *update holds the golden and altref sources and whether the
 * last frame is refreshed. */
static int decode_header(vp8_t *d, const uint8_t *buf, long size,
                         int update[3]) {
  if (size < 3) return VP8_CORRUPT;
  d->key = !(buf[0] & 1);
  d->version = (buf[0] >> 1) & 7;
  d->show = (buf[0] >> 4) & 1;
  long first = (long)((buf[0] | (buf[1] << 8) | (buf[2] << 16)) >> 5);
  buf += 3;
  size -= 3;
  if (d->version > 3) return refuse(R_VERSION);
  if (first > size - 7 * d->key) return VP8_CORRUPT;
  int width = d->width, height = d->height;
  if (d->key) {
    if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a)
      return VP8_CORRUPT;
    width = (buf[3] | (buf[4] << 8)) & 0x3fff;
    height = (buf[5] | (buf[6] << 8)) & 0x3fff;
    if ((buf[4] >> 6) || (buf[6] >> 6)) d->count[C_SCALE_BITS]++;
    buf += 7;
    size -= 7;
    if (!width || !height) return VP8_CORRUPT;
  } else if (!d->mbs || d->ref[REF_LAST] < 0) {
    return VP8_CORRUPT; /* an inter frame before any key frame */
  }
  if (rac_init(&d->c, buf, first)) return VP8_CORRUPT;
  buf += first;
  size -= first;
  if (d->key) {
    update[0] = update[1] = REF_CURRENT;
    reset_probs(d);
    memset(d->lf_delta_ref, 0, sizeof d->lf_delta_ref);
    memset(d->lf_delta_mode, 0, sizeof d->lf_delta_mode);
    if (get_bit(d)) d->count[C_COLOR_SPACE]++;
    if (get_bit(d)) return refuse(R_CLAMPING);
  }
  if (get_bit(d)) return refuse(R_SEGMENTATION);
  d->filter_simple = get_bit(d);
  d->filter_level = get_uint(d, 6);
  d->sharpness = get_uint(d, 3);
  if ((d->lf_delta_on = get_bit(d)) && get_bit(d)) {
    d->count[C_LF_DELTA_UPDATE]++;
    for (int i = 0; i < 4; ++i)
      if (get_bit(d)) {
        d->lf_delta_ref[i] = get_uint(d, 6);
        if (get_bit(d)) d->lf_delta_ref[i] = -d->lf_delta_ref[i];
      }
    for (int i = 0; i < 4; ++i)
      if (get_bit(d)) {
        d->lf_delta_mode[i] = get_uint(d, 6);
        if (get_bit(d)) d->lf_delta_mode[i] = -d->lf_delta_mode[i];
      }
  }
  /* setup_partitions */
  d->nparts = 1 << get_uint(d, 2);
  const uint8_t *sizes = buf;
  buf += 3 * (d->nparts - 1);
  size -= 3 * (d->nparts - 1);
  if (size < 0) return VP8_CORRUPT;
  for (int i = 0; i < d->nparts - 1; ++i) {
    long psize = sizes[3 * i] | (sizes[3 * i + 1] << 8) |
                 ((long)sizes[3 * i + 2] << 16);
    if (size - psize < 0 || rac_init(&d->parts[i], buf, psize))
      return VP8_CORRUPT;
    buf += psize;
    size -= psize;
  }
  if (rac_init(&d->parts[d->nparts - 1], buf, size)) return VP8_CORRUPT;
  if (d->nparts > 1) d->count[C_PARTITIONS]++;
  if (d->key) {
    if (d->mbs && (width != d->width || height != d->height))
      return refuse(R_RESIZE);
    if (!d->mbs && alloc_frames(d, width, height)) return VP8_NOMEM;
  }
  decode_quants(d);
  if (!d->key) {
    int refresh_golden = get_bit(d), refresh_altref = get_bit(d);
    update[0] = ref_update(d, refresh_golden, REF_GOLDEN);
    update[1] = ref_update(d, refresh_altref, REF_ALTREF);
    d->sign_bias[REF_GOLDEN] = get_bit(d);
    d->sign_bias[REF_ALTREF] = get_bit(d);
  } else {
    d->sign_bias[REF_GOLDEN] = d->sign_bias[REF_ALTREF] = 0;
  }
  if (!(d->refresh_probs = get_bit(d))) {
    d->saved = d->prob;
    d->count[C_KEEP_PROBS]++;
  }
  update[2] = d->key || get_bit(d);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 8; ++j)
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 11; ++l)
          if (get_p(d, coef_update_probs[i][j][k][l])) {
            d->prob.token[i][j][k][l] = (uint8_t)get_uint(d, 8);
            d->count[C_COEF_PROB_UPDATE]++;
          }
  if ((d->mb_skip_on = get_bit(d)))
    d->prob_skip = get_uint(d, 8);
  else
    d->count[C_NO_SKIP_FLAG]++;
  if (!d->key) {
    d->prob_intra = get_uint(d, 8);
    d->prob_last = get_uint(d, 8);
    d->prob_golden = get_uint(d, 8);
    if (get_bit(d)) {
      d->count[C_YMODE_PROB_UPDATE]++;
      for (int i = 0; i < 4; ++i) d->prob.ymode[i] = (uint8_t)get_uint(d, 8);
    }
    if (get_bit(d)) {
      d->count[C_UVMODE_PROB_UPDATE]++;
      for (int i = 0; i < 3; ++i)
        d->prob.uvmode[i] = (uint8_t)get_uint(d, 8);
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 19; ++j)
        if (get_p(d, mv_update_probs[i][j])) {
          int v = get_uint(d, 7) << 1;
          d->prob.mv[i][j] = (uint8_t)(v ? v : 1);
          d->count[C_MV_PROB_UPDATE]++;
        }
  }
  return VP8_OK;
}

/* ---- modes ---- */

static int read_mv_component(vp8_t *d, const uint8_t *p) {
  int x = 0;
  if (get_p(d, p[0])) {
    d->count[C_MV_LONG]++;
    for (int i = 0; i < 3; ++i) x += get_p(d, p[9 + i]) << i;
    for (int i = 9; i > 3; --i) x += get_p(d, p[9 + i]) << i;
    if (!(x & 0xFFF0) || get_p(d, p[12])) x += 8;
  } else {
    d->count[C_MV_SHORT]++;
    const uint8_t *ps = p + 2;
    int bit = get_p(d, *ps);
    ps += 1 + 3 * bit;
    x += 4 * bit;
    bit = get_p(d, *ps);
    ps += 1 + bit;
    x += 2 * bit;
    x += get_p(d, *ps);
  }
  return (x && get_p(d, p[1])) ? -x : x;
}

static inline uint32_t mv_word(mv_t m) {
  return (uint16_t)m.x | ((uint32_t)(uint16_t)m.y << 16);
}

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

static mv_t clamp_mv(vp8_t *d, mv_t m, int mb_x, int mb_y) {
  /* MARGIN 16 pixels past the frame, in quarter pixels */
  mv_t o;
  o.x = (int16_t)clampi(m.x, -64 - 64 * mb_x, 64 * (d->mbw - 1 - mb_x) + 64);
  o.y = (int16_t)clampi(m.y, -64 - 64 * mb_y, 64 * (d->mbh - 1 - mb_y) + 64);
  if (o.x != m.x || o.y != m.y) d->count[C_MV_CLAMPED]++;
  return o;
}

static int decode_splitmvs(vp8_t *d, mb_t *mb, const mb_t *left,
                           const mb_t *top) {
  int part;
  if (get_p(d, mbsplit_probs[0])) {
    if (get_p(d, mbsplit_probs[1]))
      part = P_16X8 + get_p(d, mbsplit_probs[2]);
    else
      part = P_8X8;
  } else {
    part = P_4X4;
  }
  d->count[C_SPLIT_16X8 + part]++;
  mb->part = (uint8_t)part;
  int num = mbsplit_count[part];
  for (int n = 0; n < num; ++n) {
    int k = mbfirstidx[part][n];
    mv_t l = (k & 3) ? mb->bmv[mbsplits[part][k - 1]]
                     : left->bmv[mbsplits[left->part][k + 3]];
    mv_t a = k > 3 ? mb->bmv[mbsplits[part][k - 4]]
                   : top->bmv[mbsplits[top->part][k + 12]];
    uint32_t lw = mv_word(l), aw = mv_word(a);
    const uint8_t *p = lw == aw ? submv_probs[4 - !!lw]
                       : !aw    ? submv_probs[2]
                                : submv_probs[1 - !!lw];
    if (get_p(d, p[0])) {
      if (get_p(d, p[1])) {
        if (get_p(d, p[2])) {
          d->count[C_SUB_NEW]++;
          int dy = read_mv_component(d, d->prob.mv[0]);
          int dx = read_mv_component(d, d->prob.mv[1]);
          mb->bmv[n].y = (int16_t)(mb->mv.y + dy);
          mb->bmv[n].x = (int16_t)(mb->mv.x + dx);
        } else {
          d->count[C_SUB_ZERO]++;
          mb->bmv[n].x = mb->bmv[n].y = 0;
        }
      } else {
        d->count[C_SUB_ABOVE]++;
        mb->bmv[n] = a;
      }
    } else {
      d->count[C_SUB_LEFT]++;
      mb->bmv[n] = l;
    }
  }
  return num;
}

static void decode_mvs(vp8_t *d, mb_t *mb, int mb_x, int mb_y) {
  const mb_t *edge[3] = {mb - (d->mbw + 1), mb - 1, mb - (d->mbw + 2)};
  mv_t near[4] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
  int cnt[4] = {0, 0, 0, 0}, idx = 0;
  int bias = d->sign_bias[mb->ref];
  for (int n = 0; n < 3; ++n) {
    const mb_t *e = edge[n];
    if (e->ref == REF_CURRENT) continue;
    mv_t m = e->mv;
    if (m.x || m.y) {
      if (bias != d->sign_bias[e->ref]) {
        m.x = (int16_t)-m.x;
        m.y = (int16_t)-m.y;
      }
      if (!n || mv_word(m) != mv_word(near[idx])) near[++idx] = m;
      cnt[idx] += 1 + (n != 2);
    } else {
      cnt[0] += 1 + (n != 2);
    }
  }
  mb->part = P_NONE;
  if (get_p(d, mode_contexts[cnt[0]][0])) {
    if (cnt[3] && mv_word(near[1]) == mv_word(near[3])) cnt[1] += 1;
    if (cnt[2] > cnt[1]) {
      int t = cnt[1];
      cnt[1] = cnt[2];
      cnt[2] = t;
      mv_t tm = near[1];
      near[1] = near[2];
      near[2] = tm;
    }
    if (get_p(d, mode_contexts[cnt[1]][1])) {
      if (get_p(d, mode_contexts[cnt[2]][2])) {
        mb->mv = clamp_mv(d, near[cnt[1] >= cnt[0]], mb_x, mb_y);
        int splits = ((edge[1]->mode == M_SPLIT) + (edge[0]->mode == M_SPLIT))
                     * 2 + (edge[2]->mode == M_SPLIT);
        if (get_p(d, mode_contexts[splits][3])) {
          d->count[C_SPLITMV]++;
          mb->mode = M_SPLIT;
          mb->mv = mb->bmv[decode_splitmvs(d, mb, edge[1], edge[0]) - 1];
        } else {
          d->count[C_NEWMV]++;
          mb->mode = M_NEW;
          mb->mv.y = (int16_t)(mb->mv.y + read_mv_component(d, d->prob.mv[0]));
          mb->mv.x = (int16_t)(mb->mv.x + read_mv_component(d, d->prob.mv[1]));
          mb->bmv[0] = mb->mv;
        }
      } else {
        d->count[C_NEARMV]++;
        mb->mode = M_NEAR;
        mb->mv = clamp_mv(d, near[2], mb_x, mb_y);
        mb->bmv[0] = mb->mv;
      }
    } else {
      d->count[C_NEARESTMV]++;
      mb->mode = M_NEAREST;
      mb->mv = clamp_mv(d, near[1], mb_x, mb_y);
      mb->bmv[0] = mb->mv;
    }
  } else {
    d->count[C_ZEROMV]++;
    mb->mode = M_ZERO;
    mb->mv.x = mb->mv.y = 0;
    mb->bmv[0] = mb->mv;
  }
}

static void decode_mb_mode(vp8_t *d, mb_t *mb, int mb_x, int mb_y,
                           uint8_t *left_bmodes) {
  mb->skip = d->mb_skip_on ? (uint8_t)get_p(d, d->prob_skip) : 0;
  if (d->key) {
    mb->mode = (uint8_t)get_tree(d, kf_ymode_tree, kf_ymode_probs);
    uint8_t *top = d->top_bmodes + 4 * mb_x;
    if (mb->mode == M_BPRED) {
      d->count[C_KF_BPRED]++;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int m = get_tree(d, bmode_tree,
                           kf_bmode_probs[top[x]][left_bmodes[y]]);
          mb->bmodes[4 * y + x] = (uint8_t)m;
          top[x] = left_bmodes[y] = (uint8_t)m;
        }
    } else {
      d->count[C_KF_I16]++;
      memset(top, implied_bmode[mb->mode], 4);
      memset(left_bmodes, implied_bmode[mb->mode], 4);
    }
    mb->uvmode = (uint8_t)get_tree(d, uvmode_tree, kf_uvmode_probs);
    mb->ref = REF_CURRENT;
  } else if (get_p(d, d->prob_intra)) {
    if (get_p(d, d->prob_last))
      mb->ref = get_p(d, d->prob_golden) ? REF_ALTREF : REF_GOLDEN;
    else
      mb->ref = REF_LAST;
    d->count[C_REF_LAST + mb->ref - 1]++;
    decode_mvs(d, mb, mb_x, mb_y);
  } else {
    mb->mode = (uint8_t)get_tree(d, ymode_tree, d->prob.ymode);
    if (mb->mode == M_BPRED) {
      d->count[C_INTER_BPRED]++;
      for (int i = 0; i < 16; ++i)
        mb->bmodes[i] = (uint8_t)get_tree(d, bmode_tree, bmode_probs);
    } else {
      d->count[C_INTER_I16]++;
    }
    mb->uvmode = (uint8_t)get_tree(d, uvmode_tree, d->prob.uvmode);
    mb->ref = REF_CURRENT;
    mb->part = P_NONE;
    mb->bmv[0].x = mb->bmv[0].y = 0;
  }
  if (mb->ref == REF_CURRENT) {
    if (mb->mode == M_BPRED)
      for (int i = 0; i < 16; ++i) d->count[C_B_DC + mb->bmodes[i]]++;
    else
      d->count[C_I16_DC + mb->mode]++;
    d->count[C_UV_DC + mb->uvmode]++;
  }
}

/* ---- tokens ---- */

/* the coefficients of one block from position i on, dequantised by qmul
 * (DC, AC); the position after the last token, as FFmpeg returns it */
static int decode_block(vp8_t *d, rac_t *c, int16_t *block, int type,
                        int i, int ctx, const int16_t *qmul) {
  uint8_t (*probs)[3][11] = d->prob.token[type];
  const uint8_t *p = probs[coef_bands[i]][ctx];
  if (!get_t(d, c, p[0])) return 0;
  for (;;) {
    int coeff;
    if (!get_t(d, c, p[1])) { /* DCT_0 */
      if (++i == 16) break;
      p = probs[coef_bands[i]][0];
      continue;
    }
    if (!get_t(d, c, p[2])) {
      coeff = 1;
      p = probs[coef_bands[i + 1]][1];
    } else {
      if (!get_t(d, c, p[3])) {
        coeff = get_t(d, c, p[4]);
        if (coeff) coeff += get_t(d, c, p[5]);
        coeff += 2;
      } else if (!get_t(d, c, p[6])) {
        if (!get_t(d, c, p[7])) {
          d->count[C_TOKEN_CAT1]++;
          coeff = 5 + get_t(d, c, 159);
        } else {
          d->count[C_TOKEN_CAT2]++;
          coeff = 7 + (get_t(d, c, 165) << 1);
          coeff += get_t(d, c, 145);
        }
      } else {
        int a = get_t(d, c, p[8]);
        int b = get_t(d, c, p[9 + a]);
        int cat = (a << 1) + b;
        d->count[C_TOKEN_CAT3 + cat]++;
        coeff = 3 + (8 << cat);
        int v = 0;
        for (const uint8_t *q = cat_probs[cat]; *q; ++q)
          v = (v << 1) + get_t(d, c, *q);
        coeff += v;
      }
      p = probs[coef_bands[i + 1]][2];
    }
    block[zigzag[i]] =
        (int16_t)((get_t(d, c, 128) ? -coeff : coeff) * qmul[!!i]);
    if (++i == 16) break;
    if (!get_t(d, c, p[0])) break; /* DCT_EOB */
  }
  return i;
}

/* ---- transforms (vp8dsp.c) ---- */

#define MUL_20091(a) ((((a) * 20091) >> 16) + (a))
#define MUL_35468(a) (((a) * 35468) >> 16)

static void luma_dc_wht(int16_t block[16][16], int16_t dc[16]) {
  int t0, t1, t2, t3;
  for (int i = 0; i < 4; ++i) {
    t0 = dc[0 * 4 + i] + dc[3 * 4 + i];
    t1 = dc[1 * 4 + i] + dc[2 * 4 + i];
    t2 = dc[1 * 4 + i] - dc[2 * 4 + i];
    t3 = dc[0 * 4 + i] - dc[3 * 4 + i];
    dc[0 * 4 + i] = (int16_t)(t0 + t1);
    dc[1 * 4 + i] = (int16_t)(t3 + t2);
    dc[2 * 4 + i] = (int16_t)(t0 - t1);
    dc[3 * 4 + i] = (int16_t)(t3 - t2);
  }
  for (int i = 0; i < 4; ++i) {
    t0 = dc[i * 4 + 0] + dc[i * 4 + 3] + 3;
    t1 = dc[i * 4 + 1] + dc[i * 4 + 2];
    t2 = dc[i * 4 + 1] - dc[i * 4 + 2];
    t3 = dc[i * 4 + 0] - dc[i * 4 + 3] + 3;
    memset(dc + 4 * i, 0, 4 * sizeof *dc);
    block[4 * i + 0][0] = (int16_t)((t0 + t1) >> 3);
    block[4 * i + 1][0] = (int16_t)((t3 + t2) >> 3);
    block[4 * i + 2][0] = (int16_t)((t0 - t1) >> 3);
    block[4 * i + 3][0] = (int16_t)((t3 - t2) >> 3);
  }
}

static void luma_dc_wht_dc(int16_t block[16][16], int16_t dc[16]) {
  int16_t v = (int16_t)((dc[0] + 3) >> 3);
  dc[0] = 0;
  for (int i = 0; i < 16; ++i) block[i][0] = v;
}

static void idct_add(uint8_t *dst, int16_t *block, long stride) {
  int t0, t1, t2, t3;
  int16_t tmp[16];
  for (int i = 0; i < 4; ++i) {
    t0 = block[0 * 4 + i] + block[2 * 4 + i];
    t1 = block[0 * 4 + i] - block[2 * 4 + i];
    t2 = MUL_35468(block[1 * 4 + i]) - MUL_20091(block[3 * 4 + i]);
    t3 = MUL_20091(block[1 * 4 + i]) + MUL_35468(block[3 * 4 + i]);
    tmp[i * 4 + 0] = (int16_t)(t0 + t3);
    tmp[i * 4 + 1] = (int16_t)(t1 + t2);
    tmp[i * 4 + 2] = (int16_t)(t1 - t2);
    tmp[i * 4 + 3] = (int16_t)(t0 - t3);
  }
  memset(block, 0, 16 * sizeof *block);
  for (int i = 0; i < 4; ++i) {
    t0 = tmp[0 * 4 + i] + tmp[2 * 4 + i];
    t1 = tmp[0 * 4 + i] - tmp[2 * 4 + i];
    t2 = MUL_35468(tmp[1 * 4 + i]) - MUL_20091(tmp[3 * 4 + i]);
    t3 = MUL_20091(tmp[1 * 4 + i]) + MUL_35468(tmp[3 * 4 + i]);
    dst[0] = clip_u8(dst[0] + ((t0 + t3 + 4) >> 3));
    dst[1] = clip_u8(dst[1] + ((t1 + t2 + 4) >> 3));
    dst[2] = clip_u8(dst[2] + ((t1 - t2 + 4) >> 3));
    dst[3] = clip_u8(dst[3] + ((t0 - t3 + 4) >> 3));
    dst += stride;
  }
}

static void idct_dc_add(uint8_t *dst, int16_t *block, long stride) {
  int dc = (block[0] + 4) >> 3;
  block[0] = 0;
  for (int y = 0; y < 4; ++y, dst += stride)
    for (int x = 0; x < 4; ++x) dst[x] = clip_u8(dst[x] + dc);
}

/* one block by its non-zero count (idct_mb's rule: 1 is DC only) */
static void idct_block(vp8_t *d, uint8_t *dst, int16_t *block, int nnz,
                       long stride) {
  if (nnz == 1) {
    d->count[C_IDCT_DC]++;
    idct_dc_add(dst, block, stride);
  } else if (nnz > 1) {
    d->count[C_IDCT]++;
    idct_add(dst, block, stride);
  }
}

/* ---- intra prediction ---- */

static inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }
static inline uint8_t avg3(int a, int b, int c) {
  return (uint8_t)((a + 2 * b + c + 2) >> 2);
}

/* a 16x16 or 8x8 block (n) from above[-1..n-1] and left[0..n-1];
 * have_above / have_left pick the DC form */
static void predict_block(uint8_t *dst, long stride, int n, int mode,
                          const uint8_t *above, const uint8_t *left,
                          int have_above, int have_left) {
  int shift = n == 16 ? 4 : 3;
  if (mode == 0) { /* DC */
    int v = 0;
    if (have_above && have_left) {
      for (int i = 0; i < n; ++i) v += above[i] + left[i];
      v = (v + n) >> (shift + 1);
    } else if (have_above || have_left) {
      const uint8_t *e = have_above ? above : left;
      for (int i = 0; i < n; ++i) v += e[i];
      v = (v + (n >> 1)) >> shift;
    } else {
      v = 128;
    }
    for (int y = 0; y < n; ++y) memset(dst + y * stride, v, (size_t)n);
  } else if (mode == 1) { /* V */
    for (int y = 0; y < n; ++y) memcpy(dst + y * stride, above, (size_t)n);
  } else if (mode == 2) { /* H */
    for (int y = 0; y < n; ++y) memset(dst + y * stride, left[y], (size_t)n);
  } else { /* TM */
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x)
        dst[y * stride + x] = clip_u8(left[y] + above[x] - above[-1]);
  }
}

/* a 4x4 sub-block: A = above[-1..7] (A[-1] the corner), L = left[0..3] */
static void predict_sub(uint8_t *dst, long stride, int mode, const uint8_t *A,
                        const uint8_t *L) {
  uint8_t B[4][4];
  int P = A[-1];
  int E[9] = {L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]};
  switch (mode) {
    case 0: { /* B_DC_PRED */
      int v = 4;
      for (int i = 0; i < 4; ++i) v += A[i] + L[i];
      memset(B, v >> 3, sizeof B);
      break;
    }
    case 1: /* B_TM_PRED */
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) B[r][c] = clip_u8(L[r] + A[c] - P);
      break;
    case 2: /* B_VE_PRED */
      for (int c = 0; c < 4; ++c)
        B[0][c] = B[1][c] = B[2][c] = B[3][c] = avg3(A[c - 1], A[c], A[c + 1]);
      break;
    case 3: { /* B_HE_PRED */
      uint8_t v[4] = {avg3(P, L[0], L[1]), avg3(L[0], L[1], L[2]),
                      avg3(L[1], L[2], L[3]), avg3(L[2], L[3], L[3])};
      for (int r = 0; r < 4; ++r) memset(B[r], v[r], 4);
      break;
    }
    case 4: /* B_LD_PRED */
      B[0][0] = avg3(A[0], A[1], A[2]);
      B[0][1] = B[1][0] = avg3(A[1], A[2], A[3]);
      B[0][2] = B[1][1] = B[2][0] = avg3(A[2], A[3], A[4]);
      B[0][3] = B[1][2] = B[2][1] = B[3][0] = avg3(A[3], A[4], A[5]);
      B[1][3] = B[2][2] = B[3][1] = avg3(A[4], A[5], A[6]);
      B[2][3] = B[3][2] = avg3(A[5], A[6], A[7]);
      B[3][3] = avg3(A[6], A[7], A[7]);
      break;
    case 5: /* B_RD_PRED */
      B[3][0] = avg3(E[0], E[1], E[2]);
      B[3][1] = B[2][0] = avg3(E[1], E[2], E[3]);
      B[3][2] = B[2][1] = B[1][0] = avg3(E[2], E[3], E[4]);
      B[3][3] = B[2][2] = B[1][1] = B[0][0] = avg3(E[3], E[4], E[5]);
      B[2][3] = B[1][2] = B[0][1] = avg3(E[4], E[5], E[6]);
      B[1][3] = B[0][2] = avg3(E[5], E[6], E[7]);
      B[0][3] = avg3(E[6], E[7], E[8]);
      break;
    case 6: /* B_VR_PRED */
      B[3][0] = avg3(E[1], E[2], E[3]);
      B[2][0] = avg3(E[2], E[3], E[4]);
      B[3][1] = B[1][0] = avg3(E[3], E[4], E[5]);
      B[2][1] = B[0][0] = avg2(E[4], E[5]);
      B[3][2] = B[1][1] = avg3(E[4], E[5], E[6]);
      B[2][2] = B[0][1] = avg2(E[5], E[6]);
      B[3][3] = B[1][2] = avg3(E[5], E[6], E[7]);
      B[2][3] = B[0][2] = avg2(E[6], E[7]);
      B[1][3] = avg3(E[6], E[7], E[8]);
      B[0][3] = avg2(E[7], E[8]);
      break;
    case 7: /* B_VL_PRED */
      B[0][0] = avg2(A[0], A[1]);
      B[1][0] = avg3(A[0], A[1], A[2]);
      B[2][0] = B[0][1] = avg2(A[1], A[2]);
      B[1][1] = B[3][0] = avg3(A[1], A[2], A[3]);
      B[2][1] = B[0][2] = avg2(A[2], A[3]);
      B[3][1] = B[1][2] = avg3(A[2], A[3], A[4]);
      B[2][2] = B[0][3] = avg2(A[3], A[4]);
      B[3][2] = B[1][3] = avg3(A[3], A[4], A[5]);
      B[2][3] = avg3(A[4], A[5], A[6]);
      B[3][3] = avg3(A[5], A[6], A[7]);
      break;
    case 8: /* B_HD_PRED */
      B[3][0] = avg2(E[0], E[1]);
      B[3][1] = avg3(E[0], E[1], E[2]);
      B[2][0] = B[3][2] = avg2(E[1], E[2]);
      B[2][1] = B[3][3] = avg3(E[1], E[2], E[3]);
      B[2][2] = B[1][0] = avg2(E[2], E[3]);
      B[2][3] = B[1][1] = avg3(E[2], E[3], E[4]);
      B[1][2] = B[0][0] = avg2(E[3], E[4]);
      B[1][3] = B[0][1] = avg3(E[3], E[4], E[5]);
      B[0][2] = avg3(E[4], E[5], E[6]);
      B[0][3] = avg3(E[5], E[6], E[7]);
      break;
    default: /* B_HU_PRED */
      B[0][0] = avg2(L[0], L[1]);
      B[0][1] = avg3(L[0], L[1], L[2]);
      B[0][2] = B[1][0] = avg2(L[1], L[2]);
      B[0][3] = B[1][1] = avg3(L[1], L[2], L[3]);
      B[1][2] = B[2][0] = avg2(L[2], L[3]);
      B[1][3] = B[2][1] = avg3(L[2], L[3], L[3]);
      B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] =
          (uint8_t)L[3];
      break;
  }
  for (int r = 0; r < 4; ++r) memcpy(dst + r * stride, B[r], 4);
}

/* the edges of an n-wide block at (px, py) of a plane: above[-1..n+3]
 * (127 above the frame; the corner 129 left of it; past the plane's
 * right edge the last pixel repeated) and left[0..n-1] (129 left of the
 * frame) */
static void block_edges(const uint8_t *plane, long stride, int pw, int px,
                        int py, int n, uint8_t *above, uint8_t *left) {
  if (!py) {
    memset(above - 1, 127, (size_t)n + 5);
  } else {
    const uint8_t *row = plane + (py - 1) * stride;
    above[-1] = px ? row[px - 1] : 129;
    for (int i = 0; i < n + 4; ++i)
      above[i] = px + i < pw ? row[px + i] : row[pw - 1];
  }
  for (int i = 0; i < n; ++i)
    left[i] = px ? plane[(py + i) * stride + px - 1] : 129;
}

static void intra_predict(vp8_t *d, mb_t *mb, int mb_x, int mb_y,
                          frame_t *f, int16_t blocks[25][16],
                          uint8_t nnz[25]) {
  uint8_t above_buf[1 + 16 + 4], left[16];
  uint8_t *above = above_buf + 1;
  long ys = d->ys, cs = d->cs;
  uint8_t *dst = f->y + (long)mb_y * 16 * ys + mb_x * 16;
  block_edges(f->y, ys, d->ys, mb_x * 16, mb_y * 16, 16, above, left);
  if (mb->mode != M_BPRED) {
    predict_block(dst, ys, 16, mb->mode, above, left, mb_y > 0, mb_x > 0);
  } else {
    /* the right column's above-right: the MB row above's, at every row */
    uint8_t tr[4];
    memcpy(tr, above + 16, 4);
    if (mb_y && mb_x == d->mbw - 1) memset(tr, above[15], 4);
    for (int y = 0; y < 4; ++y)
      for (int x = 0; x < 4; ++x) {
        uint8_t a_buf[9], l[4];
        uint8_t *a = a_buf + 1;
        uint8_t *sub = dst + 4 * y * ys + 4 * x;
        if (!y) {
          memcpy(a - 1, above + 4 * x - 1, 9);
        } else {
          const uint8_t *row = sub - ys;
          a[-1] = x ? row[-1] : left[4 * y - 1];
          memcpy(a, row, x < 3 ? 8 : 4);
        }
        if (x == 3) memcpy(a + 4, tr, 4);
        for (int i = 0; i < 4; ++i)
          l[i] = x ? sub[i * ys - 1] : left[4 * y + i];
        predict_sub(sub, ys, mb->bmodes[4 * y + x], a, l);
        idct_block(d, sub, blocks[4 * y + x], nnz[4 * y + x], ys);
      }
  }
  for (int p = 0; p < 2; ++p) {
    uint8_t *plane = p ? f->v : f->u;
    uint8_t *cdst = plane + (long)mb_y * 8 * cs + mb_x * 8;
    block_edges(plane, cs, d->cs, mb_x * 8, mb_y * 8, 8, above, left);
    predict_block(cdst, cs, 8, mb->uvmode, above, left, mb_y > 0, mb_x > 0);
  }
}

/* ---- inter prediction ---- */

/* a bw x bh block of a plane at (x, y) whole pixels and (fx, fy) eighths,
 * its samples read at coordinates clamped to the plane (pw x ph) */
static void mc_block(vp8_t *d, uint8_t *dst, long ds, const uint8_t *ref,
                     long rs, int pw, int ph, int x, int y, int fx, int fy,
                     int bw, int bh) {
  uint8_t win[21 * 21], tmp[21 * 16];
  const uint8_t *src;
  long ss;
  if (x - 2 >= 0 && y - 2 >= 0 && x + bw + 3 <= pw && y + bh + 3 <= ph) {
    src = ref + (long)(y - 2) * rs + (x - 2);
    ss = rs;
  } else {
    if (x - (fx ? 2 : 0) < 0 || y - (fy ? 2 : 0) < 0 ||
        x + bw + (fx ? 3 : 0) > pw || y + bh + (fy ? 3 : 0) > ph)
      d->count[C_MC_EDGE]++;
    for (int r = 0; r < bh + 5; ++r)
      for (int c = 0; c < bw + 5; ++c)
        win[r * 21 + c] = ref[(long)clampi(y - 2 + r, 0, ph - 1) * rs +
                              clampi(x - 2 + c, 0, pw - 1)];
    src = win;
    ss = 21;
  }
  src += 2 * ss + 2;
  int bilinear = d->version != 0;
  if (!fx && !fy) {
    d->count[C_MC_FULL]++;
    for (int r = 0; r < bh; ++r) memcpy(dst + r * ds, src + r * ss, (size_t)bw);
    return;
  }
  d->count[fx && fy ? C_MC_HV : fx ? C_MC_H : C_MC_V]++;
  /* horizontal pass over the rows the vertical one needs */
  int r0 = fy ? (bilinear ? 0 : -2) : 0, r1 = fy ? bh + (bilinear ? 1 : 3) : bh;
  for (int r = r0; r < r1; ++r) {
    const uint8_t *s = src + r * ss;
    uint8_t *t = tmp + (r + 2) * 16;
    for (int c = 0; c < bw; ++c) {
      if (!fx) {
        t[c] = s[c];
      } else if (bilinear) {
        t[c] = (uint8_t)(((8 - fx) * s[c] + fx * s[c + 1] + 4) >> 3);
      } else {
        const uint8_t *F = subpel_filters[fx - 1];
        t[c] = clip_u8((F[2] * s[c] - F[1] * s[c - 1] + F[0] * s[c - 2] +
                        F[3] * s[c + 1] - F[4] * s[c + 2] + F[5] * s[c + 3] +
                        64) >> 7);
      }
    }
  }
  for (int r = 0; r < bh; ++r) {
    const uint8_t *t = tmp + (r + 2) * 16;
    for (int c = 0; c < bw; ++c) {
      if (!fy) {
        dst[r * ds + c] = t[c];
      } else if (bilinear) {
        dst[r * ds + c] =
            (uint8_t)(((8 - fy) * t[c] + fy * t[c + 16] + 4) >> 3);
      } else {
        const uint8_t *F = subpel_filters[fy - 1];
        dst[r * ds + c] =
            clip_u8((F[2] * t[c] - F[1] * t[c - 16] + F[0] * t[c - 32] +
                     F[3] * t[c + 16] - F[4] * t[c + 32] + F[5] * t[c + 48] +
                     64) >> 7);
      }
    }
  }
}

/* luma: a block at (x, y) with a quarter-pixel MV */
static void mc_luma(vp8_t *d, frame_t *cur, const frame_t *ref, int x, int y,
                    int bw, int bh, mv_t mv) {
  mc_block(d, cur->y + (long)y * d->ys + x, d->ys, ref->y, d->ys, d->ys,
           d->mbh * 16, x + (mv.x >> 2), y + (mv.y >> 2), (mv.x * 2) & 7,
           (mv.y * 2) & 7, bw, bh);
}

/* chroma: a block at (x, y) with an eighth-pixel MV */
static void mc_chroma(vp8_t *d, frame_t *cur, const frame_t *ref, int x,
                      int y, int bw, int bh, mv_t mv) {
  if (d->version == 3) {
    mv.x = (int16_t)(mv.x & ~7);
    mv.y = (int16_t)(mv.y & ~7);
    d->count[C_FULL_PIXEL]++;
  }
  for (int p = 0; p < 2; ++p) {
    uint8_t *plane = p ? cur->v : cur->u;
    const uint8_t *rp = p ? ref->v : ref->u;
    mc_block(d, plane + (long)y * d->cs + x, d->cs, rp, d->cs, d->cs,
             d->mbh * 8, x + (mv.x >> 3), y + (mv.y >> 3), mv.x & 7,
             mv.y & 7, bw, bh);
  }
}

static void inter_predict(vp8_t *d, mb_t *mb, int mb_x, int mb_y,
                          frame_t *cur) {
  const frame_t *ref = &d->buf[d->ref[mb->ref]];
  int x = mb_x * 16, y = mb_y * 16;
  const mv_t *b = mb->bmv;
  switch (mb->part) {
    case P_NONE:
      mc_luma(d, cur, ref, x, y, 16, 16, mb->mv);
      mc_chroma(d, cur, ref, x / 2, y / 2, 8, 8, mb->mv);
      break;
    case P_4X4:
      for (int by = 0; by < 4; ++by)
        for (int bx = 0; bx < 4; ++bx)
          mc_luma(d, cur, ref, x + 4 * bx, y + 4 * by, 4, 4, b[4 * by + bx]);
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          int k = 8 * by + 2 * bx;
          int sx = b[k].x + b[k + 1].x + b[k + 4].x + b[k + 5].x;
          int sy = b[k].y + b[k + 1].y + b[k + 4].y + b[k + 5].y;
          mv_t uv = {(int16_t)((sx + 2 + (sx >> 31)) >> 2),
                     (int16_t)((sy + 2 + (sy >> 31)) >> 2)};
          mc_chroma(d, cur, ref, x / 2 + 4 * bx, y / 2 + 4 * by, 4, 4, uv);
        }
      break;
    default: {
      /* 16x8, 8x16, 8x8: each partition as its own block, chroma with its
       * MV (the mean of four equal MVs) */
      static const uint8_t geom[3][4][4] = {
          {{0, 0, 16, 8}, {0, 8, 16, 8}},
          {{0, 0, 8, 16}, {8, 0, 8, 16}},
          {{0, 0, 8, 8}, {8, 0, 8, 8}, {0, 8, 8, 8}, {8, 8, 8, 8}}};
      for (int n = 0; n < mbsplit_count[mb->part]; ++n) {
        const uint8_t *g = geom[mb->part][n];
        mc_luma(d, cur, ref, x + g[0], y + g[1], g[2], g[3], b[n]);
        mc_chroma(d, cur, ref, (x + g[0]) / 2, (y + g[1]) / 2, g[2] / 2,
                  g[3] / 2, b[n]);
      }
    }
  }
}

/* ---- the loop filter (vp8dsp.c) ---- */

static inline int clip_int8(int v) {
  return v < -128 ? -128 : v > 127 ? 127 : v;
}

#define LOAD                                                              \
  int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];         \
  int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];                 \
  (void)p3;                                                               \
  (void)p2;                                                               \
  (void)q2;                                                               \
  (void)q3

static inline void filter_common(uint8_t *p, long s, int is4tap) {
  LOAD;
  int a = 3 * (q0 - p0);
  if (is4tap) a += clip_int8(p1 - q1);
  a = clip_int8(a);
  int f1 = (a + 4 > 127 ? 127 : a + 4) >> 3;
  int f2 = (a + 3 > 127 ? 127 : a + 3) >> 3;
  p[-s] = clip_u8(p0 + f2);
  p[0] = clip_u8(q0 - f1);
  if (!is4tap) {
    a = (f1 + 1) >> 1;
    p[-2 * s] = clip_u8(p1 + a);
    p[s] = clip_u8(q1 - a);
  }
}

static inline int simple_limit(const uint8_t *p, long s, int flim) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  return 2 * abs(p0 - q0) + (abs(p1 - q1) >> 1) <= flim;
}

static inline int normal_limit(const uint8_t *p, long s, int E, int I) {
  LOAD;
  return simple_limit(p, s, E) && abs(p3 - p2) <= I && abs(p2 - p1) <= I &&
         abs(p1 - p0) <= I && abs(q3 - q2) <= I && abs(q2 - q1) <= I &&
         abs(q1 - q0) <= I;
}

static inline int hev(const uint8_t *p, long s, int thresh) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static inline void filter_mbedge(uint8_t *p, long s) {
  LOAD;
  int w = clip_int8(p1 - q1);
  w = clip_int8(w + 3 * (q0 - p0));
  int a0 = (27 * w + 63) >> 7, a1 = (18 * w + 63) >> 7, a2 = (9 * w + 63) >> 7;
  p[-3 * s] = clip_u8(p2 + a2);
  p[-2 * s] = clip_u8(p1 + a1);
  p[-s] = clip_u8(p0 + a0);
  p[0] = clip_u8(q0 - a0);
  p[s] = clip_u8(q1 - a1);
  p[2 * s] = clip_u8(q2 - a2);
}

/* n pixels along an edge: `along` steps between them, `across` across
 * the edge; mb picks the MB-edge filter, else the inner one */
static void filter_edge(vp8_t *d, uint8_t *p, long along, long across, int n,
                        int E, int I, int thresh, int mb) {
  for (int i = 0; i < n; ++i, p += along) {
    if (!normal_limit(p, across, E, I)) continue;
    if (hev(p, across, thresh)) {
      d->count[C_LF_HEV]++;
      filter_common(p, across, 1);
    } else if (mb) {
      filter_mbedge(p, across);
    } else {
      filter_common(p, across, 0);
    }
  }
}

static void filter_simple(uint8_t *p, long along, long across, int flim) {
  for (int i = 0; i < 16; ++i, p += along)
    if (simple_limit(p, across, flim)) filter_common(p, across, 1);
}

static void loop_filter(vp8_t *d, frame_t *f) {
  long ys = d->ys, cs = d->cs;
  for (int mb_y = 0; mb_y < d->mbh; ++mb_y)
    for (int mb_x = 0; mb_x < d->mbw; ++mb_x) {
      const mb_t *mb = &d->mbs[(mb_y + 1) * (d->mbw + 1) + mb_x + 1];
      int level = mb->level, I = mb->inner_limit;
      if (!level) continue;
      int bedge = 2 * level + I, mbedge = bedge + 4;
      uint8_t *y = f->y + (long)mb_y * 16 * ys + mb_x * 16;
      if (d->filter_simple) {
        if (mb_x) filter_simple(y, ys, 1, mbedge);
        if (mb->inner)
          for (int i = 4; i < 16; i += 4) filter_simple(y + i, ys, 1, bedge);
        if (mb_y) filter_simple(y, 1, ys, mbedge);
        if (mb->inner)
          for (int i = 4; i < 16; i += 4)
            filter_simple(y + i * ys, 1, ys, bedge);
        continue;
      }
      int thresh = hev_thresh_lut[d->key][level];
      uint8_t *u = f->u + (long)mb_y * 8 * cs + mb_x * 8;
      uint8_t *v = f->v + (long)mb_y * 8 * cs + mb_x * 8;
      if (mb_x) {
        d->count[C_LF_MB_EDGE]++;
        filter_edge(d, y, ys, 1, 16, mbedge, I, thresh, 1);
        filter_edge(d, u, cs, 1, 8, mbedge, I, thresh, 1);
        filter_edge(d, v, cs, 1, 8, mbedge, I, thresh, 1);
      }
      if (mb->inner) {
        d->count[C_LF_INNER]++;
        for (int i = 4; i < 16; i += 4)
          filter_edge(d, y + i, ys, 1, 16, bedge, I, thresh, 0);
        filter_edge(d, u + 4, cs, 1, 8, bedge, I, thresh, 0);
        filter_edge(d, v + 4, cs, 1, 8, bedge, I, thresh, 0);
      }
      if (mb_y) {
        d->count[C_LF_MB_EDGE]++;
        filter_edge(d, y, 1, ys, 16, mbedge, I, thresh, 1);
        filter_edge(d, u, 1, cs, 8, mbedge, I, thresh, 1);
        filter_edge(d, v, 1, cs, 8, mbedge, I, thresh, 1);
      }
      if (mb->inner) {
        for (int i = 4; i < 16; i += 4)
          filter_edge(d, y + i * ys, 1, ys, 16, bedge, I, thresh, 0);
        filter_edge(d, u + 4 * cs, 1, cs, 8, bedge, I, thresh, 0);
        filter_edge(d, v + 4 * cs, 1, cs, 8, bedge, I, thresh, 0);
      }
    }
}

/* filter_level_for_mb: the mode deltas are B_PRED's, ZEROMV's, the other
 * whole-MB MVs', SPLITMV's; a 16x16 intra mode has none */
static void filter_strength(vp8_t *d, mb_t *mb) {
  static const int8_t mode_delta[10] = {-1, -1, -1, -1, 0, 1, 2, 2, 2, 3};
  int level = d->filter_level;
  if (d->lf_delta_on) {
    level += d->lf_delta_ref[mb->ref];
    if (mode_delta[mb->mode] >= 0)
      level += d->lf_delta_mode[mode_delta[mb->mode]];
  }
  level = clampi(level, 0, 63);
  int I = level;
  if (d->sharpness) {
    I >>= (d->sharpness + 3) >> 2;
    if (I > 9 - d->sharpness) I = 9 - d->sharpness;
  }
  mb->level = (uint8_t)level;
  mb->inner_limit = (uint8_t)(I < 1 ? 1 : I);
  mb->inner = !mb->skip || mb->mode == M_BPRED || mb->mode == M_SPLIT;
}

/* ---- one macroblock's coefficients (decode_mb_coeffs) ---- */

static void decode_mb_coeffs(vp8_t *d, rac_t *c, mb_t *mb, uint8_t *t_nnz,
                             uint8_t *l_nnz, int16_t blocks[25][16],
                             uint8_t nnz_out[25]) {
  int luma_start = 0, luma_type = 3, block_dc = 0, total = 0;
  if (mb->mode != M_BPRED && mb->mode != M_SPLIT) {
    int nnz = decode_block(d, c, blocks[24], 1, 0, t_nnz[8] + l_nnz[8],
                           d->qmul[0]);
    l_nnz[8] = t_nnz[8] = !!nnz;
    if (nnz) {
      total += nnz;
      block_dc = 1;
      if (nnz == 1) {
        d->count[C_WHT_DC]++;
        luma_dc_wht_dc(blocks, blocks[24]);
      } else {
        d->count[C_WHT]++;
        luma_dc_wht(blocks, blocks[24]);
      }
    }
    luma_start = 1;
    luma_type = 0;
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int nnz = decode_block(d, c, blocks[4 * y + x], luma_type, luma_start,
                             l_nnz[y] + t_nnz[x], d->qmul[1]);
      nnz_out[4 * y + x] = (uint8_t)(nnz + block_dc);
      t_nnz[x] = l_nnz[y] = !!nnz;
      total += nnz;
    }
  for (int p = 0; p < 2; ++p)
    for (int y = 0; y < 2; ++y)
      for (int x = 0; x < 2; ++x) {
        int nnz = decode_block(d, c, blocks[16 + 4 * p + 2 * y + x], 2, 0,
                               l_nnz[4 + 2 * p + y] + t_nnz[4 + 2 * p + x],
                               d->qmul[2]);
        nnz_out[16 + 4 * p + 2 * y + x] = (uint8_t)nnz;
        t_nnz[4 + 2 * p + x] = l_nnz[4 + 2 * p + y] = !!nnz;
        total += nnz;
      }
  if (!total) {
    d->count[C_MB_NO_COEFFS]++;
    mb->skip = 1;
  }
}

/* the residual of an MB not predicted sub-block by sub-block */
static void add_residual(vp8_t *d, mb_t *mb, int mb_x, int mb_y, frame_t *f,
                         int16_t blocks[25][16], const uint8_t nnz[25]) {
  long ys = d->ys, cs = d->cs;
  if (mb->mode != M_BPRED) {
    uint8_t *y = f->y + (long)mb_y * 16 * ys + mb_x * 16;
    for (int by = 0; by < 4; ++by)
      for (int bx = 0; bx < 4; ++bx)
        idct_block(d, y + 4 * by * ys + 4 * bx, blocks[4 * by + bx],
                   nnz[4 * by + bx], ys);
  }
  for (int p = 0; p < 2; ++p) {
    uint8_t *plane = (p ? f->v : f->u) + (long)mb_y * 8 * cs + mb_x * 8;
    for (int by = 0; by < 2; ++by)
      for (int bx = 0; bx < 2; ++bx)
        idct_block(d, plane + 4 * by * cs + 4 * bx,
                   blocks[16 + 4 * p + 2 * by + bx],
                   nnz[16 + 4 * p + 2 * by + bx], cs);
  }
}

/* ---- a frame ---- */

static int free_buffer(const vp8_t *d) {
  for (int i = 0; i < 4; ++i) {
    int used = 0;
    for (int r = REF_LAST; r <= REF_ALTREF; ++r) used |= d->ref[r] == i;
    if (!used) return i;
  }
  return 0;
}

static int decode_frame(vp8_t *d, const uint8_t *data, long n) {
  int update[3];
  for (int k = 0; k < 2; ++k) d->trace[k].n = d->trace[k].nmark = 0;
  int rc = decode_header(d, data, n, update);
  if (rc) return rc;
  d->count[d->key ? C_KEY_FRAME : C_INTER_FRAME]++;
  d->count[d->version ? C_BILINEAR : C_VERSION0]++;
  if (!d->show) d->count[C_HIDDEN_FRAME]++;
  d->count[d->filter_level ? (d->filter_simple ? C_LF_SIMPLE : C_LF_NORMAL)
                           : C_LF_OFF]++;
  if (d->filter_level && d->sharpness) d->count[C_LF_SHARPNESS]++;
  if (d->sign_bias[REF_GOLDEN] || d->sign_bias[REF_ALTREF])
    d->count[C_SIGN_BIAS]++;
  int cur = free_buffer(d);
  frame_t *f = &d->buf[cur];
  int W = d->mbw + 1;
  memset(d->mbs, 0, (size_t)W * sizeof(mb_t)); /* the border row */
  if (d->key) memset(d->top_bmodes, 0, (size_t)d->mbw * 4);
  memset(d->top_nnz, 0, (size_t)d->mbw * 9);
  int16_t blocks[25][16];
  memset(blocks, 0, sizeof blocks);
  for (int mb_y = 0; mb_y < d->mbh; ++mb_y) {
    rac_t *c = &d->parts[mb_y & (d->nparts - 1)];
    uint8_t l_nnz[9] = {0}, left_bmodes[4] = {0, 0, 0, 0};
    mb_t *row = d->mbs + (mb_y + 1) * W;
    memset(row, 0, sizeof(mb_t)); /* the border column */
    if (at_end(d, &d->c)) return VP8_CORRUPT;
    for (int mb_x = 0; mb_x < d->mbw; ++mb_x) {
      mb_t *mb = row + mb_x + 1;
      uint8_t nnz[25];
      memset(mb, 0, sizeof *mb);
      if (at_end(d, &d->c)) return VP8_CORRUPT;
      if (d->tracing) {
        trace_mark(&d->trace[0]);
        trace_mark(&d->trace[1]);
      }
      decode_mb_mode(d, mb, mb_x, mb_y, left_bmodes);
      memset(nnz, 0, sizeof nnz);
      if (!mb->skip) {
        if (at_end(d, c)) return VP8_CORRUPT;
        decode_mb_coeffs(d, c, mb, d->top_nnz[mb_x], l_nnz, blocks, nnz);
      } else {
        d->count[C_MB_SKIP]++;
      }
      if (mb->ref == REF_CURRENT)
        intra_predict(d, mb, mb_x, mb_y, f, blocks, nnz);
      else
        inter_predict(d, mb, mb_x, mb_y, f);
      if (!mb->skip) {
        add_residual(d, mb, mb_x, mb_y, f, blocks, nnz);
      } else {
        memset(l_nnz, 0, 8);
        memset(d->top_nnz[mb_x], 0, 8);
        if (mb->mode != M_BPRED && mb->mode != M_SPLIT)
          l_nnz[8] = d->top_nnz[mb_x][8] = 0;
      }
      filter_strength(d, mb);
    }
  }
  if (d->filter_level) loop_filter(d, f);
  /* references: copies from the references before this frame, then the
   * refreshes */
  int old[4];
  memcpy(old, d->ref, sizeof old);
  old[REF_CURRENT] = cur;
  if (!d->key) {
    static const int copy_count[2][4] = {
        {-1, C_COPY_LAST_TO_GOLDEN, -1, C_COPY_ALTREF_TO_GOLDEN},
        {-1, C_COPY_LAST_TO_ALTREF, C_COPY_GOLDEN_TO_ALTREF, -1}};
    for (int k = 0; k < 2; ++k) {
      if (update[k] == REF_CURRENT)
        d->count[k ? C_REFRESH_ALTREF : C_REFRESH_GOLDEN]++;
      else if (update[k] > 0)
        d->count[copy_count[k][update[k]]]++;
    }
    if (!update[2]) d->count[C_KEEP_LAST]++;
  }
  if (update[1] >= 0) d->ref[REF_ALTREF] = old[update[1]];
  if (update[0] >= 0) d->ref[REF_GOLDEN] = old[update[0]];
  if (update[2]) d->ref[REF_LAST] = cur;
  d->cur = cur;
  if (!d->refresh_probs) d->prob = d->saved;
  return d->show ? VP8_OK : VP8_SKIPPED;
}

/* ---- the library's interface ---- */

void *fl_vp8_open(void) { return calloc(1, sizeof(vp8_t)); }

/* Decode one packet.  VP8_OK: a frame (fl_vp8_bgr converts it), its size
 * in wh[0..1]; VP8_SKIPPED: a frame decoded and not shown; VP8_CORRUPT;
 * VP8_NOMEM; VP8_REFUSED + the tool's R_*. */
int fl_vp8_decode(void *h, const uint8_t *data, long n, int *wh) {
  vp8_t *d = (vp8_t *)h;
  if (n < 0) return VP8_CORRUPT;
  if (d->packet_cap < n + 64) {
    free(d->packet);
    d->packet = (uint8_t *)malloc((size_t)n + 64);
    d->packet_cap = d->packet ? n + 64 : 0;
    if (!d->packet) return VP8_NOMEM;
  }
  memcpy(d->packet, data, (size_t)n);
  memset(d->packet + n, 0, 64); /* AV_INPUT_BUFFER_PADDING_SIZE */
  int rc = decode_frame(d, d->packet, n);
  if (rc < 0 || rc >= VP8_REFUSED) return rc;
  wh[0] = d->width;
  wh[1] = d->height;
  return rc;
}

/* The last frame as BGR (H, W, 3). */
int fl_vp8_bgr(void *h, uint8_t *out) {
  vp8_t *d = (vp8_t *)h;
  const frame_t *f = &d->buf[d->cur];
  yuv_planes_t p = {f->y, f->u, f->v, d->ys, d->cs};
  return yuv_to_bgr(&p, d->width, d->height, 1, 1, 0, out);
}

/* The last frame's planes, cropped: y (H x W), u and v (ceil(H/2) x
 * ceil(W/2)), each packed. */
void fl_vp8_planes(void *h, uint8_t *y, uint8_t *u, uint8_t *v) {
  vp8_t *d = (vp8_t *)h;
  const frame_t *f = &d->buf[d->cur];
  int cw = (d->width + 1) / 2, ch = (d->height + 1) / 2;
  for (int r = 0; r < d->height; ++r)
    memcpy(y + (long)r * d->width, f->y + (long)r * d->ys, (size_t)d->width);
  for (int r = 0; r < ch; ++r) {
    memcpy(u + (long)r * cw, f->u + (long)r * d->cs, (size_t)cw);
    memcpy(v + (long)r * cw, f->v + (long)r * d->cs, (size_t)cw);
  }
}

/* The last frame's MB modes in raster order (0-3 the 16x16 intra modes,
 * 4 B_PRED, 5-9 ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV). */
void fl_vp8_modes(void *h, uint8_t *out) {
  vp8_t *d = (vp8_t *)h;
  for (int y = 0; y < d->mbh; ++y)
    for (int x = 0; x < d->mbw; ++x)
      out[y * d->mbw + x] = d->mbs[(y + 1) * (d->mbw + 1) + x + 1].mode;
}

/* The syntax path counters (C_NPATHS of them). */
void fl_vp8_counts(void *h, uint64_t *out) {
  vp8_t *d = (vp8_t *)h;
  memcpy(out, d->count, sizeof d->count);
}

int fl_vp8_npaths(void) { return C_NPATHS; }

/* Keep up to cap bools (and marks) of each later packet's partitions
 * (cap 0: none). */
int fl_vp8_trace_on(void *h, long cap) {
  vp8_t *d = (vp8_t *)h;
  d->tracing = 0;
  for (int k = 0; k < 2; ++k) {
    trace_t *t = &d->trace[k];
    free(t->prob);
    free(t->bit);
    free(t->mark);
    memset(t, 0, sizeof *t);
    if (cap <= 0) continue;
    t->prob = (uint8_t *)malloc((size_t)cap);
    t->bit = (uint8_t *)malloc((size_t)cap);
    t->mark = (long *)malloc((size_t)cap * sizeof(long));
    if (!t->prob || !t->bit || !t->mark) return VP8_NOMEM;
    t->cap = cap;
  }
  d->tracing = cap > 0;
  return VP8_OK;
}

/* Give the next packets' partitions these bits (first partition, token
 * partitions) in place of the ones they code, and trace the probabilities
 * they are read with; NULL arrays end it.  The tests re-encode a stream
 * whose header they changed this way. */
void fl_vp8_replay(void *h, const uint8_t *bits0, long n0,
                   const uint8_t *bits1, long n1) {
  vp8_t *d = (vp8_t *)h;
  d->trace[0].replay = bits0;
  d->trace[0].nreplay = n0;
  d->trace[1].replay = bits1;
  d->trace[1].nreplay = n1;
}

/* The last packet's trace of partition k (0: the first, 1: the token
 * partitions): n[0] bools and n[1] marks, copied up to cap of each. */
void fl_vp8_trace(void *h, int k, uint8_t *prob, uint8_t *bit, long *mark,
                  long cap, long *n) {
  trace_t *t = &((vp8_t *)h)->trace[k];
  n[0] = t->n;
  n[1] = t->nmark;
  long m = t->n < cap ? t->n : cap;
  if (m > 0) {
    memcpy(prob, t->prob, (size_t)m);
    memcpy(bit, t->bit, (size_t)m);
  }
  m = t->nmark < cap ? t->nmark : cap;
  if (m > 0) memcpy(mark, t->mark, (size_t)m * sizeof(long));
}

void fl_vp8_close(void *h) {
  vp8_t *d = (vp8_t *)h;
  if (!d) return;
  free_frames(d);
  free(d->packet);
  for (int k = 0; k < 2; ++k) {
    free(d->trace[k].prob);
    free(d->trace[k].bit);
    free(d->trace[k].mark);
  }
  free(d);
}
