/* FFmpeg's simple IDCT for 8-bit output (ff_simple_idct_int16_8bit,
 * simple_idct_template.c), shared by the decoders of FFmpeg codecs that
 * use it: mjpeg_decode.c, mpeg4_decode.c and mpeg2_decode.c.  Rows with
 * the DC-only shortcut (DC << 3), then columns; IDCT_W1..IDCT_W7 = 22725, 21407,
 * 19266, 16383, 12873, 8867, 4520, rows >> 11, columns >> 20, in unsigned
 * 32-bit sums as FFmpeg's C computes them.  cv2's frames equal it on
 * every committed clip, so its x86-64 build's simple_idct8 code gives the
 * C function's results here.  The block is transformed in place; put
 * writes the clipped result, add adds it to the destination and clips.
 * Every function is static. */
#ifndef FL_SIMPLE_IDCT_H
#define FL_SIMPLE_IDCT_H

#include "yuv_bgr.h"

#define IDCT_W1 22725
#define IDCT_W2 21407
#define IDCT_W3 19266
#define IDCT_W4 16383
#define IDCT_W5 12873
#define IDCT_W6 8867
#define IDCT_W7 4520
#define IDCT_ROW_SHIFT 11
#define IDCT_COL_SHIFT 20

static void simple_idct_row(int16_t *row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t t = (int16_t)(uint16_t)((unsigned)row[0] << 3);
    for (int i = 0; i < 8; ++i) row[i] = t;
    return;
  }
  unsigned a0, a1, a2, a3, b0, b1, b2, b3;
  a0 = (unsigned)IDCT_W4 * row[0] + (1u << (IDCT_ROW_SHIFT - 1));
  a1 = a0;
  a2 = a0;
  a3 = a0;
  a0 += (unsigned)IDCT_W2 * row[2];
  a1 += (unsigned)IDCT_W6 * row[2];
  a2 -= (unsigned)IDCT_W6 * row[2];
  a3 -= (unsigned)IDCT_W2 * row[2];
  b0 = (unsigned)IDCT_W1 * row[1] + (unsigned)IDCT_W3 * row[3];
  b1 = (unsigned)IDCT_W3 * row[1] - (unsigned)IDCT_W7 * row[3];
  b2 = (unsigned)IDCT_W5 * row[1] - (unsigned)IDCT_W1 * row[3];
  b3 = (unsigned)IDCT_W7 * row[1] - (unsigned)IDCT_W5 * row[3];
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += (unsigned)IDCT_W4 * row[4] + (unsigned)IDCT_W6 * row[6];
    a1 += -(unsigned)IDCT_W4 * row[4] - (unsigned)IDCT_W2 * row[6];
    a2 += -(unsigned)IDCT_W4 * row[4] + (unsigned)IDCT_W2 * row[6];
    a3 += (unsigned)IDCT_W4 * row[4] - (unsigned)IDCT_W6 * row[6];
    b0 += (unsigned)IDCT_W5 * row[5] + (unsigned)IDCT_W7 * row[7];
    b1 += -(unsigned)IDCT_W1 * row[5] - (unsigned)IDCT_W5 * row[7];
    b2 += (unsigned)IDCT_W7 * row[5] + (unsigned)IDCT_W3 * row[7];
    b3 += (unsigned)IDCT_W3 * row[5] - (unsigned)IDCT_W1 * row[7];
  }
  row[0] = (int16_t)((int)(a0 + b0) >> IDCT_ROW_SHIFT);
  row[7] = (int16_t)((int)(a0 - b0) >> IDCT_ROW_SHIFT);
  row[1] = (int16_t)((int)(a1 + b1) >> IDCT_ROW_SHIFT);
  row[6] = (int16_t)((int)(a1 - b1) >> IDCT_ROW_SHIFT);
  row[2] = (int16_t)((int)(a2 + b2) >> IDCT_ROW_SHIFT);
  row[5] = (int16_t)((int)(a2 - b2) >> IDCT_ROW_SHIFT);
  row[3] = (int16_t)((int)(a3 + b3) >> IDCT_ROW_SHIFT);
  row[4] = (int16_t)((int)(a3 - b3) >> IDCT_ROW_SHIFT);
}

/* one column's eight outputs (before the shift) */
static void simple_idct_col(const int16_t *col, int out[8]) {
  unsigned a0, a1, a2, a3, b0, b1, b2, b3;
  a0 = (unsigned)IDCT_W4 * (col[0] + ((1 << (IDCT_COL_SHIFT - 1)) / IDCT_W4));
  a1 = a0;
  a2 = a0;
  a3 = a0;
  a0 += (unsigned)IDCT_W2 * col[16];
  a1 += (unsigned)IDCT_W6 * col[16];
  a2 += -(unsigned)IDCT_W6 * col[16];
  a3 += -(unsigned)IDCT_W2 * col[16];
  b0 = (unsigned)IDCT_W1 * col[8] + (unsigned)IDCT_W3 * col[24];
  b1 = (unsigned)IDCT_W3 * col[8] - (unsigned)IDCT_W7 * col[24];
  b2 = (unsigned)IDCT_W5 * col[8] - (unsigned)IDCT_W1 * col[24];
  b3 = (unsigned)IDCT_W7 * col[8] - (unsigned)IDCT_W5 * col[24];
  if (col[32]) {
    a0 += (unsigned)IDCT_W4 * col[32];
    a1 += (unsigned)-IDCT_W4 * col[32];
    a2 += (unsigned)-IDCT_W4 * col[32];
    a3 += (unsigned)IDCT_W4 * col[32];
  }
  if (col[40]) {
    b0 += (unsigned)IDCT_W5 * col[40];
    b1 += (unsigned)-IDCT_W1 * col[40];
    b2 += (unsigned)IDCT_W7 * col[40];
    b3 += (unsigned)IDCT_W3 * col[40];
  }
  if (col[48]) {
    a0 += (unsigned)IDCT_W6 * col[48];
    a1 += (unsigned)-IDCT_W2 * col[48];
    a2 += (unsigned)IDCT_W2 * col[48];
    a3 += (unsigned)-IDCT_W6 * col[48];
  }
  if (col[56]) {
    b0 += (unsigned)IDCT_W7 * col[56];
    b1 += (unsigned)-IDCT_W5 * col[56];
    b2 += (unsigned)IDCT_W3 * col[56];
    b3 += (unsigned)-IDCT_W1 * col[56];
  }
  out[0] = (int)(a0 + b0) >> IDCT_COL_SHIFT;
  out[1] = (int)(a1 + b1) >> IDCT_COL_SHIFT;
  out[2] = (int)(a2 + b2) >> IDCT_COL_SHIFT;
  out[3] = (int)(a3 + b3) >> IDCT_COL_SHIFT;
  out[4] = (int)(a3 - b3) >> IDCT_COL_SHIFT;
  out[5] = (int)(a2 - b2) >> IDCT_COL_SHIFT;
  out[6] = (int)(a1 - b1) >> IDCT_COL_SHIFT;
  out[7] = (int)(a0 - b0) >> IDCT_COL_SHIFT;
}

static void simple_idct_put(int16_t *blk, uint8_t *dst, long stride) {
  int out[8];
  for (int r = 0; r < 8; ++r) simple_idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {
    simple_idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r) dst[r * stride + c] = clip_u8(out[r]);
  }
}

static void simple_idct_add(int16_t *blk, uint8_t *dst, long stride) {
  int out[8];
  for (int r = 0; r < 8; ++r) simple_idct_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) {
    simple_idct_col(blk + c, out);
    for (int r = 0; r < 8; ++r)
      dst[r * stride + c] = clip_u8(dst[r * stride + c] + out[r]);
  }
}

#endif
