/* The marker parser and entropy decoder shared by jpeg_decode.c
 * (cv2.imread's libjpeg-turbo path) and mjpeg_decode.c (cv2.VideoCapture's
 * FFmpeg path): every function here yields the quantized coefficients of
 * each component, which libjpeg and FFmpeg agree on for a valid file.  It
 * follows libjpeg-turbo (see jpeg_decode.c for the functions it mirrors).
 * Included by those two sources only: every function is static. */
#ifndef FL_JPEG_PARSE_H
#define FL_JPEG_PARSE_H

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* return codes: 0 ok; < 0 a file libjpeg fails on (cv2.imread: None);
 * > 0 a kind it reads and this decoder does not */
enum {
  FL_OK = 0,
  FL_ARITHMETIC = 1,
  FL_LOSSLESS = 2,
  FL_HIERARCHICAL = 3,
  FL_PRECISION = 4,
  FL_COMPONENTS = 5,
  FL_SMOOTHING = 6,
  FL_BAD = -1,
  FL_NOMEM = -2,
  FL_NO_SOF = -3,
  FL_SAMPLING = -4,
  FL_TABLE = -5,
  FL_SCAN = -6,
};

#define MAXC 4
#define DCTSIZE2 64

/* jpeg_natural_order with libjpeg's 16 extra entries for k past 63 */
static const int natural[DCTSIZE2 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

typedef struct {
  int defined;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t look_nbits[512];
  uint8_t look_sym[512];
} htable;

typedef struct {
  int id, h, v, tq;
  int dw, dh;   /* downsampled_width / height */
  int wib, hib; /* width / height in blocks */
  int bw, bh;   /* blocks allocated (MCU-padded) */
  int16_t *coef;
  uint16_t quant[DCTSIZE2]; /* natural order, latched at the first scan */
  int latched;
  int coef_bits[DCTSIZE2]; /* progressive: -1 never coded, else last Al */
  uint8_t *plane;          /* bw * 8 x bh * 8 samples */
} comp_t;

typedef struct {
  const uint8_t *d;
  long n, pos;
  uint64_t buf;
  int nbits;
  int marker;       /* unread marker met by the bit reader, or 0 */
  int insufficient; /* a bit past the data was used */
} bitrd;

typedef struct {
  const uint8_t *d;
  long n;
  int width, height, ncomp, progressive, space; /* space: 0 gray 1 ycc 2 rgb */
  int maxh, maxv;
  comp_t c[MAXC];
  uint16_t qt[4][DCTSIZE2];
  int qt_defined[4];
  htable dc[4], ac[4];
  int ri; /* restart interval */
  int jfif, adobe, adobe_transform;
  int seen_sof, scans;
  int ffmpeg; /* FFmpeg's mjpeg decoder: standard tables in progressive too */
  int truncated; /* a scan's entropy data ended early */
} dec_t;

static int u16be(const uint8_t *p) { return (p[0] << 8) | p[1]; }

/* ---- Huffman tables (jpeg_make_d_derived_tbl) ---- */

static int make_table(htable *t, const uint8_t *bits, const uint8_t *vals,
                      int isdc) {
  int huffsize[257], huffcode[257];
  int p = 0, total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  if (total > 256) return FL_TABLE;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return FL_TABLE;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  memset(t->look_nbits, 0, sizeof t->look_nbits);
  p = 0;
  for (int l = 1; l <= 9; ++l)
    for (int i = 1; i <= bits[l]; ++i, ++p) {
      int look = huffcode[p] << (9 - l);
      for (int c = 1 << (9 - l); c > 0; --c, ++look) {
        t->look_nbits[look] = (uint8_t)l;
        t->look_sym[look] = vals[p];
      }
    }
  memcpy(t->vals, vals, total);
  if (isdc)
    for (int i = 0; i < total; ++i)
      if (vals[i] > 15) return FL_TABLE;
  t->defined = 1;
  return FL_OK;
}

/* JPEG Annex K.3: the tables libjpeg installs in slots 0 (luminance) and
 * 1 (chrominance) that no DHT defined (jstdhuff.c std_huff_tables);
 * bits[0] is unused, as in a DHT segment */
static const uint8_t std_dc_bits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
static const uint8_t std_dc_vals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t std_ac_bits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
static const uint8_t std_ac_vals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

/* a table the scan needs: the file's, else slot 0/1's standard one (libjpeg:
 * sequential files only; FFmpeg installs them at init for every file) */
static int need_table(const dec_t *D, htable *t, int slot, int ac) {
  if (t->defined) return FL_OK;
  if (slot > 1 || (D->progressive && !D->ffmpeg))
    return FL_TABLE; /* JERR_NO_HUFF_TABLE */
  return ac ? make_table(t, std_ac_bits[slot], std_ac_vals[slot], 0)
            : make_table(t, std_dc_bits[slot], std_dc_vals, 1);
}

/* ---- the bit reader (jpeg_fill_bit_buffer) ---- */

static void fill(bitrd *b) {
  while (b->nbits <= 56 && !b->marker) {
    int c;
    if (b->pos >= b->n) { /* the source's fake EOI */
      b->marker = 0xD9;
      break;
    }
    c = b->d[b->pos];
    if (c == 0xFF) {
      long p = b->pos + 1;
      while (p < b->n && b->d[p] == 0xFF) ++p;
      if (p >= b->n) {
        b->pos = p;
        b->marker = 0xD9;
        break;
      }
      if (b->d[p] != 0) { /* a marker: unread, pos past its code */
        b->marker = b->d[p];
        b->pos = p + 1;
        break;
      }
      b->pos = p + 1; /* stuffed zero */
    } else {
      b->pos++;
    }
    b->buf |= (uint64_t)c << (56 - b->nbits);
    b->nbits += 8;
  }
}

static int getbits(bitrd *b, int k) {
  if (k == 0) return 0;
  if (b->nbits < k) {
    fill(b);
    if (b->nbits < k) { /* past the data: zero bits */
      b->insufficient = 1;
      b->nbits = k;
    }
  }
  int v = (int)(b->buf >> (64 - k));
  b->buf <<= k;
  b->nbits -= k;
  return v;
}

static int huff(bitrd *b, const htable *t) {
  if (b->nbits < 9) fill(b);
  if (b->nbits >= 9) {
    int look = (int)(b->buf >> 55);
    int nb = t->look_nbits[look];
    if (nb) {
      b->buf <<= nb;
      b->nbits -= nb;
      return t->look_sym[look];
    }
  }
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    code = (code << 1) | getbits(b, 1);
    if (code <= t->maxcode[l]) return t->vals[t->valoffset[l] + code];
  }
  getbits(b, 1); /* libjpeg reads a 17th bit, then fakes a zero */
  return 0;
}

static int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

/* ---- markers (next_marker, read_restart_marker, resync) ---- */

/* From the reader's position, skip to the next marker: returns its code
 * and leaves pos after it; at the end of the data, a fake EOI. */
static int next_marker(bitrd *b) {
  for (;;) {
    while (b->pos < b->n && b->d[b->pos] != 0xFF) b->pos++;
    if (b->pos >= b->n) return 0xD9;
    while (b->pos < b->n && b->d[b->pos] == 0xFF) b->pos++;
    if (b->pos >= b->n) return 0xD9;
    int c = b->d[b->pos++];
    if (c != 0) return c;
  }
}

/* process_restart: drop the buffered bits and read RSTn.  Returns nothing;
 * leaves b->marker set when the entropy decoder must stay out of data. */
static void restart(bitrd *b, int *next_rst) {
  b->buf = 0;
  b->nbits = 0;
  int marker = b->marker ? b->marker : next_marker(b);
  b->marker = marker;
  int desired = *next_rst;
  if (marker == 0xD0 + desired) {
    b->marker = 0;
  } else {
    for (;;) { /* jpeg_resync_to_restart */
      int action;
      if (marker < 0xC0)
        action = 2;
      else if (marker < 0xD0 || marker > 0xD7)
        action = 3;
      else if (marker == 0xD0 + ((desired + 1) & 7) ||
               marker == 0xD0 + ((desired + 2) & 7))
        action = 3;
      else if (marker == 0xD0 + ((desired - 1) & 7) ||
               marker == 0xD0 + ((desired - 2) & 7))
        action = 2;
      else
        action = 1;
      if (action == 1) {
        b->marker = 0;
        break;
      }
      if (action == 3) break;
      marker = next_marker(b);
      b->marker = marker;
    }
  }
  *next_rst = (desired + 1) & 7;
  if (!b->marker) b->insufficient = 0;
}

/* ---- scans ---- */

typedef struct {
  int n;
  int ci[MAXC];
  int td[MAXC], ta[MAXC];
  int ss, se, ah, al;
} scan_t;

static int16_t *block_at(comp_t *c, int by, int bx) {
  return c->coef + ((size_t)by * c->bw + bx) * DCTSIZE2;
}

static void decode_block(dec_t *D, const scan_t *S, int k, bitrd *b,
                         int16_t *blk, int *pred, int *eobrun) {
  const htable *dc = &D->dc[S->td[k]], *ac = &D->ac[S->ta[k]];
  if (!D->progressive) {
    int s = huff(b, dc);
    if (s) s = extend(getbits(b, s), s);
    s = (int)((unsigned)s + (unsigned)pred[k]);
    pred[k] = s;
    blk[0] = (int16_t)s;
    for (int i = 1; i < DCTSIZE2; ++i) {
      int rs = huff(b, ac), r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[natural[i]] = (int16_t)extend(getbits(b, s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
    return;
  }
  if (S->ss == 0) {
    if (S->ah == 0) { /* decode_mcu_DC_first */
      int s = huff(b, dc);
      if (s) s = extend(getbits(b, s), s);
      s = (int)((unsigned)s + (unsigned)pred[k]);
      pred[k] = s;
      blk[0] = (int16_t)((unsigned)s << S->al);
    } else if (getbits(b, 1)) { /* decode_mcu_DC_refine */
      blk[0] |= (int16_t)(1 << S->al);
    }
    return;
  }
  if (S->ah == 0) { /* decode_mcu_AC_first */
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int i = S->ss; i <= S->se; ++i) {
      int rs = huff(b, ac), r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        blk[natural[i]] = (int16_t)((unsigned)extend(getbits(b, s), s)
                                    << S->al);
      } else if (r == 15) {
        i += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += getbits(b, r);
        (*eobrun)--;
        break;
      }
    }
    return;
  }
  /* decode_mcu_AC_refine */
  int p1 = 1 << S->al, m1 = -1 * (1 << S->al);
  int i = S->ss;
  if (*eobrun == 0) {
    for (; i <= S->se; ++i) {
      int rs = huff(b, ac), r = rs >> 4, s = rs & 15;
      if (s) {
        s = getbits(b, 1) ? p1 : m1;
      } else if (r != 15) {
        *eobrun = 1 << r;
        if (r) *eobrun += getbits(b, r);
        break;
      }
      do {
        int16_t *co = blk + natural[i];
        if (*co != 0) {
          if (getbits(b, 1) && (*co & p1) == 0)
            *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
        } else if (--r < 0) {
          break;
        }
        i++;
      } while (i <= S->se);
      if (s) blk[natural[i]] = (int16_t)s;
    }
  }
  if (*eobrun > 0) {
    for (; i <= S->se; ++i) {
      int16_t *co = blk + natural[i];
      if (*co != 0 && getbits(b, 1) && (*co & p1) == 0)
        *co = (int16_t)(*co >= 0 ? *co + p1 : *co + m1);
    }
    (*eobrun)--;
  }
}

/* Decode one scan whose entropy data starts at *pos; leaves *pos after
 * the next marker's code and that code in *marker. */
static void decode_scan(dec_t *D, const scan_t *S, long *pos, int *marker) {
  bitrd b = {D->d, D->n, *pos, 0, 0, 0, 0};
  int pred[MAXC] = {0, 0, 0, 0};
  int eobrun = 0, next_rst = 0, to_go = D->ri;
  int mcux, mcuy;
  if (S->n == 1) {
    mcux = D->c[S->ci[0]].wib;
    mcuy = D->c[S->ci[0]].hib;
  } else {
    mcux = (D->width + 8 * D->maxh - 1) / (8 * D->maxh);
    mcuy = (D->height + 8 * D->maxv - 1) / (8 * D->maxv);
  }
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      if (D->ri) {
        if (to_go == 0) {
          restart(&b, &next_rst);
          for (int k = 0; k < MAXC; ++k) pred[k] = 0;
          eobrun = 0;
          to_go = D->ri;
        }
      }
      if (!b.insufficient) {
        for (int k = 0; k < S->n; ++k) {
          comp_t *c = &D->c[S->ci[k]];
          if (S->n == 1) {
            decode_block(D, S, k, &b, block_at(c, my, mx), pred, &eobrun);
            continue;
          }
          for (int y = 0; y < c->v; ++y)
            for (int x = 0; x < c->h; ++x)
              decode_block(D, S, k, &b,
                           block_at(c, my * c->v + y, mx * c->h + x), pred,
                           &eobrun);
        }
      }
      if (D->ri) to_go--;
    }
  if (b.insufficient) D->truncated = 1;
  /* on to the next marker */
  int m = b.marker;
  if (!m) m = next_marker(&b);
  *pos = b.pos;
  *marker = m;
}

static int start_scan(dec_t *D, const uint8_t *p, int len, scan_t *S) {
  if (!D->seen_sof || len < 1) return FL_SCAN;
  S->n = p[0];
  if (S->n < 1 || S->n > 4 || len < 4 + 2 * S->n) return FL_SCAN;
  int blocks = 0;
  for (int k = 0; k < S->n; ++k) {
    int id = p[1 + 2 * k], ci = -1;
    for (int j = 0; j < D->ncomp; ++j)
      if (D->c[j].id == id) ci = j;
    if (ci < 0) return FL_SCAN;
    for (int j = 0; j < k; ++j)
      if (S->ci[j] == ci) return FL_SCAN;
    S->ci[k] = ci;
    S->td[k] = p[2 + 2 * k] >> 4;
    S->ta[k] = p[2 + 2 * k] & 15;
    if (S->td[k] > 3 || S->ta[k] > 3) return FL_SCAN;
    blocks += D->c[ci].h * D->c[ci].v;
  }
  const uint8_t *q = p + 1 + 2 * S->n;
  S->ss = q[0];
  S->se = q[1];
  S->ah = q[2] >> 4;
  S->al = q[2] & 15;
  if (S->n > 1 && blocks > 10) return FL_SCAN;
  if (D->progressive) {
    /* jdphuff.c start_pass_phuff_decoder's checks */
    if (S->ss == 0) {
      if (S->se != 0) return FL_SCAN;
    } else {
      if (S->se < S->ss || S->se > 63 || S->n != 1) return FL_SCAN;
    }
    if (S->ah != 0 && S->al != S->ah - 1) return FL_SCAN;
    if (S->al > 13) return FL_SCAN;
    /* a bogus progression is only a warning to libjpeg */
    for (int k = 0; k < S->n; ++k)
      for (int i = S->ss; i <= S->se; ++i)
        D->c[S->ci[k]].coef_bits[i] = S->al;
  }
  for (int k = 0; k < S->n; ++k) {
    comp_t *c = &D->c[S->ci[k]];
    int dc_needed = !D->progressive || (S->ss == 0 && S->ah == 0);
    int ac_needed = !D->progressive || S->ss != 0;
    int rc = dc_needed ? need_table(D, &D->dc[S->td[k]], S->td[k], 0) : FL_OK;
    if (rc == FL_OK && ac_needed)
      rc = need_table(D, &D->ac[S->ta[k]], S->ta[k], 1);
    if (rc) return rc;
    if (!c->latched) { /* latch_quant_tables */
      if (!D->qt_defined[c->tq]) return FL_TABLE;
      memcpy(c->quant, D->qt[c->tq], sizeof c->quant);
      c->latched = 1;
    }
  }
  return FL_OK;
}

static int read_sof(dec_t *D, int code, const uint8_t *p, int len) {
  if (D->seen_sof) return FL_BAD;
  if (code == 0xC3) return FL_LOSSLESS;
  if (code >= 0xC9 && code <= 0xCF) return FL_ARITHMETIC;
  if (code >= 0xC5 && code <= 0xC7) return FL_HIERARCHICAL;
  if (len < 6) return FL_BAD;
  if (p[0] != 8) return FL_PRECISION;
  D->height = u16be(p + 1);
  D->width = u16be(p + 3);
  D->ncomp = p[5];
  D->progressive = code == 0xC2;
  if (D->ncomp == 4) return FL_COMPONENTS;
  /* JPEG_MAX_DIMENSION */
  if (D->width <= 0 || D->height <= 0 || D->width > 65500 ||
      D->height > 65500 || (D->ncomp != 1 && D->ncomp != 3) ||
      len < 6 + 3 * D->ncomp)
    return FL_BAD;
  D->maxh = D->maxv = 1;
  for (int i = 0; i < D->ncomp; ++i) {
    comp_t *c = &D->c[i];
    c->id = p[6 + 3 * i];
    c->h = p[7 + 3 * i] >> 4;
    c->v = p[7 + 3 * i] & 15;
    c->tq = p[8 + 3 * i];
    if (c->h < 1 || c->h > 4 || c->v < 1 || c->v > 4 || c->tq > 3)
      return FL_BAD;
    if (c->h > D->maxh) D->maxh = c->h;
    if (c->v > D->maxv) D->maxv = c->v;
  }
  int mcux = (D->width + 8 * D->maxh - 1) / (8 * D->maxh);
  int mcuy = (D->height + 8 * D->maxv - 1) / (8 * D->maxv);
  for (int i = 0; i < D->ncomp; ++i) {
    comp_t *c = &D->c[i];
    c->dw = (int)(((long)D->width * c->h + D->maxh - 1) / D->maxh);
    c->dh = (int)(((long)D->height * c->v + D->maxv - 1) / D->maxv);
    c->wib = (c->dw + 7) / 8;
    c->hib = (c->dh + 7) / 8;
    c->bw = mcux * c->h;
    c->bh = mcuy * c->v;
    c->coef = calloc((size_t)c->bw * c->bh * DCTSIZE2, sizeof(int16_t));
    if (!c->coef) return FL_NOMEM;
    for (int k = 0; k < DCTSIZE2; ++k) c->coef_bits[k] = -1;
  }
  D->seen_sof = 1;
  return FL_OK;
}

static int read_dht(dec_t *D, const uint8_t *p, int len) {
  while (len > 16) {
    uint8_t bits[17];
    int tc = p[0] >> 4, th = p[0] & 15, total = 0;
    bits[0] = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l] = p[l];
    if (total > 256 || 17 + total > len || th > 3 || tc > 1) return FL_TABLE;
    int rc = make_table(tc ? &D->ac[th] : &D->dc[th], bits, p + 17, !tc);
    if (rc) return rc;
    p += 17 + total;
    len -= 17 + total;
  }
  return len == 0 ? FL_OK : FL_TABLE;
}

static int read_dqt(dec_t *D, const uint8_t *p, int len) {
  while (len > 0) {
    int pq = p[0] >> 4, tq = p[0] & 15;
    int size = 1 + DCTSIZE2 * (pq ? 2 : 1);
    if (tq > 3 || pq > 1 || len < size) return FL_TABLE;
    for (int i = 0; i < DCTSIZE2; ++i)
      D->qt[tq][natural[i]] =
          (uint16_t)(pq ? u16be(p + 1 + 2 * i) : p[1 + i]);
    D->qt_defined[tq] = 1;
    p += size;
    len -= size;
  }
  return FL_OK;
}

/* Walk the markers; with decode, run every scan. */
static int parse(dec_t *D, int decode) {
  const uint8_t *d = D->d;
  long n = D->n;
  if (n < 3 || d[0] != 0xFF || d[1] != 0xD8) return FL_BAD;
  bitrd b = {d, n, 2, 0, 0, 0, 0};
  int marker = next_marker(&b);
  for (;;) {
    long pos = b.pos;
    if (marker == 0xD9) /* libjpeg: no image without a scan */
      return !D->seen_sof ? FL_NO_SOF : (decode && !D->scans) ? FL_BAD : FL_OK;
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD8)) {
      if (marker == 0xD8) return FL_BAD;
      marker = next_marker(&b);
      continue;
    }
    if (pos + 2 > n) return D->scans ? FL_OK : FL_BAD;
    int len = u16be(d + pos) - 2;
    if (len < 0) return FL_BAD;
    const uint8_t *p = d + pos + 2;
    if (pos + 2 + len > n) /* a segment cut by the end of the file */
      return D->scans ? FL_OK : FL_BAD;
    int rc = FL_OK;
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
        marker != 0xC8 && marker != 0xCC) {
      rc = read_sof(D, marker, p, len);
      if (rc == FL_OK && !decode) return FL_OK;
    } else if (marker == 0xC4) {
      rc = read_dht(D, p, len);
    } else if (marker == 0xCC) {
      rc = FL_ARITHMETIC;
    } else if (marker == 0xDB) {
      rc = read_dqt(D, p, len);
    } else if (marker == 0xDD) {
      if (len < 2) return FL_BAD;
      D->ri = u16be(p);
    } else if (marker == 0xE0 && len >= 5 && !memcmp(p, "JFIF", 5)) {
      D->jfif = 1;
    } else if (marker == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
      D->adobe = 1;
      D->adobe_transform = p[11];
    } else if (marker == 0xDA) {
      scan_t S;
      rc = start_scan(D, p, len, &S);
      if (rc) return rc;
      D->scans++;
      long at = pos + 2 + len;
      decode_scan(D, &S, &at, &marker);
      b.pos = at;
      continue;
    } else if (marker == 0xDC || marker == 0xDE || marker == 0xDF) {
      rc = marker == 0xDE ? FL_HIERARCHICAL : FL_OK;
    }
    if (rc) return rc;
    b.pos = pos + 2 + len;
    marker = next_marker(&b);
  }
}

#endif /* FL_JPEG_PARSE_H */
