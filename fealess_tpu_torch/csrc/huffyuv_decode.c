/* Huffyuv frames for io/huffyuv.py: what cv2.VideoCapture returns for a
 * frame of an HFYU stream, bit for bit.  cv2 decodes it with FFmpeg's
 * huffyuv decoder (huffyuvdec.c) and converts its bgr0 frame to BGR24 with
 * swscale, which drops the fourth byte.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.
 *
 * Read: what FFmpeg's huffyuv encoder writes for cv2.VideoWriter's HFYU
 * fourcc, version 2 (the extradata's fourth byte 0): RGB24 (bits per
 * pixel 24), left prediction, decorrelated (G, then B - G, then R - G),
 * the three tables in the extradata (no per-frame context).  The stages:
 *   read_len_table            each table's 256 code lengths, run-length
 *                             coded (3-bit repeat, 0 = an 8-bit repeat,
 *                             5-bit length), big-endian bits
 *   generate_bits_table       codes from the longest length down: the
 *                             codes of one length are consecutive, in
 *                             symbol order
 *   decode_frame              the packet read as 32-bit little-endian
 *                             words, each from its top bit down (FFmpeg
 *                             byte-swaps the words, then reads big-endian)
 *   the RGB branch            the first pixel as R, G, B (8 bits each, 8
 *                             skipped), then the bottom row's other
 *                             pixels and every row above it, stored
 *                             upside down, each channel a running sum
 *                             along the rows (left prediction carried
 *                             from row to row).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  HY_OK = 0,
  HY_KIND = 1, /* a stream other than the one described above */
  HY_BAD = -1, /* a table or a frame FFmpeg fails on */
  HY_NOMEM = -2,
  HY_SHORT = -3, /* a frame whose bits end before its last pixel */
};

#define NSYM 256
#define LUT_BITS 16

typedef struct {
  uint8_t len[NSYM];
  uint32_t first[33]; /* the first code of each length */
  int count[33];
  int base[33];       /* the index in syms of each length's first code */
  uint8_t syms[NSYM]; /* by length, then by code */
  uint16_t *lut;      /* (symbol << 5 | length) by the next LUT_BITS bits;
                         0 where the code is longer */
} table_t;

typedef struct {
  table_t t[3]; /* B - G, G, R - G */
} dec_t;

/* ---- bit readers ---- */

typedef struct {
  const uint8_t *d;
  long n;     /* bytes */
  long nbits; /* bits past the end read as zero */
  long pos;
  int words;  /* 1: 32-bit little-endian words, each from its top bit */
} bits_t;

/* the k-th 32 bits of the stream, most significant first */
static inline uint64_t word_at(const bits_t *b, long k) {
  long at = k * 4;
  uint8_t p[4] = {0, 0, 0, 0};
  if (at + 4 <= b->n)
    memcpy(p, b->d + at, 4);
  else if (at < b->n)
    memcpy(p, b->d + at, (size_t)(b->n - at));
  if (b->words)
    return (uint64_t)p[0] | (uint64_t)p[1] << 8 | (uint64_t)p[2] << 16 |
           (uint64_t)p[3] << 24;
  return (uint64_t)p[3] | (uint64_t)p[2] << 8 | (uint64_t)p[1] << 16 |
         (uint64_t)p[0] << 24;
}

/* the next n bits (1 <= n <= 32) without consuming them */
static inline uint32_t peek(const bits_t *b, int n) {
  long k = b->pos >> 5;
  uint64_t c = word_at(b, k) << 32 | word_at(b, k + 1);
  return (uint32_t)((c << (b->pos & 31)) >> (64 - n));
}

static inline unsigned get_bits(bits_t *b, int n) {
  unsigned v = peek(b, n);
  b->pos += n;
  return v;
}

/* ---- tables ---- */

static int read_len_table(uint8_t *dst, bits_t *b) {
  for (int i = 0; i < NSYM;) {
    int repeat = (int)get_bits(b, 3), val = (int)get_bits(b, 5);
    if (!repeat) repeat = (int)get_bits(b, 8);
    if (i + repeat > NSYM || b->pos > b->nbits) return HY_BAD;
    while (repeat--) dst[i++] = (uint8_t)val;
  }
  return HY_OK;
}

static int build_table(table_t *t) {
  uint32_t codes[33];
  int lens[33] = {0};
  for (int i = 0; i < NSYM; ++i) lens[t->len[i]]++;
  codes[32] = 0;
  for (int i = 32; i > 0; --i) {
    if ((lens[i] + codes[i]) & 1) return HY_BAD;
    codes[i - 1] = (lens[i] + codes[i]) >> 1;
  }
  /* vlc_init's "Invalid code": a length whose codes run past 2**l (more
     codes than the lengths allow) */
  for (int l = 1; l <= 32; ++l)
    if (lens[l] && (uint64_t)codes[l] + (uint64_t)lens[l] > (uint64_t)1 << l)
      return HY_BAD;
  int at = 0;
  for (int l = 1; l <= 32; ++l) {
    t->first[l] = codes[l];
    t->count[l] = lens[l];
    t->base[l] = at;
    for (int i = 0; i < NSYM; ++i)
      if (t->len[i] == l) t->syms[at++] = (uint8_t)i;
  }
  t->lut = calloc((size_t)1 << LUT_BITS, sizeof(uint16_t));
  if (!t->lut) return HY_NOMEM;
  for (int l = 1; l <= LUT_BITS; ++l)
    for (int k = 0; k < t->count[l]; ++k) {
      uint32_t code = t->first[l] + (uint32_t)k;
      uint32_t lo = code << (LUT_BITS - l), n = 1u << (LUT_BITS - l);
      for (uint32_t j = 0; j < n; ++j)
        t->lut[lo + j] =
            (uint16_t)(t->syms[t->base[l] + k] << 5 | (unsigned)l);
    }
  return HY_OK;
}

/* get_vlc2: one symbol (-1 where no code matches, as FFmpeg's tables
 * give) */
static int get_sym(const table_t *t, bits_t *b) {
  uint16_t e = t->lut[peek(b, LUT_BITS)];
  if (e) {
    b->pos += e & 31;
    return e >> 5;
  }
  uint32_t all = peek(b, 32);
  for (int l = LUT_BITS + 1; l <= 32; ++l) {
    uint32_t v = all >> (32 - l);
    if (t->count[l] && v >= t->first[l] &&
        v - t->first[l] < (uint32_t)t->count[l]) {
      b->pos += l;
      return t->syms[t->base[l] + (int)(v - t->first[l])];
    }
  }
  b->pos += 32;
  return -1;
}

/* ---- entry points ---- */

void fl_huffyuv_close(void *h) {
  dec_t *D = h;
  if (!D) return;
  for (int i = 0; i < 3; ++i) free(D->t[i].lut);
  free(D);
}

/* The stream's decoder from its extradata; *rc 0, HY_KIND (info: version,
 * bits per pixel, predictor, decorrelate, context) or < 0. */
void *fl_huffyuv_open(const uint8_t *extradata, long n, int *info) {
  info[0] = HY_BAD;
  if (n < 4) return NULL;
  int version = extradata[3] == 0 ? 2 : 3;
  info[1] = version;
  info[2] = extradata[1];
  info[3] = extradata[0] & 63;
  info[4] = extradata[0] >> 6 & 1;
  info[5] = extradata[2] >> 6 & 1;
  if (version != 2 || info[2] != 24 || info[3] != 0 || !info[4] ||
      info[5]) {
    info[0] = HY_KIND;
    return NULL;
  }
  dec_t *D = calloc(1, sizeof *D);
  if (!D) {
    info[0] = HY_NOMEM;
    return NULL;
  }
  bits_t b = {extradata + 4, n - 4, (n - 4) * 8, 0, 0};
  for (int i = 0; i < 3; ++i) {
    int rc = read_len_table(D->t[i].len, &b);
    if (rc == HY_OK) rc = build_table(&D->t[i]);
    if (rc != HY_OK) {
      fl_huffyuv_close(D);
      info[0] = rc;
      return NULL;
    }
  }
  info[0] = HY_OK;
  return D;
}

/* One frame to out, BGR (H, W, 3). */
int fl_huffyuv_decode(void *h, const uint8_t *data, long n, int W, int H,
                      uint8_t *out) {
  dec_t *D = h;
  if (W <= 0 || H <= 0) return HY_BAD;
  bits_t b = {data, n, (n / 4) * 32, 0, 1};
  uint8_t r = (uint8_t)get_bits(&b, 8), g = (uint8_t)get_bits(&b, 8),
          bl = (uint8_t)get_bits(&b, 8);
  get_bits(&b, 8);
  uint8_t *o = out + (size_t)(H - 1) * W * 3;
  o[0] = bl;
  o[1] = g;
  o[2] = r;
  for (int y = H - 1; y >= 0; --y) {
    o = out + (size_t)y * W * 3;
    for (int x = y == H - 1 ? 1 : 0; x < W; ++x) {
      int G = get_sym(&D->t[1], &b);
      int B = get_sym(&D->t[0], &b) + G;
      int R = get_sym(&D->t[2], &b) + G;
      if (b.pos > b.nbits) return HY_SHORT;
      bl = (uint8_t)(bl + B);
      g = (uint8_t)(g + G);
      r = (uint8_t)(r + R);
      o[3 * x] = bl;
      o[3 * x + 1] = g;
      o[3 * x + 2] = r;
    }
  }
  return HY_OK;
}
