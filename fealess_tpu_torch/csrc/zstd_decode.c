/* Zstandard frame decoding (RFC 8878) for io/zstd.py, plus the two
 * checksums the checkpoint reader needs: XXH64 (a zstd frame's content
 * checksum) and CRC-32C (the OCDBT files' trailer).
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.
 *
 * Decoded: frames one after another, skippable frames between them, the
 * frame header (single segment, window descriptor, content size,
 * dictionary id 0 only), raw, RLE and compressed blocks; literals raw,
 * RLE, or Huffman-coded in 1 or 4 streams, with the frame's previous
 * table for a treeless section; sequences with predefined, RLE,
 * FSE-described and repeated tables, the three repeat offsets, and the
 * optional XXH64 content checksum, which is verified.
 *
 * The input is untrusted: every read of the input and every write of the
 * output is bounds-checked, so corrupt data returns a negative code and
 * never reads or writes outside the buffers.  The output goes into the
 * caller's buffer of `cap` bytes; content that would pass it is an
 * error.  Nothing is kept between calls.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  ZS_TRUNCATED = -1,  /* the input ends inside a frame */
  ZS_MAGIC = -2,      /* not a zstd or skippable frame */
  ZS_DICTIONARY = -3, /* the frame needs a dictionary */
  ZS_HEADER = -4,     /* reserved bit set in the frame header */
  ZS_BLOCK = -5,      /* reserved block type, or a block past its limit */
  ZS_OUTPUT = -6,     /* the content passes the caller's capacity */
  ZS_CHECKSUM = -7,   /* XXH64 of the content differs */
  ZS_LITERALS = -8,   /* corrupt literals section */
  ZS_HUFFMAN = -9,    /* corrupt Huffman table or stream */
  ZS_FSE = -10,       /* corrupt FSE table description */
  ZS_SEQUENCES = -11, /* corrupt sequences section */
  ZS_OFFSET = -12,    /* a match before the frame's first byte */
  ZS_SIZE = -13,      /* content size differs from the header's */
  ZS_NOMEM = -14,
};

#define BLOCK_MAX (128 * 1024)
#define HUF_MAX_BITS 11
#define LL_MAX_LOG 9
#define ML_MAX_LOG 9
#define OF_MAX_LOG 8

static int highbit(uint64_t v) { /* floor(log2(v)), v > 0 */
  int r = 0;
  while (v >>= 1) ++r;
  return r;
}

static uint32_t rd16(const uint8_t *p) { return p[0] | (uint32_t)p[1] << 8; }
static uint32_t rd24(const uint8_t *p) {
  return rd16(p) | (uint32_t)p[2] << 16;
}
static uint32_t rd32(const uint8_t *p) { return rd16(p) | rd16(p + 2) << 16; }
static uint64_t rd64(const uint8_t *p) {
  return rd32(p) | (uint64_t)rd32(p + 4) << 32;
}

/* ---- XXH64 ---- */

#define P1 11400714785074694791ULL
#define P2 14029467366897019727ULL
#define P3 1609587929392839161ULL
#define P4 9650029242287828579ULL
#define P5 2870177450012600261ULL

static uint64_t rotl64(uint64_t x, int r) { return x << r | x >> (64 - r); }
static uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl64(acc + in * P2, 31) * P1;
}
static uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t fl_xxh64(const uint8_t *p, size_t n, uint64_t seed) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl64(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl64(h ^ rd32(p) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ h >> 32;
}

/* ---- CRC-32C (Castagnoli, reflected 0x82F63B78) ---- */

static uint32_t crc_table[8][256];
static int crc_ready;

static void crc_init(void) {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = c & 1 ? c >> 1 ^ 0x82F63B78u : c >> 1;
    crc_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (int i = 0; i < 256; ++i)
      crc_table[t][i] = crc_table[t - 1][i] >> 8 ^
                        crc_table[0][crc_table[t - 1][i] & 255];
  crc_ready = 1;
}

/* crc of p[0..n) continuing from `crc` (0 to start) */
uint32_t fl_crc32c(const uint8_t *p, size_t n, uint32_t crc) {
  if (!crc_ready) crc_init(); /* idempotent: a race writes equal values */
  crc = ~crc;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t a = crc ^ rd32(p), b = rd32(p + 4);
    crc = crc_table[7][a & 255] ^ crc_table[6][a >> 8 & 255] ^
          crc_table[5][a >> 16 & 255] ^ crc_table[4][a >> 24] ^
          crc_table[3][b & 255] ^ crc_table[2][b >> 8 & 255] ^
          crc_table[1][b >> 16 & 255] ^ crc_table[0][b >> 24];
  }
  while (n--) crc = crc >> 8 ^ crc_table[0][(crc ^ *p++) & 255];
  return ~crc;
}

/* ---- bit readers ---- */

/* The backward stream of RFC 8878 4.1: read from the end, the last
 * byte's highest set bit marks where the stream starts.  `left` counts
 * the bits not yet read; bits below the first byte read as zeros and make
 * `left` negative (the reference's overflow). */
typedef struct {
  const uint8_t *p;
  size_t n;
  int64_t left;
} bwd;

static int bwd_init(bwd *b, const uint8_t *p, size_t n) {
  if (n == 0 || p[n - 1] == 0) return -1;
  b->p = p;
  b->n = n;
  b->left = (int64_t)n * 8 - 8 + highbit(p[n - 1]);
  return 0;
}

/* bits [lo, lo + k) of the stream as a little-endian integer; k <= 56,
 * 0 <= lo, lo + k <= 8 n */
static uint64_t bits_at(const bwd *b, int64_t lo, int k) {
  size_t i = (size_t)(lo >> 3), e = i + 8 < b->n ? i + 8 : b->n;
  uint64_t v = 0;
  for (size_t j = e; j > i; --j) v = v << 8 | b->p[j - 1];
  return (v >> (lo & 7)) & (((uint64_t)1 << k) - 1);
}

static uint64_t bwd_read(bwd *b, int k) {
  if (k == 0) return 0;
  b->left -= k;
  if (b->left >= 0) return bits_at(b, b->left, k);
  int have = (int)(b->left + k);
  return have > 0 ? bits_at(b, 0, have) << (k - have) : 0;
}

/* peek k bits without consuming (Huffman look-up) */
static uint32_t bwd_peek(const bwd *b, int k) {
  if (b->left >= k) return (uint32_t)bits_at(b, b->left - k, k);
  if (b->left <= 0) return 0;
  return (uint32_t)(bits_at(b, 0, (int)b->left) << (k - b->left));
}

/* ---- FSE tables ---- */

typedef struct {
  uint8_t sym, nb;
  uint16_t base;
} fse_cell;

typedef struct {
  fse_cell t[1 << LL_MAX_LOG];
  int log;
} fse_table;

/* k <= 16 bits of p[0..n) from bit `pos` on, read forward; bits past
 * the end read as zeros */
static uint32_t fwd_peek(const uint8_t *p, size_t n, uint64_t pos, int k) {
  uint32_t v = 0;
  for (int b = 0; b < k; ++b, ++pos)
    if ((pos >> 3) < n) v |= (uint32_t)(p[pos >> 3] >> (pos & 7) & 1) << b;
  return v;
}

/* RFC 8878 4.1.1: an FSE table description read forward from p[0..n);
 * returns the bytes it takes, or ZS_FSE */
static long read_ncount(const uint8_t *p, size_t n, int16_t *norm,
                        int *max_sym, int *log, int max_log) {
  uint64_t pos = 0;
  int al = (int)fwd_peek(p, n, pos, 4) + 5;
  pos += 4;
  if (al > max_log) return ZS_FSE;
  int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1;
  int sym = 0, prev0 = 0, limit = *max_sym;
  while (remaining > 1 && sym <= limit) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        int r = (int)fwd_peek(p, n, pos, 2);
        pos += 2;
        n0 += r;
        if (r != 3 || n0 > limit) break;
      }
      if (n0 > limit) return ZS_FSE;
      while (sym < n0) norm[sym++] = 0;
    }
    int max = 2 * threshold - 1 - remaining, count;
    uint32_t v = fwd_peek(p, n, pos, nbits);
    if ((int)(v & (threshold - 1)) < max) {
      count = (int)(v & (threshold - 1));
      pos += nbits - 1;
    } else {
      count = (int)(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      pos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = (int16_t)count;
    prev0 = !count;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit((uint64_t)remaining) + 1;
      threshold = 1 << (nbits - 1);
    }
  }
  if (remaining != 1 || (pos + 7) / 8 > n) return ZS_FSE;
  *max_sym = sym - 1;
  *log = al;
  return (long)((pos + 7) / 8);
}

/* RFC 8878 4.1.1: spread the symbols, then each cell's bits and base */
static int build_fse(fse_table *T, const int16_t *norm, int max_sym, int al) {
  int size = 1 << al, high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= max_sym; ++s) {
    if (norm[s] == -1) {
      if (high < 0) return ZS_FSE;
      T->t[high--].sym = (uint8_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint16_t)norm[s];
    }
  }
  int pos = 0, step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  for (int s = 0; s <= max_sym; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      T->t[pos].sym = (uint8_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) return ZS_FSE;
  for (int u = 0; u < size; ++u) {
    int ns = next[T->t[u].sym]++;
    int nb = al - highbit((uint64_t)ns);
    T->t[u].nb = (uint8_t)nb;
    T->t[u].base = (uint16_t)((ns << nb) - size);
  }
  T->log = al;
  return 0;
}

static void rle_fse(fse_table *T, int sym) {
  T->t[0].sym = (uint8_t)sym;
  T->t[0].nb = 0;
  T->t[0].base = 0;
  T->log = 0;
}

/* ---- sequence code tables (RFC 8878 3.1.1.3.2.1) ---- */

static const uint32_t ll_base[36] = {
    0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t ll_bits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                                    0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                                    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t ml_base[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t ml_bits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

static const int16_t ll_default[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                       2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ml_default[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
static const int16_t of_default[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 1, -1, -1, -1, -1, -1};

/* ---- the decoder's state for one call ---- */

typedef struct {
  uint8_t *out;
  size_t cap, pos, frame_start, block_max;
  uint32_t rep[3];
  fse_table ll, of, ml;
  int have_ll, have_of, have_ml; /* a table to repeat in this frame */
  uint8_t huf_sym[1 << HUF_MAX_BITS], huf_nb[1 << HUF_MAX_BITS];
  int huf_bits, have_huf;
  uint8_t lit[BLOCK_MAX];
  size_t nlit;
} zctx;

/* ---- Huffman literals (RFC 8878 4.2) ---- */

static int build_huf(zctx *Z, uint8_t *w, int nw) {
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (w[i] > HUF_MAX_BITS) return ZS_HUFFMAN;
    if (w[i]) total += 1u << (w[i] - 1);
  }
  if (total == 0) return ZS_HUFFMAN;
  int bits = highbit(total) + 1;
  if (bits > HUF_MAX_BITS) return ZS_HUFFMAN;
  uint32_t rest = (1u << bits) - total;
  if (rest & (rest - 1)) return ZS_HUFFMAN;
  w[nw] = (uint8_t)(highbit(rest) + 1);
  int n = nw + 1, pos = 0;
  for (int wt = 1; wt <= bits; ++wt)
    for (int s = 0; s < n; ++s)
      if (w[s] == wt) {
        int len = 1 << (wt - 1);
        memset(Z->huf_sym + pos, s, (size_t)len);
        memset(Z->huf_nb + pos, bits + 1 - wt, (size_t)len);
        pos += len;
      }
  Z->huf_bits = bits;
  Z->have_huf = 1;
  return 0;
}

/* the Huffman tree description at p[0..n); returns the bytes it takes */
static long read_huf_tree(zctx *Z, const uint8_t *p, size_t n) {
  uint8_t w[257];
  int nw = 0;
  if (n < 1) return ZS_HUFFMAN;
  int hb = p[0];
  long used;
  if (hb >= 128) { /* direct: 4 bits a weight */
    nw = hb - 127;
    used = 1 + (nw + 1) / 2;
    if ((size_t)used > n) return ZS_HUFFMAN;
    for (int i = 0; i < nw; ++i)
      w[i] = i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4;
  } else { /* FSE-compressed weights, two interleaved states */
    used = 1 + hb;
    if ((size_t)used > n || hb == 0) return ZS_HUFFMAN;
    int16_t norm[256];
    int max_sym = 255, al;
    long h = read_ncount(p + 1, (size_t)hb, norm, &max_sym, &al, 6);
    if (h < 0) return ZS_HUFFMAN;
    fse_table T;
    if (build_fse(&T, norm, max_sym, al)) return ZS_HUFFMAN;
    bwd b;
    if (bwd_init(&b, p + 1 + h, (size_t)(hb - h))) return ZS_HUFFMAN;
    uint32_t s1 = (uint32_t)bwd_read(&b, al), s2 = (uint32_t)bwd_read(&b, al);
    if (b.left < 0) return ZS_HUFFMAN;
    for (;;) {
      if (nw > 253) return ZS_HUFFMAN;
      w[nw++] = T.t[s1].sym;
      s1 = T.t[s1].base + (uint32_t)bwd_read(&b, T.t[s1].nb);
      if (b.left < 0) {
        w[nw++] = T.t[s2].sym;
        break;
      }
      if (nw > 253) return ZS_HUFFMAN;
      w[nw++] = T.t[s2].sym;
      s2 = T.t[s2].base + (uint32_t)bwd_read(&b, T.t[s2].nb);
      if (b.left < 0) {
        w[nw++] = T.t[s1].sym;
        break;
      }
    }
  }
  int rc = build_huf(Z, w, nw);
  return rc ? rc : used;
}

static int huf_stream(const zctx *Z, const uint8_t *p, size_t n, uint8_t *o,
                      size_t count) {
  bwd b;
  if (bwd_init(&b, p, n)) return ZS_HUFFMAN;
  int bits = Z->huf_bits;
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = bwd_peek(&b, bits);
    o[i] = Z->huf_sym[v];
    b.left -= Z->huf_nb[v];
    if (b.left < 0) return ZS_HUFFMAN;
  }
  return b.left == 0 ? 0 : ZS_HUFFMAN;
}

/* the literals section at p[0..n); returns the bytes it takes */
static long read_literals(zctx *Z, const uint8_t *p, size_t n) {
  if (n < 1) return ZS_LITERALS;
  int type = p[0] & 3, fmt = p[0] >> 2 & 3;
  size_t regen, comp = 0, hsize;
  int streams = 1;
  if (type < 2) { /* raw, RLE */
    if (fmt == 1) {
      hsize = 2;
    } else if (fmt == 3) {
      hsize = 3;
    } else {
      hsize = 1;
    }
    if (n < hsize) return ZS_LITERALS;
    regen = hsize == 1 ? (size_t)(p[0] >> 3)
            : hsize == 2 ? (size_t)(rd16(p) >> 4)
                         : (size_t)(rd24(p) >> 4);
    if (regen > Z->block_max) return ZS_LITERALS;
    if (type == 0) {
      if (n - hsize < regen) return ZS_LITERALS;
      memcpy(Z->lit, p + hsize, regen);
      Z->nlit = regen;
      return (long)(hsize + regen);
    }
    if (n < hsize + 1) return ZS_LITERALS;
    memset(Z->lit, p[hsize], regen);
    Z->nlit = regen;
    return (long)(hsize + 1);
  }
  /* Huffman-coded, with a tree (2) or the previous one (3) */
  if (fmt == 0 || fmt == 1) {
    hsize = 3;
    if (n < hsize) return ZS_LITERALS;
    uint32_t v = rd24(p);
    regen = v >> 4 & 1023;
    comp = v >> 14 & 1023;
    streams = fmt == 0 ? 1 : 4;
  } else if (fmt == 2) {
    hsize = 4;
    if (n < hsize) return ZS_LITERALS;
    uint32_t v = rd32(p);
    regen = v >> 4 & 16383;
    comp = v >> 18;
    streams = 4;
  } else {
    hsize = 5;
    if (n < hsize) return ZS_LITERALS;
    uint64_t v = rd32(p) | (uint64_t)p[4] << 32;
    regen = (size_t)(v >> 4 & 262143);
    comp = (size_t)(v >> 22 & 262143);
    streams = 4;
  }
  if (regen > Z->block_max || comp > n - hsize) return ZS_LITERALS;
  const uint8_t *q = p + hsize;
  size_t left = comp;
  if (type == 2) {
    long t = read_huf_tree(Z, q, left);
    if (t < 0) return t;
    q += t;
    left -= (size_t)t;
  } else if (!Z->have_huf) {
    return ZS_HUFFMAN;
  }
  if (streams == 1) {
    int rc = huf_stream(Z, q, left, Z->lit, regen);
    if (rc) return rc;
  } else {
    if (left < 6) return ZS_HUFFMAN;
    size_t sz[4], seg = (regen + 3) / 4;
    sz[0] = rd16(q);
    sz[1] = rd16(q + 2);
    sz[2] = rd16(q + 4);
    q += 6;
    left -= 6;
    if (sz[0] + sz[1] + sz[2] > left || 3 * seg > regen) return ZS_HUFFMAN;
    sz[3] = left - sz[0] - sz[1] - sz[2];
    for (int k = 0; k < 4; ++k) {
      size_t cnt = k < 3 ? seg : regen - 3 * seg;
      int rc = huf_stream(Z, q, sz[k], Z->lit + k * seg, cnt);
      if (rc) return rc;
      q += sz[k];
    }
  }
  Z->nlit = regen;
  return (long)(hsize + comp);
}

/* ---- sequences (RFC 8878 3.1.1.3.2) ---- */

/* one table's mode: 0 predefined, 1 RLE, 2 FSE described, 3 repeat */
static long seq_table(fse_table *T, int *have, int mode, const uint8_t *p,
                      size_t n, const int16_t *def, int def_max, int def_log,
                      int max_sym, int max_log) {
  if (mode == 0) {
    if (build_fse(T, def, def_max, def_log)) return ZS_SEQUENCES;
    *have = 1;
    return 0;
  }
  if (mode == 1) {
    if (n < 1 || p[0] > max_sym) return ZS_SEQUENCES;
    rle_fse(T, p[0]);
    *have = 1;
    return 1;
  }
  if (mode == 2) {
    int16_t norm[256];
    int ms = max_sym, al;
    long used = read_ncount(p, n, norm, &ms, &al, max_log);
    if (used < 0) return used;
    if (build_fse(T, norm, ms, al)) return ZS_FSE;
    *have = 1;
    return used;
  }
  return *have ? 0 : ZS_SEQUENCES;
}

static int copy_literals(zctx *Z, size_t *li, size_t k) {
  if (k > Z->nlit - *li) return ZS_SEQUENCES;
  if (k > Z->cap - Z->pos) return ZS_OUTPUT;
  memcpy(Z->out + Z->pos, Z->lit + *li, k);
  Z->pos += k;
  *li += k;
  return 0;
}

static int read_sequences(zctx *Z, const uint8_t *p, size_t n) {
  if (n < 1) return ZS_SEQUENCES;
  size_t nseq, h;
  if (p[0] < 128) {
    nseq = p[0];
    h = 1;
  } else if (p[0] < 255) {
    if (n < 2) return ZS_SEQUENCES;
    nseq = (size_t)(p[0] - 128) << 8 | p[1];
    h = 2;
  } else {
    if (n < 3) return ZS_SEQUENCES;
    nseq = rd16(p + 1) + 0x7F00u;
    h = 3;
  }
  size_t li = 0;
  if (nseq == 0) {
    if (h != n) return ZS_SEQUENCES;
    return copy_literals(Z, &li, Z->nlit);
  }
  if (n < h + 1) return ZS_SEQUENCES;
  int modes = p[h++];
  if (modes & 3) return ZS_SEQUENCES;
  long u;
  u = seq_table(&Z->ll, &Z->have_ll, modes >> 6, p + h, n - h, ll_default, 35,
                6, 35, LL_MAX_LOG);
  if (u < 0) return (int)u;
  h += (size_t)u;
  u = seq_table(&Z->of, &Z->have_of, modes >> 4 & 3, p + h, n - h,
                of_default, 28, 5, 31, OF_MAX_LOG);
  if (u < 0) return (int)u;
  h += (size_t)u;
  u = seq_table(&Z->ml, &Z->have_ml, modes >> 2 & 3, p + h, n - h,
                ml_default, 52, 6, 52, ML_MAX_LOG);
  if (u < 0) return (int)u;
  h += (size_t)u;
  bwd b;
  if (bwd_init(&b, p + h, n - h)) return ZS_SEQUENCES;
  uint32_t sl = (uint32_t)bwd_read(&b, Z->ll.log);
  uint32_t so = (uint32_t)bwd_read(&b, Z->of.log);
  uint32_t sm = (uint32_t)bwd_read(&b, Z->ml.log);
  for (size_t i = 0; i < nseq; ++i) {
    int llc = Z->ll.t[sl].sym, ofc = Z->of.t[so].sym, mlc = Z->ml.t[sm].sym;
    if (llc > 35 || mlc > 52 || ofc > 31) return ZS_SEQUENCES;
    uint64_t ov = ((uint64_t)1 << ofc) + bwd_read(&b, ofc);
    size_t ml = ml_base[mlc] + (size_t)bwd_read(&b, ml_bits[mlc]);
    size_t ll = ll_base[llc] + (size_t)bwd_read(&b, ll_bits[llc]);
    if (i + 1 < nseq) {
      sl = Z->ll.t[sl].base + (uint32_t)bwd_read(&b, Z->ll.t[sl].nb);
      sm = Z->ml.t[sm].base + (uint32_t)bwd_read(&b, Z->ml.t[sm].nb);
      so = Z->of.t[so].base + (uint32_t)bwd_read(&b, Z->of.t[so].nb);
    }
    if (b.left < 0) return ZS_SEQUENCES;
    uint64_t off;
    uint32_t *r = Z->rep;
    if (ov > 3) {
      off = ov - 3;
      r[2] = r[1];
      r[1] = r[0];
      r[0] = (uint32_t)off;
    } else {
      int idx = (int)ov - 1 + (ll == 0);
      if (idx == 0) {
        off = r[0];
      } else {
        off = idx == 1 ? r[1] : idx == 2 ? r[2] : (uint64_t)r[0] - 1;
        if (off == 0) return ZS_OFFSET;
        if (idx != 1) r[2] = r[1];
        r[1] = r[0];
        r[0] = (uint32_t)off;
      }
    }
    int rc = copy_literals(Z, &li, ll);
    if (rc) return rc;
    if (off > Z->pos - Z->frame_start) return ZS_OFFSET;
    if (ml > Z->cap - Z->pos) return ZS_OUTPUT;
    uint8_t *d = Z->out + Z->pos, *s = d - off;
    if (off >= ml) {
      memcpy(d, s, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) d[k] = s[k];
    }
    Z->pos += ml;
  }
  if (b.left != 0) return ZS_SEQUENCES;
  return copy_literals(Z, &li, Z->nlit - li);
}

static int compressed_block(zctx *Z, const uint8_t *p, size_t n) {
  size_t start = Z->pos;
  long used = read_literals(Z, p, n);
  if (used < 0) return (int)used;
  int rc = read_sequences(Z, p + used, n - (size_t)used);
  if (rc) return rc;
  return Z->pos - start > Z->block_max ? ZS_BLOCK : 0;
}

/* ---- frames ---- */

typedef struct {
  size_t hsize; /* header bytes, magic included */
  int single, checksum;
  uint32_t dict;
  uint64_t window, fcs;
  int has_fcs;
} fheader;

static int frame_header(const uint8_t *p, size_t n, fheader *F) {
  if (n < 5) return ZS_TRUNCATED;
  int fhd = p[4], fcs_flag = fhd >> 6, did_flag = fhd & 3;
  static const int did_size[4] = {0, 1, 2, 4};
  F->single = fhd >> 5 & 1;
  F->checksum = fhd >> 2 & 1;
  if (fhd & 8) return ZS_HEADER;
  int fcs_size = fcs_flag == 0 ? F->single : 1 << fcs_flag;
  size_t h = 5 + !F->single + (size_t)did_size[did_flag] + (size_t)fcs_size;
  if (n < h) return ZS_TRUNCATED;
  const uint8_t *q = p + 5;
  if (!F->single) {
    int e = *q >> 3, m = *q & 7;
    uint64_t base = (uint64_t)1 << (10 + e);
    F->window = base + (base >> 3) * (uint64_t)m;
    ++q;
  }
  F->dict = did_flag == 1   ? q[0]
            : did_flag == 2 ? rd16(q)
            : did_flag == 3 ? rd32(q)
                            : 0;
  q += did_size[did_flag];
  F->has_fcs = fcs_size > 0;
  F->fcs = fcs_size == 1   ? q[0]
           : fcs_size == 2 ? rd16(q) + 256u
           : fcs_size == 4 ? rd32(q)
           : fcs_size == 8 ? rd64(q)
                           : 0;
  if (F->single) F->window = F->fcs;
  F->hsize = h;
  return 0;
}

static int is_skippable(uint32_t magic) {
  return (magic & 0xFFFFFFF0u) == 0x184D2A50u;
}

static long decode_frame(zctx *Z, const uint8_t *p, size_t n, uint64_t *info) {
  fheader F;
  int rc = frame_header(p, n, &F);
  if (rc) return rc;
  if (F.dict) {
    *info = F.dict;
    return ZS_DICTIONARY;
  }
  Z->frame_start = Z->pos;
  Z->block_max = F.window < BLOCK_MAX ? (size_t)F.window : BLOCK_MAX;
  Z->rep[0] = 1;
  Z->rep[1] = 4;
  Z->rep[2] = 8;
  Z->have_ll = Z->have_of = Z->have_ml = Z->have_huf = 0;
  size_t at = F.hsize;
  for (int last = 0; !last;) {
    if (n - at < 3) return ZS_TRUNCATED;
    uint32_t bh = rd24(p + at);
    at += 3;
    last = bh & 1;
    int type = bh >> 1 & 3;
    size_t size = bh >> 3;
    if (type == 3 || size > Z->block_max) return ZS_BLOCK;
    size_t in = type == 1 ? 1 : size;
    if (n - at < in) return ZS_TRUNCATED;
    if (type == 2) {
      rc = compressed_block(Z, p + at, size);
      if (rc) return rc;
    } else {
      if (size > Z->cap - Z->pos) return ZS_OUTPUT;
      if (type == 0)
        memcpy(Z->out + Z->pos, p + at, size);
      else
        memset(Z->out + Z->pos, p[at], size);
      Z->pos += size;
    }
    at += in;
  }
  size_t got = Z->pos - Z->frame_start;
  if (F.has_fcs && got != F.fcs) return ZS_SIZE;
  if (F.checksum) {
    if (n - at < 4) return ZS_TRUNCATED;
    uint64_t h = fl_xxh64(Z->out + Z->frame_start, got, 0);
    if ((uint32_t)h != rd32(p + at)) return ZS_CHECKSUM;
    at += 4;
  }
  return (long)at;
}

/* Decode every frame of src[0..n) into dst[0..cap).  Returns the bytes
 * written, or a negative ZS_ code; on ZS_DICTIONARY, *info is the id. */
long long fl_zstd_decode(const uint8_t *src, size_t n, uint8_t *dst,
                         size_t cap, uint64_t *info) {
  zctx *Z = malloc(sizeof *Z);
  if (!Z) return ZS_NOMEM;
  Z->out = dst;
  Z->cap = cap;
  Z->pos = 0;
  size_t at = 0;
  long long rc = 0;
  if (n == 0) rc = ZS_TRUNCATED;
  while (rc == 0 && at < n) {
    if (n - at < 4) {
      rc = ZS_TRUNCATED;
      break;
    }
    uint32_t magic = rd32(src + at);
    if (is_skippable(magic)) {
      if (n - at < 8) {
        rc = ZS_TRUNCATED;
        break;
      }
      uint64_t len = rd32(src + at + 4);
      if (len > n - at - 8) {
        rc = ZS_TRUNCATED;
        break;
      }
      at += 8 + (size_t)len;
      continue;
    }
    if (magic != 0xFD2FB528u) {
      rc = ZS_MAGIC;
      break;
    }
    long used = decode_frame(Z, src + at, n - at, info);
    if (used < 0)
      rc = used;
    else
      at += (size_t)used;
  }
  if (rc == 0) rc = (long long)Z->pos;
  free(Z);
  return rc;
}

/* The content size the frames of src[0..n) declare, summed: >= 0; -1 if
 * a frame does not declare it; a negative ZS_ code (below -1) if the
 * frames cannot be walked.  Walks the block headers only. */
long long fl_zstd_content_size(const uint8_t *src, size_t n) {
  size_t at = 0;
  long long total = 0;
  int unknown = 0;
  if (n == 0) return ZS_TRUNCATED;
  while (at < n) {
    if (n - at < 4) return ZS_TRUNCATED;
    uint32_t magic = rd32(src + at);
    if (is_skippable(magic)) {
      if (n - at < 8 || rd32(src + at + 4) > n - at - 8) return ZS_TRUNCATED;
      at += 8 + rd32(src + at + 4);
      continue;
    }
    if (magic != 0xFD2FB528u) return ZS_MAGIC;
    fheader F;
    int rc = frame_header(src + at, n - at, &F);
    if (rc) return rc;
    if (!F.has_fcs || F.fcs > ((uint64_t)1 << 62) - (uint64_t)total)
      unknown = 1;
    else
      total += (long long)F.fcs;
    at += F.hsize;
    for (int last = 0; !last;) {
      if (n - at < 3) return ZS_TRUNCATED;
      uint32_t bh = rd24(src + at);
      at += 3;
      last = bh & 1;
      int type = bh >> 1 & 3;
      size_t in = type == 1 ? 1 : bh >> 3;
      if (type == 3) return ZS_BLOCK;
      if (n - at < in) return ZS_TRUNCATED;
      at += in;
    }
    if (F.checksum) {
      if (n - at < 4) return ZS_TRUNCATED;
      at += 4;
    }
  }
  return unknown ? -1 : total;
}
