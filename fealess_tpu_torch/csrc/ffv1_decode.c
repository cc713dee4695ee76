/* FFV1 (RFC 9043) frames for io/ffv1.py, as FFmpeg's ffv1 decoder decodes
 * them under cv2.VideoCapture: what FFmpeg's encoder writes for
 * cv2.VideoWriter's "FFV1" fourcc.  That is version 3 (any micro version),
 * Golomb-Rice coding of the samples (coder 0) with range-coded headers,
 * RGB (colourspace 1) at 8 bits, with or without an alpha plane, in any
 * slice layout, with slice CRCs or without; non-key frames carry the
 * context states of the frame before.  The decoder's bgr0 / bgra output is
 * returned as BGR24, as sws_scale converts it; the codec is lossless, so
 * there is no arithmetic to match past the entropy decoding.
 *
 * Host C, no CUDA: built with the host compiler at first use
 * (ops/_build.build_host) and called through ctypes.
 *
 * The functions followed (libavcodec): rangecoder.[ch] (ff_init_range_decoder,
 * ff_build_rac_states, get_rac), ffv1dec.c (read_extra_header,
 * read_quant_tables, decode_frame, decode_slice_header, decode_slice,
 * get_vlc_symbol), ffv1dec_template.c (decode_line, decode_rgb_frame),
 * ffv1_template.c (get_context, predict), golomb.h (get_sr_golomb with
 * limit 12), ffv1.c (ff_ffv1_clear_slice_state, ff_log2_run).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum {
  FV_OK = 0,
  FV_VERSION = 1,    /* a version other than 3 */
  FV_CODER = 2,      /* range-coded samples */
  FV_COLOURSPACE = 3, /* YUV, or RGB past 8 bits */
  FV_BAD = -1,       /* corrupt data */
  FV_CRC = -2,       /* a CRC differs */
  FV_NOMEM = -3,
  FV_KEY = -4,       /* a non-key frame before any key frame */
};

#define CONTEXT_SIZE 32
#define MAX_QUANT_TABLES 8
#define MAX_SLICES 1024
#define MAX_PLANES 3

/* ---- the range coder ---- */

typedef struct {
  const uint8_t *start, *pos, *end;
  unsigned low, range;
  int overread;
  uint8_t zero[256], one[256];
} rac_t;

static void build_states(rac_t *c) {
  const int64_t one = 1LL << 32, factor = (int64_t)(0.05 * (1LL << 32));
  const int max_p = 256 - 8;
  int64_t p;
  int last_p8 = 0, p8;
  memset(c->zero, 0, sizeof c->zero);
  memset(c->one, 0, sizeof c->one);
  p = one / 2;
  for (int i = 0; i < 128; i++) {
    p8 = (int)((256 * p + one / 2) >> 32);
    if (p8 <= last_p8) p8 = last_p8 + 1;
    if (last_p8 && last_p8 < 256 && p8 <= max_p) c->one[last_p8] = (uint8_t)p8;
    p += ((one - p) * factor + one / 2) >> 32;
    last_p8 = p8;
  }
  for (int i = 256 - max_p; i <= max_p; i++) {
    if (c->one[i]) continue;
    p = (i * one + 128) >> 8;
    p += ((one - p) * factor + one / 2) >> 32;
    p8 = (int)((256 * p + one / 2) >> 32);
    if (p8 <= i) p8 = i + 1;
    if (p8 > max_p) p8 = max_p;
    c->one[i] = (uint8_t)p8;
  }
  for (int i = 1; i < 255; i++) c->zero[i] = (uint8_t)(256 - c->one[256 - i]);
}

static void rac_init(rac_t *c, const uint8_t *buf, long n) {
  c->start = c->pos = buf;
  c->end = buf + n;
  c->range = 0xFF00;
  c->overread = 0;
  c->low = n >= 2 ? (unsigned)(buf[0] << 8 | buf[1]) : 0xFF00;
  c->pos += 2;
  if (c->low >= 0xFF00) {
    c->low = 0xFF00;
    c->end = c->pos;
  }
  build_states(c);
}

static inline void refill(rac_t *c) {
  if (c->range < 0x100) {
    c->range <<= 8;
    c->low <<= 8;
    if (c->pos < c->end) {
      c->low += *c->pos;
      c->pos++;
    } else {
      c->overread++;
    }
  }
}

static inline int get_rac(rac_t *c, uint8_t *state) {
  unsigned range1 = (c->range * (*state)) >> 8;
  c->range -= range1;
  if (c->low < c->range) {
    *state = c->zero[*state];
    refill(c);
    return 0;
  }
  c->low -= c->range;
  *state = c->one[*state];
  c->range = range1;
  refill(c);
  return 1;
}

static int get_symbol(rac_t *c, uint8_t *state, int is_signed) {
  if (get_rac(c, state + 0)) return 0;
  int e = 0;
  while (get_rac(c, state + 1 + (e < 9 ? e : 9))) {
    e++;
    if (e > 31) return -(1 << 30); /* AVERROR_INVALIDDATA */
  }
  unsigned a = 1;
  for (int i = e - 1; i >= 0; i--)
    a += a + get_rac(c, state + 22 + (i < 9 ? i : 9));
  int neg = is_signed && get_rac(c, state + 11 + (e < 10 ? e : 10));
  return neg ? -(int)a : (int)a;
}

/* ---- CRC-32, polynomial 0x04C11DB7, MSB first (AV_CRC_32_IEEE) ---- */

static void crc_init(uint32_t *table) {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i << 24;
    for (int k = 0; k < 8; k++)
      c = (c << 1) ^ ((c & 0x80000000u) ? 0x04C11DB7u : 0);
    table[i] = c;
  }
}

static uint32_t crc32(const uint32_t *table, const uint8_t *p, long n) {
  uint32_t crc = 0;
  for (long i = 0; i < n; i++) crc = (crc << 8) ^ table[(crc >> 24) ^ p[i]];
  return crc;
}

/* ---- the bit reader and Golomb-Rice codes ---- */

/* MSB first; bits past the end read as zero */
typedef struct {
  const uint8_t *d;
  long nbits, at;
} bits_t;

/* the 32 bits from the reader's position */
static inline uint32_t peek32(const bits_t *b) {
  long byte = b->at >> 3, n = b->nbits >> 3;
  uint64_t v = 0;
  if (byte + 5 <= n) {
    const uint8_t *p = b->d + byte;
    v = (uint64_t)p[0] << 32 | (uint64_t)p[1] << 24 | (uint64_t)p[2] << 16 |
        (uint64_t)p[3] << 8 | p[4];
  } else {
    for (int k = 0; k < 5; k++)
      v = v << 8 | (byte + k < n ? b->d[byte + k] : 0);
  }
  return (uint32_t)(v >> (8 - (b->at & 7)));
}

static inline int get_bit(bits_t *b) {
  int v = (int)(peek32(b) >> 31);
  b->at++;
  return v;
}

/* n <= 24 */
static inline unsigned get_bits(bits_t *b, int n) {
  if (n == 0) return 0;
  unsigned v = peek32(b) >> (32 - n);
  b->at += n;
  return v;
}

/* get_ur_golomb(gb, k, 12, esc_len): q zeros, a one and k bits when q is
 * below the limit, else the limit's zeros and esc_len bits */
static unsigned get_ur_golomb(bits_t *b, int k, int esc_len) {
  const int limit = 12;
  uint32_t v = peek32(b);
  int q = v ? __builtin_clz(v) : 32;
  if (q < limit) {
    b->at += q + 1;
    return ((unsigned)q << k) + get_bits(b, k);
  }
  b->at += limit;
  return get_bits(b, esc_len) + limit - 1;
}

typedef struct {
  int16_t drift;
  uint16_t error_sum;
  int8_t bias;
  uint8_t count;
} vlc_t;

static inline int fold(int diff, int bits) {
  if (bits == 8) return (int8_t)diff;
  unsigned shift = 32 - bits;
  return (int)((unsigned)diff << shift) >> shift;
}

static void update_vlc_state(vlc_t *s, int v) {
  int drift = s->drift, count = s->count;
  s->error_sum += (uint16_t)(v < 0 ? -v : v);
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;
    s->error_sum >>= 1;
  }
  count++;
  if (drift <= -count) {
    s->bias = (int8_t)(s->bias - 1 > -128 ? s->bias - 1 : -128);
    drift = drift + count > -count + 1 ? drift + count : -count + 1;
  } else if (drift > 0) {
    s->bias = (int8_t)(s->bias + 1 < 127 ? s->bias + 1 : 127);
    drift = drift - count < 0 ? drift - count : 0;
  }
  s->drift = (int16_t)drift;
  s->count = (uint8_t)count;
}

static int get_vlc_symbol(bits_t *b, vlc_t *s, int bits) {
  int k = 0, i = s->count;
  while (i < s->error_sum) {
    k++;
    i += i;
  }
  unsigned u = get_ur_golomb(b, k, bits);
  int v = (int)((u >> 1) ^ -(u & 1));
  v ^= ((2 * s->drift + s->count) >> 31);
  int ret = fold(v + s->bias, bits);
  update_vlc_state(s, v);
  return ret;
}

static const uint8_t log2_run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  2,  2,  3,  3,  3,  3,  4,  4,  5,  5, 6,
    6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

/* ---- the stream ---- */

typedef struct {
  int quant_table_index, context_count;
  vlc_t *vlc;
} plane_t;

typedef struct {
  plane_t plane[MAX_PLANES];
  int x, y, w, h;
} slice_t;

typedef struct {
  int width, height;
  int version, micro, ac, colourspace, bits, chroma_planes, transparency;
  int plane_count, num_h, num_v, ec, intra;
  int quant_table_count;
  int16_t quant[MAX_QUANT_TABLES][5][256];
  int context_count[MAX_QUANT_TABLES];
  int key_ok;
  uint32_t crc[256];
  slice_t slices[MAX_SLICES];
  int16_t *sample;   /* 8 rows of (w + 6) */
  long sample_len;
} ffv1_t;

static int read_quant_table(rac_t *c, int16_t *table, int scale) {
  uint8_t state[CONTEXT_SIZE];
  int v, i = 0;
  memset(state, 128, sizeof state);
  for (v = 0; i < 128; v++) {
    unsigned len = (unsigned)get_symbol(c, state, 0) + 1u;
    if (len > (unsigned)(128 - i) || !len) return -1;
    while (len--) table[i++] = (int16_t)(scale * v);
  }
  for (i = 1; i < 128; i++) table[256 - i] = (int16_t)-table[i];
  table[128] = (int16_t)-table[127];
  return 2 * v - 1;
}

static int read_quant_tables(rac_t *c, int16_t table[5][256]) {
  int count = 1;
  for (int i = 0; i < 5; i++) {
    int r = read_quant_table(c, table[i], count);
    if (r < 0) return -1;
    count *= r;
    if ((unsigned)count > 32768u) return -1;
  }
  return (count + 1) / 2;
}

/* read_extra_header: the configuration record */
static int read_extra(ffv1_t *f, const uint8_t *d, long n, int *info) {
  rac_t c;
  uint8_t state[CONTEXT_SIZE];
  if (n < 4) return FV_BAD;
  crc_init(f->crc);
  rac_init(&c, d, n);
  memset(state, 128, sizeof state);
  f->version = get_symbol(&c, state, 0);
  info[1] = f->version;
  if (f->version != 3) return FV_VERSION;
  c.end -= 4;
  f->micro = get_symbol(&c, state, 0);
  f->ac = get_symbol(&c, state, 0);
  info[2] = f->ac;
  if (f->ac != 0) return FV_CODER;
  f->colourspace = get_symbol(&c, state, 0);
  f->bits = get_symbol(&c, state, 0);
  f->chroma_planes = get_rac(&c, state);
  int hs = get_symbol(&c, state, 0), vs = get_symbol(&c, state, 0);
  f->transparency = get_rac(&c, state);
  info[3] = f->colourspace;
  info[4] = f->bits;
  info[5] = f->transparency;
  if (f->colourspace != 1 || f->bits != 8 || hs || vs || !f->chroma_planes)
    return FV_COLOURSPACE;
  f->plane_count = 2 + f->transparency;
  f->num_h = 1 + get_symbol(&c, state, 0);
  f->num_v = 1 + get_symbol(&c, state, 0);
  if (f->num_h < 1 || f->num_v < 1 || f->num_h > f->width ||
      f->num_v > f->height || f->num_h > MAX_SLICES / f->num_v)
    return FV_BAD;
  f->quant_table_count = get_symbol(&c, state, 0);
  if (f->quant_table_count < 1 || f->quant_table_count > MAX_QUANT_TABLES)
    return FV_BAD;
  for (int i = 0; i < f->quant_table_count; i++) {
    f->context_count[i] = read_quant_tables(&c, f->quant[i]);
    if (f->context_count[i] < 0) return FV_BAD;
  }
  /* initial states: the range coder's only; Golomb-Rice ignores them */
  uint8_t state2[CONTEXT_SIZE][CONTEXT_SIZE];
  for (int i = 0; i < f->quant_table_count; i++)
    if (get_rac(&c, state)) {
      memset(state2, 128, sizeof state2);
      for (int j = 0; j < f->context_count[i]; j++)
        for (int k = 0; k < CONTEXT_SIZE; k++) get_symbol(&c, state2[k], 1);
    }
  f->ec = get_symbol(&c, state, 0);
  if (f->micro >= 3) f->intra = get_symbol(&c, state, 0);
  if (crc32(f->crc, d, n) != 0) return FV_CRC;
  return FV_OK;
}

static inline int mid_pred(int a, int b, int c) {
  if (a > b) {
    int t = a;
    a = b;
    b = t;
  }
  if (b > c) b = c;
  return a > b ? a : b;
}

/* decode_line with Golomb-Rice coding, 9-bit samples (RGB at 8 bits) */
static int decode_line(ffv1_t *f, plane_t *p, bits_t *gb, int w,
                       int16_t *sample[2], int *run_index_io) {
  const int bits = 9;
  int16_t(*q)[256] = f->quant[p->quant_table_index];
  int run_count = 0, run_mode = 0, run_index = *run_index_io;
  if (gb->nbits - gb->at < 1) return FV_BAD;
  for (int x = 0; x < w; x++) {
    if (!(x & 1023) && gb->nbits - gb->at < 1) return FV_BAD;
    const int16_t *src = sample[1] + x, *last = sample[0] + x;
    int LT = last[-1], T = last[0], RT = last[1], L = src[-1];
    int context;
    if (q[3][127] || q[4][127]) {
      int TT = src[0], LL = src[-2];
      context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] +
                q[2][(T - RT) & 0xFF] + q[3][(LL - L) & 0xFF] +
                q[4][(TT - T) & 0xFF];
    } else {
      context = q[0][(L - LT) & 0xFF] + q[1][(LT - T) & 0xFF] +
                q[2][(T - RT) & 0xFF];
    }
    int sign = 0;
    if (context < 0) {
      context = -context;
      sign = 1;
    }
    if (context >= p->context_count) return FV_BAD;
    int diff;
    if (context == 0 && run_mode == 0) run_mode = 1;
    if (run_mode) {
      if (run_count == 0 && run_mode == 1) {
        if (get_bit(gb)) {
          run_count = 1 << log2_run[run_index];
          if (x + run_count <= w) run_index++;
        } else {
          run_count = log2_run[run_index]
                          ? (int)get_bits(gb, log2_run[run_index])
                          : 0;
          if (run_index) run_index--;
          run_mode = 2;
        }
        if (run_index > 40) return FV_BAD;
      }
      run_count--;
      if (run_count < 0) {
        run_mode = 0;
        run_count = 0;
        diff = get_vlc_symbol(gb, &p->vlc[context], bits);
        if (diff >= 0) diff++;
      } else {
        diff = 0;
      }
    } else {
      diff = get_vlc_symbol(gb, &p->vlc[context], bits);
    }
    if (sign) diff = (int)(-(unsigned)diff);
    int pred = mid_pred(L, L + T - LT, T);
    sample[1][x] = (int16_t)((unsigned)(pred + diff) & ((1u << bits) - 1));
  }
  *run_index_io = run_index;
  return FV_OK;
}

static void clear_slice(ffv1_t *f, slice_t *s) {
  for (int i = 0; i < f->plane_count; i++) {
    plane_t *p = &s->plane[i];
    for (int j = 0; j < p->context_count; j++) {
      p->vlc[j].drift = 0;
      p->vlc[j].error_sum = 4;
      p->vlc[j].bias = 0;
      p->vlc[j].count = 1;
    }
  }
}

/* decode_slice_header + decode_slice + decode_rgb_frame */
static int decode_slice(ffv1_t *f, slice_t *s, rac_t *c, int key,
                        uint8_t *out) {
  uint8_t state[CONTEXT_SIZE];
  memset(state, 128, sizeof state);
  int sx = get_symbol(c, state, 0), sy = get_symbol(c, state, 0);
  int sw = get_symbol(c, state, 0) + 1, sh = get_symbol(c, state, 0) + 1;
  if (sx < 0 || sy < 0 || sw <= 0 || sh <= 0 || sx > f->num_h - sw ||
      sy > f->num_v - sh)
    return FV_BAD;
  s->x = (int)((int64_t)f->width * sx / f->num_h);
  s->y = (int)((int64_t)f->height * sy / f->num_v);
  s->w = (int)((int64_t)f->width * (sx + sw) / f->num_h) - s->x;
  s->h = (int)((int64_t)f->height * (sy + sh) / f->num_v) - s->y;
  for (int i = 0; i < f->plane_count; i++) {
    plane_t *p = &s->plane[i];
    int idx = get_symbol(c, state, 0);
    if (idx < 0 || idx >= f->quant_table_count) return FV_BAD;
    int count = f->context_count[idx];
    if (p->context_count < count) {
      free(p->vlc);
      p->vlc = calloc((size_t)count, sizeof(vlc_t));
      if (!p->vlc) return FV_NOMEM;
    }
    p->quant_table_index = idx;
    p->context_count = count;
  }
  get_symbol(c, state, 0); /* picture structure */
  get_symbol(c, state, 0); /* sample aspect ratio */
  get_symbol(c, state, 0);
  if (key)
    clear_slice(f, s);
  if (f->version > 3 || f->micro > 1) {
    uint8_t s129 = 129;
    get_rac(c, &s129);
  }
  long ac_bytes = (long)(c->pos - c->start) - 1;
  bits_t gb = {c->start + ac_bytes, 8 * ((long)(c->end - c->start) - ac_bytes),
               0};
  int w = s->w, h = s->h;
  long need = 8L * (w + 6);
  if (need > f->sample_len) {
    free(f->sample);
    f->sample = malloc((size_t)need * sizeof(int16_t));
    if (!f->sample) {
      f->sample_len = 0;
      return FV_NOMEM;
    }
    f->sample_len = need;
  }
  int16_t *sample[4][2];
  for (int x = 0; x < 4; x++) {
    sample[x][0] = f->sample + x * 2 * (w + 6) + 3;
    sample[x][1] = f->sample + (x * 2 + 1) * (w + 6) + 3;
  }
  memset(f->sample, 0, (size_t)need * sizeof(int16_t));
  int run_index = 0, planes = 3 + f->transparency;
  for (int y = 0; y < h; y++) {
    for (int p = 0; p < planes; p++) {
      int16_t *t = sample[p][0];
      sample[p][0] = sample[p][1];
      sample[p][1] = t;
      sample[p][1][-1] = sample[p][0][0];
      sample[p][0][w] = sample[p][0][w - 1];
      int rc = decode_line(f, &s->plane[(p + 1) / 2], &gb, w, sample[p],
                           &run_index);
      if (rc) return rc;
    }
    uint8_t *o = out + ((size_t)(s->y + y) * f->width + s->x) * 3;
    for (int x = 0; x < w; x++) {
      int g = sample[0][1][x], b = sample[1][1][x], r = sample[2][1][x];
      int a = f->transparency ? sample[3][1][x] : 0;
      b -= 256;
      r -= 256;
      g -= (b + r) >> 2;
      b += g;
      r += g;
      uint32_t v = (uint32_t)b + ((unsigned)g << 8) + ((unsigned)r << 16) +
                   ((unsigned)a << 24);
      o[3 * x] = (uint8_t)v;
      o[3 * x + 1] = (uint8_t)(v >> 8);
      o[3 * x + 2] = (uint8_t)(v >> 16);
    }
  }
  return FV_OK;
}

/* ---- entry points ---- */

/* The decoder for a stream of width x height with this configuration
 * record; info: [0] return code, [1] version, [2] coder, [3] colourspace,
 * [4] bits, [5] transparency.  NULL on a code other than FV_OK. */
void *fl_ffv1_open(const uint8_t *extra, long n, int width, int height,
                   int *info) {
  ffv1_t *f = calloc(1, sizeof *f);
  if (!f) {
    info[0] = FV_NOMEM;
    return NULL;
  }
  f->width = width;
  f->height = height;
  info[0] = width > 0 && height > 0 ? read_extra(f, extra, n, info) : FV_BAD;
  if (info[0] != FV_OK) {
    free(f);
    return NULL;
  }
  return f;
}

void fl_ffv1_close(void *handle) {
  ffv1_t *f = handle;
  if (!f) return;
  for (int i = 0; i < MAX_SLICES; i++)
    for (int j = 0; j < MAX_PLANES; j++) free(f->slices[i].plane[j].vlc);
  free(f->sample);
  free(f);
}

/* decode_frame: one frame into out, BGR (height, width, 3) */
int fl_ffv1_decode(void *handle, const uint8_t *buf, long n, uint8_t *out) {
  ffv1_t *f = handle;
  rac_t c;
  if (n < 2) return FV_BAD;
  rac_init(&c, buf, n);
  uint8_t keystate = 128;
  int key = get_rac(&c, &keystate);
  if (key)
    f->key_ok = 1;
  else if (!f->key_ok)
    return FV_KEY;
  /* the slices' sizes, from the trailers at the end */
  int trailer = 3 + 5 * !!f->ec, count = 0;
  const uint8_t *p = buf + n;
  long starts[MAX_SLICES], sizes[MAX_SLICES];
  while (count < MAX_SLICES && trailer < p - buf) {
    long size =
        (long)p[-trailer] << 16 | p[-trailer + 1] << 8 | p[-trailer + 2];
    if (size + trailer > p - buf) break;
    p -= size + trailer;
    count++;
  }
  if (count == 0) return FV_BAD;
  /* decode_frame's loop from the last slice back */
  const uint8_t *bp = buf + n;
  for (int i = count - 1; i >= 0; i--) {
    long v = ((long)bp[-trailer] << 16 | bp[-trailer + 1] << 8 |
              bp[-trailer + 2]) + trailer;
    if (bp - buf < v) return FV_BAD;
    bp -= v;
    if (f->ec && crc32(f->crc, bp, v) != 0) return FV_CRC;
    starts[i] = bp - buf;
    sizes[i] = v;
  }
  if (starts[0] != 0) return FV_BAD;
  for (int i = 0; i < count; i++) {
    rac_t sc;
    if (i == 0) {
      sc = c;
      sc.end = buf + sizes[0];
    } else {
      rac_init(&sc, buf + starts[i], sizes[i]);
    }
    int rc = decode_slice(f, &f->slices[i], &sc, key, out);
    if (rc) return rc;
  }
  return FV_OK;
}
