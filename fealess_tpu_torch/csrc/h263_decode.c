/* H.263 baseline and Sorenson Spark video for io/h263.py: what
 * cv2.VideoCapture returns for the streams cv2.VideoWriter writes with the
 * fourccs H263, U263, h263 and s263 (H.263) and FLV1 (Sorenson Spark, and
 * s263 outside MOV and 3GP), bit for bit.  cv2 decodes them with FFmpeg's
 * h263 and flv decoders (libavcodec 62.28 in cv2 5.0.0, both h263dec) and
 * converts their yuv420p planes to BGR24 with swscale (yuv_bgr.h).  What
 * that writer produces is FFmpeg's own h263 and flv encoders at their
 * defaults: I and P pictures, one quantiser a picture, no GOB headers, no
 * annex of H.263 (ITU-T H.263 clause 5 only), Sorenson's version 1 escape.
 *
 * Host C, no CUDA: built with the host compiler into a shared library at
 * first use (ops/_build.build_host) and called through ctypes.  A decoder
 * keeps the reference picture and the vectors across packets.
 *
 * The stages and the FFmpeg functions they follow:
 *   headers      ff_h263_decode_picture_header: the 22-bit PSC searched
 *                byte by byte, TR, PTYPE (source formats 1-5), PQUANT,
 *                CPM, PEI and PSPARE; ff_flv_decode_picture_header: the
 *                17-bit PSC, the version (0 or 1), TR, the size (8- or
 *                16-bit width and height, or one of five fixed sizes), the
 *                picture type (2, a disposable P picture, is decoded from
 *                the reference and does not replace it), the deblocking
 *                flag (read and not applied, as FFmpeg does), the
 *                quantiser and PEI
 *   macroblocks  ff_h263_decode_mb: COD, MCBPC, CBPY, the 16x16 vector
 *                (h263_mb.h: ff_h263_pred_motion's median,
 *                ff_h263_decode_motion with f_code 1)
 *   blocks       h263_decode_block: INTRADC (8 bits, 255 meaning 128) with
 *                no DC or AC prediction, Table 16 for intra and inter
 *                coefficients, its escape LAST RUN LEVEL with an 8-bit
 *                level (H.263, Sorenson version 0) or a 7- or 11-bit one
 *                picked by a bit (Sorenson version 1), zigzag scan
 *   dequant      H.263: level * 2q + ((q - 1) | 1), the DC times 8
 *                (ff_mpeg1_dc_scale_table), in int16 as FFmpeg's blocks are
 *   motion       h263_mb.h's mpeg_motion, rounding 0 (no rounding type):
 *                FFmpeg's flv encoder lets vectors leave the picture, and
 *                the reference is read at clamped coordinates
 *   output       the picture cropped to its size, yuv420p at limited range
 *                to BGR24 through yuv_bgr.h
 *
 * A tool or kind no stream of that writer holds is refused with its
 * name's code (H263_REFUSED + R_*); a packet the decoder cannot read is
 * H263_CORRUPT, where FFmpeg conceals what follows (its error
 * resilience) or drops the packet.  Every syntax path that is decoded
 * bumps a counter (C_*), so a test holds the committed sources to
 * covering all of them.
 */
#include "h263_mb.h"
#include "simple_idct.h"
#include "yuv_bgr.h"

enum { H263_OK = 0, H263_CORRUPT = -1, H263_NOMEM = -2, H263_REFUSED = 100 };

/* tools and kinds refused, by name in io/h263.py */
enum {
  R_PLUSPTYPE = 1, R_UMV, R_SAC, R_AP, R_PB, R_CPM, R_GOB, R_DQUANT, R_4MV,
  R_STUFFING, R_RESIZE, R_NO_REFERENCE
};

/* syntax paths counted; the last seven are h263_mb.h's MB_* */
enum {
  C_SQCIF, C_QCIF, C_CIF, C_4CIF, C_16CIF, C_VERSION0, C_VERSION1,
  C_SIZE_8BIT, C_SIZE_16BIT, C_SIZE_FIXED, C_DEBLOCK_OFF, C_PEI_SPARE,
  C_IPIC, C_PPIC, C_DISPOSABLE_P, C_I_MB, C_P_INTRA_MB, C_P_INTER_MB,
  C_P_SKIP_MB, C_ESC8, C_ESC7, C_ESC11, C_MV_ZERO_CODE, C_MV_CODED,
  C_MC_FULL, C_MC_X, C_MC_Y, C_MC_XY, C_MC_CLAMPED, C_NPATHS
};

/* ff_h263_format: the sizes of source formats 1-5 */
static const int h263_format[6][2] = {
    {0, 0}, {128, 96}, {176, 144}, {352, 288}, {704, 576}, {1408, 1152}};
/* ff_flv_decode_picture_header's fixed sizes, forms 2-6 */
static const int flv_format[7][2] = {
    {0, 0}, {0, 0}, {352, 288}, {176, 144}, {128, 96}, {320, 240},
    {160, 120}};

typedef struct {
  mb_vlcs_t v;
  mb_t m;
  int sorenson; /* the stream's flavour: 0 H.263, 1 Sorenson Spark */
  int have_size, have_ref;
  /* the picture */
  int flv_version, pframe, droppable;
  uint64_t count[C_NPATHS];
  int refused; /* the R_* of the last refusal */
} h263_t;

static int refuse(h263_t *d, int tool) {
  d->refused = tool;
  return H263_REFUSED + tool;
}

/* skip_1stop_8data_bits: PEI, then PSPARE while PEI is set */
static int pei(h263_t *d, br_t *b) {
  if (br_left(b) <= 0) return H263_CORRUPT;
  while (br_get(b, 1)) {
    ++d->count[C_PEI_SPARE];
    b->pos += 8;
    if (br_left(b) <= 0) return H263_CORRUPT;
  }
  return H263_OK;
}

static int h263_header(h263_t *d, br_t *b, int *w, int *h) {
  uint32_t sc = br_get(b, 14);
  for (long i = br_left(b); i > 24; i -= 8) {
    sc = ((sc << 8) | br_get(b, 8)) & 0x3FFFFF;
    if (sc == 0x20) break;
  }
  if (sc != 0x20) return H263_CORRUPT;
  b->pos += 8; /* TR */
  if (!br_get(b, 1)) return H263_CORRUPT; /* the marker */
  if (br_get(b, 1)) return H263_CORRUPT;  /* the H.263 id */
  b->pos += 3; /* split screen, document camera, freeze picture release */
  int format = (int)br_get(b, 3);
  if (format == 6 || format == 7) return refuse(d, R_PLUSPTYPE);
  if (format == 0) return H263_CORRUPT;
  *w = h263_format[format][0];
  *h = h263_format[format][1];
  d->pframe = (int)br_get(b, 1);
  if (br_get(b, 1)) return refuse(d, R_UMV);
  if (br_get(b, 1)) return refuse(d, R_SAC);
  if (br_get(b, 1)) return refuse(d, R_AP);
  if (br_get(b, 1)) return refuse(d, R_PB);
  d->m.q = (int)br_get(b, 5);
  if (br_get(b, 1)) return refuse(d, R_CPM);
  int rc = pei(d, b);
  if (rc) return rc;
  ++d->count[C_SQCIF + format - 1];
  d->droppable = 0;
  return H263_OK;
}

static int flv_header(h263_t *d, br_t *b, int *w, int *h) {
  if (br_get(b, 17) != 1) return H263_CORRUPT;
  int version = (int)br_get(b, 5);
  if (version > 1) return H263_CORRUPT;
  d->flv_version = version;
  b->pos += 8; /* TR */
  int form = (int)br_get(b, 3);
  if (form == 0 || form == 1) {
    *w = (int)br_get(b, form ? 16 : 8);
    *h = (int)br_get(b, form ? 16 : 8);
  } else if (form < 7) {
    *w = flv_format[form][0];
    *h = flv_format[form][1];
  } else {
    *w = *h = 0;
  }
  if (!*w || !*h) return H263_CORRUPT;
  int type = (int)br_get(b, 2);
  d->pframe = type > 0;
  d->droppable = type > 1; /* B or S in FFmpeg's terms: a P picture */
  int deblocking = (int)br_get(b, 1);
  d->m.q = (int)br_get(b, 5);
  int rc = pei(d, b);
  if (rc) return rc;
  ++d->count[version ? C_VERSION1 : C_VERSION0];
  ++d->count[form == 0 ? C_SIZE_8BIT : form == 1 ? C_SIZE_16BIT
                                                 : C_SIZE_FIXED];
  if (!deblocking) ++d->count[C_DEBLOCK_OFF];
  if (d->droppable) ++d->count[C_DISPOSABLE_P];
  return H263_OK;
}

/* ---- blocks ---- */

static int decode_block(h263_t *d, br_t *b, int n, int coded, int intra) {
  mb_t *m = &d->m;
  int16_t *blk = m->block[n];
  int i = -1, qmul = 1, qadd = 0;
  if (intra) {
    int dc = (int)br_get(b, 8);
    blk[0] = (int16_t)(dc == 255 ? 128 : dc);
    i = 0;
  } else {
    qmul = m->q << 1;
    qadd = (m->q - 1) | 1;
  }
  if (!coded) {
    m->last_index[n] = i;
    return H263_OK;
  }
  for (;;) {
    int s = vlc_get(b, &d->v.inter_tc), run, level, last;
    if (s < 0) return H263_CORRUPT;
    if (s == TC_ESCAPE) {
      if (d->sorenson && d->flv_version) {
        int is11 = (int)br_get(b, 1);
        last = (int)br_get(b, 1);
        run = (int)br_get(b, 6);
        level = br_sbits(b, is11 ? 11 : 7);
        ++d->count[is11 ? C_ESC11 : C_ESC7];
      } else {
        last = (int)br_get(b, 1);
        run = (int)br_get(b, 6);
        level = (int8_t)br_get(b, 8);
        /* H.263 forbids both; FFmpeg reads -128 as RealVideo's
         * extended level, which its h263 encoder never writes */
        if (level == 0 || level == -128) return H263_CORRUPT;
        ++d->count[C_ESC8];
      }
      if (!intra) level = level > 0 ? level * qmul + qadd
                                    : level * qmul - qadd;
    } else {
      last = s >= TC_INTER_LAST;
      run = inter_run[s];
      level = inter_level[s] * qmul + qadd;
      if (br_get(b, 1)) level = -level;
    }
    i += run + 1;
    if (i > 63) return H263_CORRUPT;
    blk[zigzag[i]] = (int16_t)level;
    if (last) break;
  }
  m->last_index[n] = i;
  return H263_OK;
}

/* ---- macroblocks ---- */

static int intra_mb(h263_t *d, br_t *b, int cbpc) {
  mb_t *m = &d->m;
  int cbpy = vlc_get(b, &d->v.cbpy);
  if (cbpy < 0) return H263_CORRUPT;
  int cbp = (cbpc & 3) | (cbpy << 2);
  memset(m->block, 0, sizeof m->block);
  for (int n = 0; n < 6; ++n) {
    int rc = decode_block(d, b, n, cbp & 32, 1);
    if (rc) return rc;
    cbp += cbp;
  }
  mb_set_mv(m, 0, 0);
  mb_put_intra(m, 8, 8);
  return H263_OK;
}

static int inter_mb(h263_t *d, br_t *b, int cbpc) {
  mb_t *m = &d->m;
  int cbpy = vlc_get(b, &d->v.cbpy);
  if (cbpy < 0) return H263_CORRUPT;
  int cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2), px, py, mx, my;
  mb_pred_motion(m, &px, &py);
  int rc = mb_decode_motion(m, b, &d->v.mvd, px, &mx);
  if (!rc) rc = mb_decode_motion(m, b, &d->v.mvd, py, &my);
  if (rc) return rc;
  memset(m->block, 0, sizeof m->block);
  for (int n = 0; n < 6; ++n) {
    rc = decode_block(d, b, n, cbp & 32, 0);
    if (rc) return rc;
    cbp += cbp;
  }
  mb_set_mv(m, mx, my);
  mb_motion(m, mx, my);
  mb_add_inter(m);
  return H263_OK;
}

/* ff_h263_decode_mb's end of slice check after a macroblock that is not
 * the picture's last: sixteen zero bits end FFmpeg's slice there, before a
 * GOB header (refused) or at a packet cut short (corrupt) */
static int after_mb(h263_t *d, br_t *b) {
  long left = br_left(b);
  if (left < 0) return H263_CORRUPT;
  uint32_t v = br_show(b, 16);
  if (left < 16) v >>= 16 - left;
  if (v) return H263_OK;
  br_t t = *b;
  t.pos += 16;
  for (int k = 0; k < 16 && br_left(&t) > 13; ++k)
    if (br_get(&t, 1)) return refuse(d, R_GOB);
  return H263_CORRUPT;
}

static int decode_picture(h263_t *d, br_t *b) {
  mb_t *m = &d->m;
  int w, h;
  int rc = d->sorenson ? flv_header(d, b, &w, &h) : h263_header(d, b, &w, &h);
  if (rc) return rc;
  if (!d->have_size) {
    if (mb_alloc(m, w, h)) return H263_NOMEM;
    d->have_size = 1;
  } else if (w != m->width || h != m->height) {
    return refuse(d, R_RESIZE);
  }
  if (d->pframe && !d->have_ref) return refuse(d, R_NO_REFERENCE);
  if (m->q < 1) m->q = 1; /* ff_set_qscale */
  m->rounding = 0;
  m->fcode = 1;
  ++d->count[d->pframe ? C_PPIC : C_IPIC];
  m->cur = d->have_ref ? m->ref ^ 1 : 0;
  for (m->mb_y = 0; m->mb_y < m->mb_h; ++m->mb_y)
    for (m->mb_x = 0; m->mb_x < m->mb_w; ++m->mb_x) {
      if (!d->pframe) {
        int cbpc = vlc_get(b, &d->v.intra_mcbpc);
        if (cbpc < 0) return H263_CORRUPT;
        if (cbpc == MCBPC_INTRA_STUFFING) return refuse(d, R_STUFFING);
        if (cbpc & 4) return refuse(d, R_DQUANT);
        rc = intra_mb(d, b, cbpc);
        ++d->count[C_I_MB];
      } else if (br_get(b, 1)) { /* COD: not coded */
        mb_set_mv(m, 0, 0);
        memset(m->last_index, 0xff, sizeof m->last_index);
        mb_motion(m, 0, 0);
        ++d->count[C_P_SKIP_MB];
      } else {
        int cbpc = vlc_get(b, &d->v.inter_mcbpc);
        if (cbpc < 0) return H263_CORRUPT;
        if (cbpc == MCBPC_INTER_STUFFING) return refuse(d, R_STUFFING);
        if (cbpc & 8) return refuse(d, R_DQUANT);
        if (cbpc & 16) return refuse(d, R_4MV);
        if (cbpc & 4) {
          rc = intra_mb(d, b, cbpc);
          ++d->count[C_P_INTRA_MB];
        } else {
          rc = inter_mb(d, b, cbpc);
          ++d->count[C_P_INTER_MB];
        }
      }
      if (rc) return rc;
      if (br_left(b) < 0) return H263_CORRUPT;
      if (m->mb_y < m->mb_h - 1 || m->mb_x < m->mb_w - 1) {
        rc = after_mb(d, b);
        if (rc) return rc;
      }
    }
  if (!d->droppable) {
    m->ref = m->cur;
    d->have_ref = 1;
  }
  return H263_OK;
}

/* ---- API ---- */

/* A decoder for H.263 (sorenson 0) or Sorenson Spark (sorenson 1). */
void *fl_h263_open(int sorenson) {
  h263_t *d = (h263_t *)calloc(1, sizeof(h263_t));
  if (!d) return NULL;
  mb_vlcs_build(&d->v);
  d->sorenson = sorenson;
  d->m.paths = d->count + C_MV_ZERO_CODE;
  return d;
}

/* Decode one packet.  H263_OK: a frame (fl_h263_bgr converts it), its size
 * in wh[0..1]; H263_CORRUPT; H263_NOMEM; H263_REFUSED + the tool's R_*. */
int fl_h263_decode(void *h, const uint8_t *data, long n, int *wh) {
  h263_t *d = (h263_t *)h;
  uint8_t *buf = (uint8_t *)calloc((size_t)n + 8, 1);
  if (!buf) return H263_NOMEM;
  memcpy(buf, data, (size_t)n);
  br_t b = {buf, n * 8, 0};
  int rc = decode_picture(d, &b);
  free(buf);
  if (rc) return rc;
  wh[0] = d->m.width;
  wh[1] = d->m.height;
  return H263_OK;
}

/* The last frame as BGR (H, W, 3). */
int fl_h263_bgr(void *h, uint8_t *out) {
  const mb_t *m = &((h263_t *)h)->m;
  yuv_planes_t p = {m->pic[m->cur][0], m->pic[m->cur][1], m->pic[m->cur][2],
                    m->ys, m->cs};
  return yuv_to_bgr(&p, m->width, m->height, 1, 1, 0, out);
}

/* The last frame's planes, cropped: y (H x W), u and v (ceil(H/2) x
 * ceil(W/2)), each packed. */
void fl_h263_planes(void *h, uint8_t *y, uint8_t *u, uint8_t *v) {
  mb_planes(&((h263_t *)h)->m, y, u, v);
}

/* The syntax path counters (C_NPATHS of them) and the last refusal. */
int fl_h263_counts(void *h, uint64_t *out) {
  h263_t *d = (h263_t *)h;
  memcpy(out, d->count, sizeof d->count);
  return d->refused;
}

void fl_h263_close(void *h) {
  h263_t *d = (h263_t *)h;
  if (!d) return;
  mb_free(&d->m);
  free(d);
}
