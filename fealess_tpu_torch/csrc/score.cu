// LINE-MOD sparse template scores on Hopper: K1 (coarse) and K2 (local).
//
// K1 fl_coarse_scores replaces fealess_tpu/ops/score_pallas.py
// _coarse_kernel (launched by _coarse_scores_tpu); contract
// _coarse_scores_xla.  For every template n and decimated position (y, x):
//   out[n, y, x] = sum_{f < nvalid[n]} planes[c[n,f], y + ry[n,f], x + rx[n,f]]
// with reads past the (Hd, Wd) plane contributing 0.
//
// K2 replaces score_pallas.py _local_kernel (launched by
// _local_scores_tpu); contract _local_scores_xla with _local_prepare.  For
// candidate k, the same sum over a 16 x 16 window at origin
// (px0c, py0c) = (max(px0, 0), max(py0, 0)); features whose row start
// a = py0c + ry lies outside [0, Hd] are dropped, the column start is
// bc = min(px0c + rx, Wd), and reads past the plane contribute 0.  One
// kernel serves two entries: fl_local_scores takes the origins and the
// candidates' table rows (K, F); fl_local_refine is one refinement level
// of detector.match_from_planes in one launch: from the candidates' slots
// and level-(l+1) positions it clamps the level-l position (matchClass,
// linemod.cpp:1509-1534), takes the origins x // t - 8, reads the level's
// table row tslot[k] itself, and writes the window's first maximum in
// row-major order (jnp.argmax's rule), the new x, y and nf[tslot, l].
//
// What bounds them on this card: both are gathers of u8 response values
// with integer adds.  At the fixture operating point K1 reads ~7.6e7 plane
// bytes (1024 templates x 1200 positions x 62 live features at level 1)
// from a 1.2 MB plane stack that stays in L2, so it is bound by
// instruction issue and by L1/L2 load throughput, not by DRAM bandwidth
// or arithmetic.  K2 is tiny (64 x 256 outputs, 126 features) and bound
// by latency: a serial walk of the features costs one L2 round trip each.
//
// K1 design: a block scores one template; each thread owns kCoarseRun
// adjacent x positions of one row.  The template's features are staged
// once in shared memory, 8 bytes each ({plane offset c*Hd*Wd + ry*Wd + rx,
// ry << 16 | 8*rx}), so a feature costs one broadcast load.  For every
// feature a thread reads the kCoarseRun plane bytes it needs with
// kCoarseRun/4 + 1 aligned 32-bit loads and a funnel shift, zeroes the
// bytes past the row's end (a mask from Wd - x0 - rx) or the whole run when
// the row y + ry is past Hd (one compare on the packed entry; rx, ry >= 0,
// so those are the only edges), and adds the bytes as packed 16-bit lanes
// (even and odd bytes).  The lanes are flushed into int32 sums every 256
// features, so no lane can overflow for any u8 input.  Integer sums are
// order-free, so the result is bitwise equal to the plain twin.  Loads are
// clamped to the last aligned word of the plane stack: a word that holds
// no byte the thread needs is masked out, and no load leaves the buffer.
//
// K2 design: a block scores one candidate with 256 threads: 8 feature
// slices x 16 window rows x 2 lanes; thread (slice s, row r, lane j) owns
// columns 8j..8j+7 of window row r for features s, s + 8, ...  The block
// first stages the row's table entries as 8 bytes each in shared memory
// ({plane offset of the window row's start c*Hd*Wd + a*Wd + bc; valid
// rows min(Hd - a, 16) << 16 | valid columns min(Wd - bc, 16)}, rows 0
// for a dropped feature), so a feature costs a thread one broadcast load,
// one row compare and 3 aligned 32-bit loads (funnel shifts give its 8
// bytes at any alignment, a mask from the valid columns zeroes the bytes
// past Wd, loads are clamped to the stack's last word as in K1).  A warp
// is one feature's 16 rows, its two lanes a row reading neighbouring
// words, so a load touches 16 plane rows, not the 32 of two features.
// The feature loop is unrolled 4 deep.  (Timed on the fixture's shapes on
// an H100, this mapping and depth beat 16 slices x 16 rows with 5 loads a
// feature, 4 slices x 4 lanes with 2, and unroll depths 1 to 16.)  Bytes
// add into packed 16-bit lanes flushed every 256 features a thread (exact
// for any u8 input); the 8 slices' partial rows are summed in shared
// memory in a fixed order; the fused entry then takes the first maximum
// with a (value desc, index asc) reduction over warp shuffles and the 8
// warps.
// The TPU kernels' nibble packing, stride-2 preshifted copy, 128-lane
// relayout and rx buckets are layout workarounds for the TPU's vector
// unit and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoarseRun = 8;        // adjacent x positions a thread
constexpr int kCoarseWords = kCoarseRun / 4;
constexpr int kCoarseMaxThreads = 256;
constexpr int kCoarseFlush = 256;    // features per packed-lane flush
constexpr int kWin = 16;  // LOCAL_WINDOW
constexpr int kLocalLanes = 2;       // K2 threads a window row
constexpr int kLocalWords = 4 / kLocalLanes;   // 32-bit words a thread
constexpr int kLocalSlices = 8;      // feature slices of a K2 block
constexpr int kLocalThreads = kLocalSlices * kWin * kLocalLanes;
constexpr int kLocalFlush = 256;     // features a thread per lane flush
constexpr int kPartStride = kWin + 1;   // padded partial rows

__global__ void __launch_bounds__(kCoarseMaxThreads)
coarse_scores_kernel(const uint8_t* __restrict__ planes, int hd, int wd,
                     int groups, unsigned last_byte,
                     const int32_t* __restrict__ tc,
                     const int32_t* __restrict__ tr,
                     const int32_t* __restrict__ tx,
                     const int32_t* __restrict__ bstart, int nf, int nb1,
                     int32_t* __restrict__ out) {
  extern __shared__ int2 tab[];
  const int n = blockIdx.x;
  const int nvalid = min(bstart[(size_t)n * nb1 + nb1 - 1], nf);
  const int plane = hd * wd;
  const size_t row = (size_t)n * nf;
  for (int f = threadIdx.x; f < nvalid; f += blockDim.x) {
    const int ry = tr[row + f];
    const int rx = tx[row + f];
    tab[f] = make_int2(tc[row + f] * plane + ry * wd + rx,
                       (ry << 16) | (rx << 3));
  }
  __syncthreads();
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= hd * groups) return;
  const int y = g / groups;
  const int x0 = (g - y * groups) * kCoarseRun;
  // byte offsets are taken from the 4-byte-aligned address at or below
  // `planes`, so that every word load is aligned
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(planes) & 3u);
  const unsigned pos = mis + static_cast<unsigned>(y * wd + x0);
  const unsigned m = pos & 3u;
  const uint8_t* p = planes - mis + (pos - m);
  const unsigned lim = ((mis + last_byte) & ~3u) - (pos - m);
  const int xlim8 = (wd - x0) * 8;
  const int ylim16 = (hd - y) << 16;
  int32_t total[kCoarseRun] = {};
  for (int f0 = 0; f0 < nvalid; f0 += kCoarseFlush) {
    const int f1 = min(f0 + kCoarseFlush, nvalid);
    uint32_t lo[kCoarseWords] = {}, hi[kCoarseWords] = {};
#pragma unroll 4
    for (int f = f0; f < f1; ++f) {
      const int2 e = tab[f];
      // valid bits of the run from its first byte: 8 * (Wd - x0 - rx), or
      // none when the row y + ry is past the plane
      const int n8 = e.y < ylim16 ? xlim8 - (e.y & 0xFFFF) : 0;
      const unsigned t = static_cast<unsigned>(e.x) + m;
      const unsigned a = t & ~3u;
      uint32_t w[kCoarseWords + 1];
#pragma unroll
      for (int j = 0; j <= kCoarseWords; ++j)
        w[j] = *reinterpret_cast<const uint32_t*>(p + min(a + 4u * j, lim));
#pragma unroll
      for (int j = 0; j < kCoarseWords; ++j) {
        const uint32_t mask = __funnelshift_lc(
            0xFFFFFFFFu, 0u, static_cast<unsigned>(max(n8 - 32 * j, 0)));
        const uint32_t v = __funnelshift_r(w[j], w[j + 1], t << 3) & mask;
        lo[j] += v & 0x00FF00FFu;
        hi[j] += (v >> 8) & 0x00FF00FFu;
      }
    }
#pragma unroll
    for (int j = 0; j < kCoarseWords; ++j) {
      total[4 * j] += lo[j] & 0xFFFFu;
      total[4 * j + 1] += hi[j] & 0xFFFFu;
      total[4 * j + 2] += lo[j] >> 16;
      total[4 * j + 3] += hi[j] >> 16;
    }
  }
  int32_t* o = out + (size_t)n * plane + (size_t)y * wd + x0;
#pragma unroll
  for (int k = 0; k < kCoarseRun; ++k)
    if (x0 + k < wd) o[k] = total[k];
}

struct LocalParams {
  const uint8_t* planes;
  int hd, wd;
  unsigned last_byte;
  const int32_t* tc;
  const int32_t* tr;
  const int32_t* tx;
  const int32_t* bstart;
  int nf, nb1;
  const int32_t* px0;    // origins given (fl_local_scores), else null
  const int32_t* py0;
  const int64_t* slot;   // fused (fl_local_refine): table row of each k
  const int32_t* x;      // fused: positions at level l + 1
  const int32_t* y;
  const int32_t* width;  // fused: the bank's (N, L) arrays
  const int32_t* height;
  const int32_t* nfeat;
  int levels, level, t, w, h, offset;
  int32_t* scores;       // (K, 16, 16)
  int32_t* x_out;        // fused: (K,) each
  int32_t* y_out;
  int32_t* best;
  int32_t* nf_out;
};

__global__ void __launch_bounds__(kLocalThreads)
local_scores_kernel(const LocalParams p) {
  extern __shared__ uint2 ltab[];   // staged features, then the partials
  __shared__ int warp_v[kLocalThreads / 32];
  __shared__ int warp_i[kLocalThreads / 32];
  const int k = blockIdx.x;
  int row = k, x = 0, y = 0, px0c, py0c;
  if (p.slot != nullptr) {
    row = static_cast<int>(p.slot[k]);
    const int border = 8 * p.t;
    const size_t at = (size_t)row * p.levels + p.level;
    x = max(min(2 * p.x[k] + 1, p.w - p.width[at] - border), border);
    y = max(min(2 * p.y[k] + 1, p.h - p.height[at] - border), border);
    px0c = x / p.t - 8;   // x >= border = 8t, so >= 0
    py0c = y / p.t - 8;
  } else {
    px0c = max(p.px0[k], 0);
    py0c = max(p.py0[k], 0);
  }
  const size_t trow = (size_t)row * p.nf;
  const int nvalid = min(p.bstart[(size_t)row * p.nb1 + p.nb1 - 1], p.nf);
  const unsigned plane = static_cast<unsigned>(p.hd * p.wd);
  // every entry of the row, so that the table loads need not wait for
  // the valid count; the feature loop reads the first nvalid
  for (int f = threadIdx.x; f < p.nf; f += blockDim.x) {
    const int c = p.tc[trow + f];
    const int a = py0c + p.tr[trow + f];
    const int bc = min(px0c + p.tx[trow + f], p.wd);
    const bool ok = a >= 0 && a <= p.hd;
    const unsigned rows = ok ? min(p.hd - a, kWin) : 0;
    ltab[f] = make_uint2(
        ok ? static_cast<unsigned>(c) * plane +
                 static_cast<unsigned>(a * p.wd + bc)
           : 0u,
        (rows << 16) | static_cast<unsigned>(min(p.wd - bc, kWin)));
  }
  __syncthreads();
  const int j = threadIdx.x % kLocalLanes;
  const int r = threadIdx.x / kLocalLanes % kWin;
  const int s = threadIdx.x / (kLocalLanes * kWin);
  // byte offsets from the 4-byte-aligned address at or below `planes`
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(p.planes) & 3u);
  const uint8_t* base = p.planes - mis;
  const unsigned lim = (mis + p.last_byte) & ~3u;
  // this thread's first byte of the window row
  const unsigned roff = mis + static_cast<unsigned>(r * p.wd) +
                        4u * kLocalWords * j;
  uint32_t total[4 * kLocalWords] = {};
  for (int f0 = s; f0 < nvalid; f0 += kLocalSlices * kLocalFlush) {
    const int f1 = min(f0 + kLocalSlices * kLocalFlush, nvalid);
    uint32_t lo[kLocalWords] = {}, hi[kLocalWords] = {};
#pragma unroll 4
    for (int f = f0; f < f1; f += kLocalSlices) {
      const uint2 e = ltab[f];
      // valid bits of this thread's bytes: none past the plane's last row
      const int n8 = r < static_cast<int>(e.y >> 16)
                         ? 8 * static_cast<int>(e.y & 0xFFFFu) -
                               32 * kLocalWords * j
                         : 0;
      const unsigned pos = e.x + roff;
      const unsigned a = pos & ~3u;
      uint32_t w[kLocalWords + 1];
#pragma unroll
      for (int q = 0; q <= kLocalWords; ++q)
        w[q] = *reinterpret_cast<const uint32_t*>(base + min(a + 4u * q,
                                                             lim));
#pragma unroll
      for (int q = 0; q < kLocalWords; ++q) {
        const uint32_t mask = __funnelshift_lc(
            0xFFFFFFFFu, 0u, static_cast<unsigned>(max(n8 - 32 * q, 0)));
        const uint32_t v = __funnelshift_r(w[q], w[q + 1], pos << 3) & mask;
        lo[q] += v & 0x00FF00FFu;
        hi[q] += (v >> 8) & 0x00FF00FFu;
      }
    }
#pragma unroll
    for (int q = 0; q < kLocalWords; ++q) {
      total[4 * q] += lo[q] & 0xFFFFu;
      total[4 * q + 1] += hi[q] & 0xFFFFu;
      total[4 * q + 2] += lo[q] >> 16;
      total[4 * q + 3] += hi[q] >> 16;
    }
  }
  __syncthreads();   // every thread is done with the staged features
  uint32_t* part = reinterpret_cast<uint32_t*>(ltab);
#pragma unroll
  for (int q = 0; q < 4 * kLocalWords; ++q)
    part[(s * kWin + r) * kPartStride + 4 * kLocalWords * j + q] = total[q];
  __syncthreads();
  const int t = threadIdx.x;
  const int orow = t / kWin;
  const int ocol = t - orow * kWin;
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < kLocalSlices; ++q)
    sum += part[(q * kWin + orow) * kPartStride + ocol];
  p.scores[(size_t)k * kWin * kWin + t] = static_cast<int32_t>(sum);
  if (p.slot == nullptr) return;
  // the first maximum in row-major order: (value desc, index asc)
  int bv = static_cast<int>(sum), bi = t;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_down_sync(0xFFFFFFFFu, bv, o);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((t & 31) == 0) {
    warp_v[t >> 5] = bv;
    warp_i[t >> 5] = bi;
  }
  __syncthreads();
  if (t != 0) return;
  for (int q = 1; q < kLocalThreads / 32; ++q)
    if (warp_v[q] > bv) {   // later warps hold larger indices
      bv = warp_v[q];
      bi = warp_i[q];
    }
  p.best[k] = bv;
  p.x_out[k] = (x / p.t - 8 + bi % kWin) * p.t + p.offset;
  p.y_out[k] = (y / p.t - 8 + bi / kWin) * p.t + p.offset;
  p.nf_out[k] = p.nfeat[(size_t)row * p.levels + p.level];
}

}  // namespace

extern "C" int fl_coarse_scores(const void* planes, int c, int hd, int wd,
                                const void* tc, const void* tr,
                                const void* tx, const void* bstart, int n,
                                int nf, int nb1, void* out, void* stream) {
  const int groups = (wd + kCoarseRun - 1) / kCoarseRun;
  const int threads_needed = hd * groups;
  const int threads =
      min(kCoarseMaxThreads, (threads_needed + 31) / 32 * 32);
  dim3 grid(n, (threads_needed + threads - 1) / threads);
  const size_t smem = (size_t)nf * sizeof(int2);
  const unsigned last_byte = static_cast<unsigned>((size_t)c * hd * wd - 1);
  coarse_scores_kernel<<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hd, wd, groups, last_byte,
      static_cast<const int32_t*>(tc), static_cast<const int32_t*>(tr),
      static_cast<const int32_t*>(tx), static_cast<const int32_t*>(bstart),
      nf, nb1, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

namespace {

int launch_local(const LocalParams& p, int k, size_t nc, void* stream) {
  // the staged features and, after them, the slices' partial rows share
  // one dynamic buffer
  const size_t part = (size_t)kLocalSlices * kWin * kPartStride * 4;
  const size_t smem = nc * sizeof(uint2) > part ? nc * sizeof(uint2) : part;
  local_scores_kernel<<<k, kLocalThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

LocalParams local_params(const void* planes, int c, int hd, int wd,
                         const void* tc, const void* tr, const void* tx,
                         const void* bstart, int nf, int nb1, void* out) {
  LocalParams p = {};
  p.planes = static_cast<const uint8_t*>(planes);
  p.hd = hd;
  p.wd = wd;
  p.last_byte = static_cast<unsigned>((size_t)c * hd * wd - 1);
  p.tc = static_cast<const int32_t*>(tc);
  p.tr = static_cast<const int32_t*>(tr);
  p.tx = static_cast<const int32_t*>(tx);
  p.bstart = static_cast<const int32_t*>(bstart);
  p.nf = nf;
  p.nb1 = nb1;
  p.scores = static_cast<int32_t*>(out);
  return p;
}

}  // namespace

extern "C" int fl_local_scores(const void* planes, int c, int hd, int wd,
                               const void* tc, const void* tr, const void* tx,
                               const void* bstart, int k, int nf, int nb1,
                               const void* px0, const void* py0, void* out,
                               void* stream) {
  LocalParams p = local_params(planes, c, hd, wd, tc, tr, tx, bstart, nf,
                               nb1, out);
  p.px0 = static_cast<const int32_t*>(px0);
  p.py0 = static_cast<const int32_t*>(py0);
  return launch_local(p, k, nf, stream);
}

extern "C" int fl_local_refine(const void* planes, int c, int hd, int wd,
                               const void* tc, const void* tr, const void* tx,
                               const void* bstart, int nf, int nb1,
                               const void* slot, const void* x,
                               const void* y, int k, const void* width,
                               const void* height, const void* nfeat,
                               int levels, int level, int t, int w, int h,
                               int offset, void* scores, void* x_out,
                               void* y_out, void* best, void* nf_out,
                               void* stream) {
  LocalParams p = local_params(planes, c, hd, wd, tc, tr, tx, bstart, nf,
                               nb1, scores);
  p.slot = static_cast<const int64_t*>(slot);
  p.x = static_cast<const int32_t*>(x);
  p.y = static_cast<const int32_t*>(y);
  p.width = static_cast<const int32_t*>(width);
  p.height = static_cast<const int32_t*>(height);
  p.nfeat = static_cast<const int32_t*>(nfeat);
  p.levels = levels;
  p.level = level;
  p.t = t;
  p.w = w;
  p.h = h;
  p.offset = offset;
  p.x_out = static_cast<int32_t*>(x_out);
  p.y_out = static_cast<int32_t*>(y_out);
  p.best = static_cast<int32_t*>(best);
  p.nf_out = static_cast<int32_t*>(nf_out);
  return launch_local(p, k, nf, stream);
}
