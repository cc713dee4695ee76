// LINE-MOD sparse template scores on Hopper: K1 (coarse) and K2 (local).
//
// K1 fl_coarse_scores replaces fealess_tpu/ops/score_pallas.py
// _coarse_kernel (launched by _coarse_scores_tpu); contract
// _coarse_scores_xla.  For every template n and decimated position (y, x):
//   out[n, y, x] = sum_{f < nvalid[n]} planes[c[n,f], y + ry[n,f], x + rx[n,f]]
// with reads past the (Hd, Wd) plane contributing 0.
//
// K2 fl_local_scores replaces score_pallas.py _local_kernel (launched by
// _local_scores_tpu); contract _local_scores_xla with _local_prepare.  For
// candidate k, the same sum over a 16 x 16 window at origin
// (px0c, py0c) = (max(px0, 0), max(py0, 0)); features whose row start
// a = py0c + ry lies outside [0, Hd] are dropped, the column start is
// bc = min(px0c + rx, Wd), and reads past the plane contribute 0.
//
// What bounds them on this card: both are gathers of u8 response values
// with integer adds.  At the fixture operating point K1 reads ~1.2e8 plane
// bytes (1024 templates x 1200 positions x ~95 features) from a 1.2 MB
// plane stack that stays in L2, so it is bound by instruction issue and by
// L1/L2 load throughput, not by DRAM bandwidth or arithmetic.  K2 is tiny
// (64 x 256 outputs) and bound by launch latency.
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
// K2 design: one thread per output, accumulating in int32 in table order;
// the candidate's table row is staged once per block in shared memory and
// read as a broadcast by every thread.  The TPU kernels' nibble packing,
// stride-2 preshifted copy, 128-lane relayout and rx buckets are layout
// workarounds for the TPU's vector unit and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoarseRun = 8;        // adjacent x positions a thread
constexpr int kCoarseWords = kCoarseRun / 4;
constexpr int kCoarseMaxThreads = 256;
constexpr int kCoarseFlush = 256;    // features per packed-lane flush
constexpr int kWin = 16;  // LOCAL_WINDOW

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

__global__ void local_scores_kernel(const uint8_t* __restrict__ planes,
                                    int hd, int wd,
                                    const int32_t* __restrict__ tc,
                                    const int32_t* __restrict__ tr,
                                    const int32_t* __restrict__ tx,
                                    const int32_t* __restrict__ bstart,
                                    int nf, int nb1,
                                    const int32_t* __restrict__ px0,
                                    const int32_t* __restrict__ py0,
                                    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* sc = smem;           // channel
  int32_t* sa = smem + nf;      // window start row, -1 = feature dropped
  int32_t* sb = smem + 2 * nf;  // window start column bc
  const int k = blockIdx.x;
  const int nvalid = min(bstart[(size_t)k * nb1 + nb1 - 1], nf);
  const int px0c = max(px0[k], 0);
  const int py0c = max(py0[k], 0);
  const size_t row = (size_t)k * nf;
  for (int f = threadIdx.x; f < nvalid; f += blockDim.x) {
    const int a = py0c + tr[row + f];
    sc[f] = tc[row + f];
    sa[f] = (a >= 0 && a <= hd) ? a : -1;
    sb[f] = min(px0c + tx[row + f], wd);
  }
  __syncthreads();
  const int r = threadIdx.x / kWin;
  const int col = threadIdx.x - r * kWin;
  const size_t plane = (size_t)hd * wd;
  int32_t acc = 0;
  for (int f = 0; f < nvalid; ++f) {
    const int a = sa[f];
    if (a < 0) continue;
    const int yy = a + r;
    const int xx = sb[f] + col;
    if (yy < hd && (unsigned)xx < (unsigned)wd)
      acc += planes[sc[f] * plane + (size_t)yy * wd + xx];
  }
  out[(size_t)k * kWin * kWin + threadIdx.x] = acc;
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

extern "C" int fl_local_scores(const void* planes, int hd, int wd,
                               const void* tc, const void* tr, const void* tx,
                               const void* bstart, int k, int nf, int nb1,
                               const void* px0, const void* py0, void* out,
                               void* stream) {
  size_t smem = 3 * (size_t)nf * sizeof(int32_t);
  local_scores_kernel<<<k, kWin * kWin, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hd, wd,
      static_cast<const int32_t*>(tc), static_cast<const int32_t*>(tr),
      static_cast<const int32_t*>(tx), static_cast<const int32_t*>(bstart),
      nf, nb1, static_cast<const int32_t*>(px0),
      static_cast<const int32_t*>(py0), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
