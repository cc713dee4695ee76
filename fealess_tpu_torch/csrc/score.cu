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
// plane stack that stays in L2, so it is bound by L1/L2 load throughput and
// by latency, not by DRAM bandwidth or arithmetic.  K2 is tiny (64 x 256
// outputs) and bound by launch latency.
//
// Design: one thread per output, accumulating in int32 in table order, so
// the result is bitwise equal to the plain twin; the template's (or
// candidate's) table row is staged once per block in shared memory and
// read as a broadcast by every thread.  The TPU kernel's nibble packing,
// stride-2 preshifted copy, 128-lane relayout and rx buckets are layout
// workarounds for the TPU's vector unit and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoarseThreads = 256;
constexpr int kWin = 16;  // LOCAL_WINDOW

__global__ void coarse_scores_kernel(const uint8_t* __restrict__ planes,
                                     int hd, int wd,
                                     const int32_t* __restrict__ tc,
                                     const int32_t* __restrict__ tr,
                                     const int32_t* __restrict__ tx,
                                     const int32_t* __restrict__ bstart,
                                     int nf, int nb1,
                                     int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int32_t* sc = smem;
  int32_t* sr = smem + nf;
  int32_t* sx = smem + 2 * nf;
  const int n = blockIdx.x;
  const int nvalid = min(bstart[(size_t)n * nb1 + nb1 - 1], nf);
  const size_t row = (size_t)n * nf;
  for (int f = threadIdx.x; f < nvalid; f += blockDim.x) {
    sc[f] = tc[row + f];
    sr[f] = tr[row + f];
    sx[f] = tx[row + f];
  }
  __syncthreads();
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= hd * wd) return;
  const int y = p / wd;
  const int x = p - y * wd;
  const size_t plane = (size_t)hd * wd;
  int32_t acc = 0;
  for (int f = 0; f < nvalid; ++f) {
    const int yy = y + sr[f];
    const int xx = x + sx[f];
    if ((unsigned)yy < (unsigned)hd && (unsigned)xx < (unsigned)wd)
      acc += planes[sc[f] * plane + (size_t)yy * wd + xx];
  }
  out[(size_t)n * plane + p] = acc;
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

extern "C" int fl_coarse_scores(const void* planes, int hd, int wd,
                                const void* tc, const void* tr,
                                const void* tx, const void* bstart, int n,
                                int nf, int nb1, void* out, void* stream) {
  dim3 grid(n, (hd * wd + kCoarseThreads - 1) / kCoarseThreads);
  size_t smem = 3 * (size_t)nf * sizeof(int32_t);
  coarse_scores_kernel<<<grid, kCoarseThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(planes), hd, wd,
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
