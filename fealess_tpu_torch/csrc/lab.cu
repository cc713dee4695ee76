// Kernel-lab variants on Hopper: L1-L4, the four Pallas calls of
// benchmarks/kernel_lab.py, each measured beside the served kernel it
// varies (K1, K2 in score.cu; K3 in nn.cu).  Nothing on a serving path
// launches them (ops/lab.py, apps/kernel_lab.py).
//
// L1 fl_lab_coarse replaces kernel_lab.py:138 coarse_run (kernel
// _coarse_variant :89, pallas_call :151); L2 fl_lab_coarse_stride2
// replaces :195 coarse_run_stride2 (kernel :168, call :226).  Contract:
// K1's sum, out[n, y, x] = sum of planes[c, y + ry, x + col] over the
// features the walk reads, reads past the (Hd, Wd) plane 0.  The walk goes
// bucket by bucket over the bucket starts (N, NBK+1): bucket j holds rows
// [starts[j], starts[j+1]) of the table and is read at col = stride * j +
// rx % stride.  L1 (stride 1) reads the table's starts; on a bucketed
// table (rx == b in bucket b) col is the feature's rx and the sum is K1's.
// Modes (ops/lab.MODES): base; skipempty (an empty bucket is skipped
// before its set-up); unroll2 (two features an iteration; even starts);
// halftrip (rows [lo, lo + (hi - lo) / 2) of each bucket); noshift (no
// byte alignment and no mask: the aligned words holding the run,
// unshifted; wrong by design).  L2 (stride 2) reads the lab's stride-2
// starts over a stack of two copies, the planes and the planes shifted
// one column (out[..., x] = in[..., x + 1], 0 at Wd - 1): an odd-rx
// feature's offset moves by one copy, so both columns of a bucket share
// one alignment.
//
// L3 fl_lab_local replaces kernel_lab.py:419 _local_variant_run (call
// :467).  Contract: K2's (score.cu, fl_local_scores), the 16 x 16 window
// sums at origins (max(px0, 0), max(py0, 0)), features whose row start
// a = py0c + ry lies outside [0, Hd] dropped, column start min(px0c + col,
// Wd), reads past the plane 0; col as above, at stride 1 (the table's
// starts over the planes) or 2 (_bucket_starts(bstart, 2) over the
// two-copy stack); use_cond skips empty buckets.
//
// L4 fl_lab_nn_mma replaces kernel_lab.py:690 nn_mxu (kernel
// _nn_mxu_kernel :664, call :702).  Contract: per query i, the first j
// minimising d2 = (|q_i|^2 + |r_j|^2) - 2 q_i.r_j, with the dot at float32
// accuracy, and that d2; near-ties may pick another index than K3's
// elementwise d2 (the lab's rule: idx equal or |d2 - d2_K3| <= 1e-3 *
// max(d2_K3, 1)).
//
// What bounds them on this card.  L1/L2 are K1's work (one integer add per
// live feature and output position, ~7.6e7 at the lab's 1024 x 30 x 40 x
// ~26 features) out of an L2-resident 1.2 MB plane stack: instruction
// issue and L1/L2 load throughput, as K1.  The bucket walk adds a set-up
// and a flush per bucket (13 at the lab's shapes, ~2 features each).  L3
// is K2's tiny work (64 windows), bound by latency.  L4 at 16384 x 16384
// is 2.7e8 pairs: the dot's three TF32 passes (6 operations a pair each)
// take ~0.01 ms at 495 TFLOP/s, the float32 epilogue (add of the norms,
// the scaled dot, compare, select: ~5 a pair) ~0.02 ms at 67 TFLOP/s, so
// the epilogue on the CUDA cores is the bound.
//
// L1/L2 design: K1's mapping (a block a template, a thread kRun adjacent x
// positions of a row, the table staged in shared memory, kRun/4 + 1
// aligned 32-bit loads and a funnel shift a feature, bytes added as packed
// 16-bit lanes).  What changes is the walk: the bucket starts are staged
// too, and a bucket's column, alignment and row-end masks for x0 + col
// are worked out once per bucket (the Hopper meaning of the TPU's
// per-bucket lane shift).  Where Wd is a multiple of 4 every staged
// offset (c*Hd*Wd + ry*Wd, plus a copy for odd rx) is too, so the funnel
// shift amount and the aligned start are per bucket; otherwise the shift
// is taken per feature as in K1.  A feature then costs a broadcast load,
// an add, the loads and shifts, and a row compare that selects the
// bucket's mask or 0.  The packed lanes are flushed into int32 totals at
// the end of each bucket (and every kFlush features within one), so no
// lane overflows for any u8 input; integer sums are order-free, so the
// results are bitwise equal to the twins.
//
// L3 design: K2's block (256 threads: 8 slices x 16 window rows x 2 lanes,
// 8 window columns a thread, 3 word loads and funnel shifts a feature,
// partial rows summed in shared memory in a fixed order).  A slice walks
// whole buckets (s, s + 8, ...): the window columns' start, alignment and
// masks are set once per bucket, the row gate per feature.
//
// L4 design: the dot on the tensor cores, in the kernel's own body.  A
// block of tq threads holds tq queries (a warp 32: two m16 tiles) and
// scans tr reference rows, staged kStage at a time in shared memory as
// (x, y, z, 0) split into TF32 high and low parts (cvt.rna) and |r|^2.
// For every 8 reference rows a warp issues, per m16 tile, three
// mma.sync.m16n8k8 TF32 products with float32 accumulation (lo.hi, hi.lo,
// hi.hi; K = 3 padded to 8 with zeros), which carry the dot to float32
// accuracy as Precision.HIGHEST does on the TPU.  The epilogue forms
// (qn + rn) - 2 * dot (one fused multiply-add: 2 * dot is exact, so it
// rounds as the separate product and subtraction) and keeps, per thread,
// a running (min, first index) in reference order with a strict "<".  The
// four threads that hold a query's columns then take the (value, index)
// minimum, so a block writes the first minimum of its tr rows; a merge
// kernel takes the blocks' minima in reference order with a strict "<"
// (the TPU kernel's walk across tiles).  Reference rows past the end are
// staged with |r|^2 = +inf and never win.  wgmma and TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- L1/L2 ----------------------------------------------------------------

constexpr int kRun = 8;              // adjacent x positions a thread
constexpr int kWords = kRun / 4;
constexpr int kMaxThreads = 256;
constexpr int kFlush = 256;          // features per packed-lane flush

enum Mode { kBase = 0, kNoShift = 1, kHalfTrip = 2, kSkipEmpty = 3,
            kUnroll2 = 4 };          // ops/lab.MODES

struct CoarseArgs {
  const uint8_t* stack;   // the planes, or their two copies (L2)
  int hd, wd, groups, stride;
  unsigned last_byte;     // of the stack
  unsigned copy;          // bytes of one copy, C * Hd * Wd
  const int32_t* tc;
  const int32_t* tr;
  const int32_t* tx;      // L2 only: rx, for its parity
  const int32_t* starts;  // (N, nb1) bucket starts
  int nf, nb1;
  int32_t* out;
};

template <int kMode, bool kAligned>
__device__ __forceinline__ void coarse_feature(
    const int2 e, const uint8_t* base, unsigned lim, int ylim, unsigned tb,
    unsigned ab, unsigned shb, const uint32_t (&mask)[kWords],
    uint32_t (&lo)[kWords], uint32_t (&hi)[kWords]) {
  unsigned a, sh;
  if (kAligned) {
    a = static_cast<unsigned>(e.x) + ab;
    sh = shb;
  } else {
    const unsigned t = static_cast<unsigned>(e.x) + tb;
    a = t & ~3u;
    sh = t << 3;
  }
  if (kMode == kNoShift) {
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(base + min(a + 4u * q, lim));
      lo[q] += v & 0x00FF00FFu;
      hi[q] += (v >> 8) & 0x00FF00FFu;
    }
    return;
  }
  const bool live = e.y < ylim;   // the row y + ry lies on the plane
  uint32_t w[kWords + 1];
#pragma unroll
  for (int q = 0; q <= kWords; ++q)
    w[q] = *reinterpret_cast<const uint32_t*>(base + min(a + 4u * q, lim));
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t v =
        __funnelshift_r(w[q], w[q + 1], sh) & (live ? mask[q] : 0u);
    lo[q] += v & 0x00FF00FFu;
    hi[q] += (v >> 8) & 0x00FF00FFu;
  }
}

template <int kMode, bool kAligned>
__global__ void __launch_bounds__(kMaxThreads)
lab_coarse_kernel(const CoarseArgs p) {
  extern __shared__ int2 tab[];   // nf staged features, then nb1 starts
  int* sb = reinterpret_cast<int*>(tab + p.nf);
  const int n = blockIdx.x;
  const unsigned plane = static_cast<unsigned>(p.hd * p.wd);
  const size_t row = (size_t)n * p.nf;
  for (int f = threadIdx.x; f < p.nf; f += blockDim.x) {
    const int ry = p.tr[row + f];
    unsigned off = static_cast<unsigned>(p.tc[row + f]) * plane +
                   static_cast<unsigned>(ry * p.wd);
    if (p.stride == 2)
      off += static_cast<unsigned>(p.tx[row + f] & 1) * p.copy;
    tab[f] = make_int2(static_cast<int>(off), ry);
  }
  for (int b = threadIdx.x; b < p.nb1; b += blockDim.x)
    sb[b] = min(max(p.starts[(size_t)n * p.nb1 + b], 0), p.nf);
  __syncthreads();
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= p.hd * p.groups) return;
  const int y = g / p.groups;
  const int x0 = (g - y * p.groups) * kRun;
  // byte offsets from the 4-byte-aligned address at or below the stack
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(p.stack) & 3u);
  const uint8_t* base = p.stack - mis;
  const unsigned lim = (mis + p.last_byte) & ~3u;
  const unsigned run0 = mis + static_cast<unsigned>(y * p.wd + x0);
  const int ylim = p.hd - y;
  int32_t total[kRun] = {};
  const int nbk = p.nb1 - 1;
  for (int j = 0; j < nbk; ++j) {
    const int lo_f = sb[j];
    int hi_f = sb[j + 1];
    if (kMode == kHalfTrip) hi_f = lo_f + (hi_f - lo_f) / 2;
    if (kMode == kSkipEmpty && lo_f >= hi_f) continue;
    // the bucket's set-up: its column, the alignment of x0 + col, and the
    // valid bits of the run from its first byte, 8 * (Wd - x0 - col)
    const int col = p.stride * j;
    const unsigned tb = run0 + static_cast<unsigned>(col);
    const unsigned ab = tb & ~3u;
    const unsigned shb = tb << 3;
    const int n8 = (p.wd - x0 - col) * 8;
    uint32_t mask[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q)
      mask[q] = __funnelshift_lc(0xFFFFFFFFu, 0u,
                                 static_cast<unsigned>(max(n8 - 32 * q, 0)));
    int f = lo_f;
    do {
      const int f1 = min(f + kFlush, hi_f);
      uint32_t lo[kWords] = {}, hi[kWords] = {};
      if (kMode == kUnroll2) {
        for (; f < f1; f += 2) {
          coarse_feature<kMode, kAligned>(tab[f], base, lim, ylim, tb, ab,
                                          shb, mask, lo, hi);
          coarse_feature<kMode, kAligned>(tab[f + 1], base, lim, ylim, tb,
                                          ab, shb, mask, lo, hi);
        }
      } else {
#pragma unroll 4
        for (; f < f1; ++f)
          coarse_feature<kMode, kAligned>(tab[f], base, lim, ylim, tb, ab,
                                          shb, mask, lo, hi);
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        total[4 * q] += lo[q] & 0xFFFFu;
        total[4 * q + 1] += hi[q] & 0xFFFFu;
        total[4 * q + 2] += lo[q] >> 16;
        total[4 * q + 3] += hi[q] >> 16;
      }
    } while (f < hi_f);
  }
  int32_t* o = p.out + (size_t)n * plane + (size_t)y * p.wd + x0;
#pragma unroll
  for (int k = 0; k < kRun; ++k)
    if (x0 + k < p.wd) o[k] = total[k];
}

template <int kMode>
void coarse_mode(const CoarseArgs& p, dim3 grid, int threads, size_t smem,
                 cudaStream_t s) {
  if (p.wd % 4 == 0)
    lab_coarse_kernel<kMode, true><<<grid, threads, smem, s>>>(p);
  else
    lab_coarse_kernel<kMode, false><<<grid, threads, smem, s>>>(p);
}

int launch_coarse(CoarseArgs p, int n, int mode, void* stream) {
  p.groups = (p.wd + kRun - 1) / kRun;
  const int need = p.hd * p.groups;
  const int threads = min(kMaxThreads, (need + 31) / 32 * 32);
  const dim3 grid(n, (need + threads - 1) / threads);
  const size_t smem = (size_t)p.nf * sizeof(int2) + (size_t)p.nb1 * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase: coarse_mode<kBase>(p, grid, threads, smem, s); break;
    case kNoShift: coarse_mode<kNoShift>(p, grid, threads, smem, s); break;
    case kHalfTrip: coarse_mode<kHalfTrip>(p, grid, threads, smem, s); break;
    case kSkipEmpty:
      coarse_mode<kSkipEmpty>(p, grid, threads, smem, s);
      break;
    case kUnroll2: coarse_mode<kUnroll2>(p, grid, threads, smem, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

CoarseArgs coarse_args(const void* stack, int copies, int c, int hd, int wd,
                       const void* tc, const void* tr, const void* starts,
                       int nf, int nb1, void* out) {
  CoarseArgs p = {};
  p.stack = static_cast<const uint8_t*>(stack);
  p.hd = hd;
  p.wd = wd;
  p.copy = static_cast<unsigned>((size_t)c * hd * wd);
  p.last_byte = static_cast<unsigned>((size_t)copies * c * hd * wd - 1);
  p.tc = static_cast<const int32_t*>(tc);
  p.tr = static_cast<const int32_t*>(tr);
  p.starts = static_cast<const int32_t*>(starts);
  p.nf = nf;
  p.nb1 = nb1;
  p.out = static_cast<int32_t*>(out);
  return p;
}

// ---- L3 -------------------------------------------------------------------

constexpr int kWin = 16;             // LOCAL_WINDOW
constexpr int kLanes = 2;            // threads a window row
constexpr int kLWords = 4 / kLanes;  // 32-bit words a thread
constexpr int kSlices = 8;           // bucket slices of a block
constexpr int kLThreads = kSlices * kWin * kLanes;
constexpr int kPartStride = kWin + 1;   // padded partial rows

struct LocalArgs {
  const uint8_t* stack;
  int hd, wd, stride;
  unsigned last_byte, copy;
  const int32_t* tc;
  const int32_t* tr;
  const int32_t* tx;
  const int32_t* starts;
  int nf, nb1;
  const int32_t* px0;
  const int32_t* py0;
  int32_t* out;   // (K, 16, 16)
};

template <bool kCond, bool kAligned>
__global__ void __launch_bounds__(kLThreads)
lab_local_kernel(const LocalArgs p) {
  extern __shared__ uint2 ltab[];   // features, starts; then the partials
  int* sb = reinterpret_cast<int*>(ltab + p.nf);
  const int k = blockIdx.x;
  const int px0c = max(p.px0[k], 0);
  const int py0c = max(p.py0[k], 0);
  const size_t trow = (size_t)k * p.nf;
  const unsigned plane = static_cast<unsigned>(p.hd * p.wd);
  // {plane offset of the window row's start without its column, valid
  // rows min(Hd - a, 16) or 0 for a dropped feature}
  for (int f = threadIdx.x; f < p.nf; f += blockDim.x) {
    const int a = py0c + p.tr[trow + f];
    const bool ok = a >= 0 && a <= p.hd;
    unsigned off = static_cast<unsigned>(p.tc[trow + f]) * plane +
                   static_cast<unsigned>(a * p.wd);
    if (p.stride == 2)
      off += static_cast<unsigned>(p.tx[trow + f] & 1) * p.copy;
    ltab[f] = make_uint2(ok ? off : 0u,
                         ok ? static_cast<unsigned>(min(p.hd - a, kWin)) : 0u);
  }
  for (int b = threadIdx.x; b < p.nb1; b += blockDim.x)
    sb[b] = min(max(p.starts[(size_t)k * p.nb1 + b], 0), p.nf);
  __syncthreads();
  const int jl = threadIdx.x % kLanes;
  const int r = threadIdx.x / kLanes % kWin;
  const int s = threadIdx.x / (kLanes * kWin);
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(p.stack) & 3u);
  const uint8_t* base = p.stack - mis;
  const unsigned lim = (mis + p.last_byte) & ~3u;
  const unsigned roff = mis + static_cast<unsigned>(r * p.wd) +
                        4u * kLWords * jl;
  uint32_t total[4 * kLWords] = {};
  const int nbk = p.nb1 - 1;
  for (int j = s; j < nbk; j += kSlices) {
    const int lo_f = sb[j];
    const int hi_f = sb[j + 1];
    if (kCond && lo_f >= hi_f) continue;
    // the bucket's set-up: the window's column start, its alignment and
    // this thread's valid bits, 8 * min(Wd - bc, 16) from the row start
    const int bc = min(px0c + p.stride * j, p.wd);
    const int n8 = 8 * min(p.wd - bc, kWin) - 32 * kLWords * jl;
    uint32_t mask[kLWords];
#pragma unroll
    for (int q = 0; q < kLWords; ++q)
      mask[q] = __funnelshift_lc(0xFFFFFFFFu, 0u,
                                 static_cast<unsigned>(max(n8 - 32 * q, 0)));
    const unsigned tb = roff + static_cast<unsigned>(bc);
    const unsigned ab = tb & ~3u;
    const unsigned shb = tb << 3;
    int f = lo_f;
    do {
      const int f1 = min(f + kFlush, hi_f);
      uint32_t lo[kLWords] = {}, hi[kLWords] = {};
#pragma unroll 4
      for (; f < f1; ++f) {
        const uint2 e = ltab[f];
        const bool live = r < static_cast<int>(e.y);
        unsigned a, sh;
        if (kAligned) {
          a = e.x + ab;
          sh = shb;
        } else {
          const unsigned t = e.x + tb;
          a = t & ~3u;
          sh = t << 3;
        }
        uint32_t w[kLWords + 1];
#pragma unroll
        for (int q = 0; q <= kLWords; ++q)
          w[q] = *reinterpret_cast<const uint32_t*>(base + min(a + 4u * q,
                                                               lim));
#pragma unroll
        for (int q = 0; q < kLWords; ++q) {
          const uint32_t v =
              __funnelshift_r(w[q], w[q + 1], sh) & (live ? mask[q] : 0u);
          lo[q] += v & 0x00FF00FFu;
          hi[q] += (v >> 8) & 0x00FF00FFu;
        }
      }
#pragma unroll
      for (int q = 0; q < kLWords; ++q) {
        total[4 * q] += lo[q] & 0xFFFFu;
        total[4 * q + 1] += hi[q] & 0xFFFFu;
        total[4 * q + 2] += lo[q] >> 16;
        total[4 * q + 3] += hi[q] >> 16;
      }
    } while (f < hi_f);
  }
  __syncthreads();   // every thread is done with the staged table
  uint32_t* part = reinterpret_cast<uint32_t*>(ltab);
#pragma unroll
  for (int q = 0; q < 4 * kLWords; ++q)
    part[(s * kWin + r) * kPartStride + 4 * kLWords * jl + q] = total[q];
  __syncthreads();
  const int t = threadIdx.x;
  const int orow = t / kWin;
  const int ocol = t - orow * kWin;
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < kSlices; ++q)
    sum += part[(q * kWin + orow) * kPartStride + ocol];
  p.out[(size_t)k * kWin * kWin + t] = static_cast<int32_t>(sum);
}

// ---- L4 -------------------------------------------------------------------

constexpr int kStage = 512;          // reference rows a shared-memory stage
constexpr int kMaxQueries = 256;     // tq at most (ops/lab.MAX_TQ)
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += A B for one m16n8k8 TF32 tile whose K columns 4..7 are zero: the
// thread's A elements (row g, col t) and (row g + 8, col t) and its B
// element (row t, col g), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_k4(float (&c)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

// (qn + rn) - 2 * dot; 2 * dot is exact, so the fused form rounds once,
// as the separate product and subtraction do.  Strict "<": the first
// minimum in the thread's reference order.
__device__ __forceinline__ void take(float& best, int& bj, float qn,
                                     float rn, float dot, int j) {
  const float d2 = __fmaf_rn(-2.f, dot, __fadd_rn(qn, rn));
  if (d2 < best) {
    best = d2;
    bj = j;
  }
}

__global__ void __launch_bounds__(kMaxQueries)
lab_nn_mma_kernel(const float* __restrict__ query, int nq,
                  const float* __restrict__ ref, int nr, int chunk,
                  int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ uint32_t s_hi[kStage * 4];
  __shared__ uint32_t s_lo[kStage * 4];
  __shared__ float s_rn[kStage];
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  // a warp's 32 queries: m16 tiles u = 0, 1; row halves h = 0 (g), 1 (g+8)
  const int qw = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  uint32_t a_hi[2][2], a_lo[2][2];
  float qn[2][2], best[2][2];
  int bj[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = qw + 16 * u + 8 * h + g;
      float x = 0.f, y = 0.f, z = 0.f;
      if (i < nq) {
        x = query[3 * (size_t)i];
        y = query[3 * (size_t)i + 1];
        z = query[3 * (size_t)i + 2];
      }
      const float v = tg == 0 ? x : tg == 1 ? y : tg == 2 ? z : 0.f;
      a_hi[u][h] = to_tf32(v);
      a_lo[u][h] = to_tf32(__fsub_rn(v, __uint_as_float(a_hi[u][h])));
      qn[u][h] = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                           __fmul_rn(z, z));
      best[u][h] = inf_f();
      bj[u][h] = 0;
    }
  const int lo = blockIdx.y * chunk;
  const int hi = min(nr, lo + chunk);
  for (int s0 = lo; s0 < hi; s0 += kStage) {
    __syncthreads();   // the previous stage is read
    for (int e = threadIdx.x; e < kStage; e += blockDim.x) {
      const int j = s0 + e;
      float r[3] = {0.f, 0.f, 0.f};
      float rn = inf_f();   // rows past the end never win
      if (j < hi) {
#pragma unroll
        for (int d = 0; d < 3; ++d) r[d] = ref[3 * (size_t)j + d];
        rn = __fadd_rn(__fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
                       __fmul_rn(r[2], r[2]));
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const uint32_t h = to_tf32(r[d]);
        s_hi[4 * e + d] = h;
        s_lo[4 * e + d] = to_tf32(__fsub_rn(r[d], __uint_as_float(h)));
      }
      s_hi[4 * e + 3] = 0u;
      s_lo[4 * e + 3] = 0u;
      s_rn[e] = rn;
    }
    __syncthreads();
    const int rows = min(kStage, hi - s0);
    for (int n0 = 0; n0 < rows; n0 += 8) {
      const uint32_t b_hi = s_hi[4 * (n0 + g) + tg];
      const uint32_t b_lo = s_lo[4 * (n0 + g) + tg];
      const float2 rn = *reinterpret_cast<const float2*>(&s_rn[n0 + 2 * tg]);
      const int j0 = s0 + n0 + 2 * tg;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_k4(c, a_lo[u][0], a_lo[u][1], b_hi);
        mma_k4(c, a_hi[u][0], a_hi[u][1], b_lo);
        mma_k4(c, a_hi[u][0], a_hi[u][1], b_hi);
        take(best[u][0], bj[u][0], qn[u][0], rn.x, c[0], j0);
        take(best[u][0], bj[u][0], qn[u][0], rn.y, c[1], j0 + 1);
        take(best[u][1], bj[u][1], qn[u][1], rn.x, c[2], j0);
        take(best[u][1], bj[u][1], qn[u][1], rn.y, c[3], j0 + 1);
      }
    }
  }
  // the four threads of a row hold its columns 2t, 2t + 1 of every 8:
  // the least (d2, index) is the first minimum of the block's rows
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[u][h];
      int bi = bj[u][h];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ov = __shfl_xor_sync(0xFFFFFFFFu, v, o);
        const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, o);
        if (ov < v || (ov == v && oi < bi)) {
          v = ov;
          bi = oi;
        }
      }
      const int i = qw + 16 * u + 8 * h + g;
      if (tg == 0 && i < nq) {
        idx_out[(size_t)blockIdx.y * nq + i] = bi;
        d2_out[(size_t)blockIdx.y * nq + i] = v;
      }
    }
}

__global__ void lab_nn_merge_kernel(const int32_t* __restrict__ part_idx,
                                    const float* __restrict__ part_d2, int nq,
                                    int nchunks, int32_t* __restrict__ idx_out,
                                    float* __restrict__ d2_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float best = inf_f();
  int bj = 0;
  for (int c = 0; c < nchunks; ++c) {
    const float v = part_d2[(size_t)c * nq + i];
    if (v < best) {
      best = v;
      bj = part_idx[(size_t)c * nq + i];
    }
  }
  idx_out[i] = bj;
  d2_out[i] = best;
}

}  // namespace

// planes (C, Hd, Wd) u8; c/ry (N, nf) and bucket starts (N, nb1) int32;
// mode an ops/lab.MODES index.
extern "C" int fl_lab_coarse(const void* planes, int c, int hd, int wd,
                             const void* tc, const void* tr,
                             const void* bstart, int n, int nf, int nb1,
                             int mode, void* out, void* stream) {
  CoarseArgs p = coarse_args(planes, 1, c, hd, wd, tc, tr, bstart, nf, nb1,
                             out);
  p.stride = 1;
  return launch_coarse(p, n, mode, stream);
}

// stack (2, C, Hd, Wd) u8: the planes and their shifted copy; c/ry/rx
// (N, nf); the stride-2 bucket starts (N, nb1).
extern "C" int fl_lab_coarse_stride2(const void* stack, int c, int hd,
                                     int wd, const void* tc, const void* tr,
                                     const void* tx, const void* starts,
                                     int n, int nf, int nb1, int skipempty,
                                     void* out, void* stream) {
  CoarseArgs p = coarse_args(stack, 2, c, hd, wd, tc, tr, starts, nf, nb1,
                             out);
  p.stride = 2;
  p.tx = static_cast<const int32_t*>(tx);
  return launch_coarse(p, n, skipempty ? kSkipEmpty : kBase, stream);
}

// stack: the planes (stride 1) or their two copies (stride 2); c/ry/rx
// (K, nf); the stride's bucket starts (K, nb1); origins px0/py0 (K,).
extern "C" int fl_lab_local(const void* stack, int c, int hd, int wd,
                            const void* tc, const void* tr, const void* tx,
                            const void* starts, int k, int nf, int nb1,
                            int stride, int use_cond, const void* px0,
                            const void* py0, void* out, void* stream) {
  LocalArgs p = {};
  p.stack = static_cast<const uint8_t*>(stack);
  p.hd = hd;
  p.wd = wd;
  p.stride = stride;
  p.copy = static_cast<unsigned>((size_t)c * hd * wd);
  p.last_byte = static_cast<unsigned>((size_t)stride * c * hd * wd - 1);
  p.tc = static_cast<const int32_t*>(tc);
  p.tr = static_cast<const int32_t*>(tr);
  p.tx = static_cast<const int32_t*>(tx);
  p.starts = static_cast<const int32_t*>(starts);
  p.nf = nf;
  p.nb1 = nb1;
  p.px0 = static_cast<const int32_t*>(px0);
  p.py0 = static_cast<const int32_t*>(py0);
  p.out = static_cast<int32_t*>(out);
  const size_t part = (size_t)kSlices * kWin * kPartStride * 4;
  const size_t staged = (size_t)nf * sizeof(uint2) + (size_t)nb1 * 4;
  const size_t smem = staged > part ? staged : part;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = wd % 4 == 0;
  if (use_cond) {
    if (aligned)
      lab_local_kernel<true, true><<<k, kLThreads, smem, s>>>(p);
    else
      lab_local_kernel<true, false><<<k, kLThreads, smem, s>>>(p);
  } else {
    if (aligned)
      lab_local_kernel<false, true><<<k, kLThreads, smem, s>>>(p);
    else
      lab_local_kernel<false, false><<<k, kLThreads, smem, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// query (nq, 3) and ref (nr, 3) f32; blocks of tq queries (a multiple of
// 32, at most kMaxQueries) each scan tr reference rows; with nchunks =
// ceil(nr / tr) > 1, part_idx/part_d2 hold the (nchunks, nq) minima for
// the merge.
extern "C" int fl_lab_nn_mma(const void* query, int nq, const void* ref,
                             int nr, int tq, int tr, int nchunks,
                             void* part_idx, void* part_d2, void* idx,
                             void* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool merge = nchunks > 1;
  const dim3 grid((nq + tq - 1) / tq, nchunks);
  lab_nn_mma_kernel<<<grid, tq, 0, s>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(ref),
      nr, tr, static_cast<int32_t*>(merge ? part_idx : idx),
      static_cast<float*>(merge ? part_d2 : d2));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  lab_nn_merge_kernel<<<(nq + kMergeThreads - 1) / kMergeThreads,
                        kMergeThreads, 0, s>>>(
      static_cast<const int32_t*>(part_idx),
      static_cast<const float*>(part_d2), nq, nchunks,
      static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
