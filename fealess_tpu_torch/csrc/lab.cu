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
// before its set-up: the walk below reaches no empty bucket in any mode,
// so it runs base's code); unroll2 (two features an iteration, one
// bucket check a pair; even starts); halftrip (rows [lo, lo + (hi - lo) /
// 2) of each bucket); noshift (no byte alignment and no mask: the aligned
// words holding the run, unshifted; wrong by design).  L2 (stride 2)
// reads the lab's stride-2 starts over a stack of two copies, the planes
// and the planes shifted one column (out[..., x] = in[..., x + 1], 0 at
// Wd - 1): an odd-rx feature's offset moves by one copy, so both columns
// of a bucket share one alignment.
//
// L3 fl_lab_local replaces kernel_lab.py:419 _local_variant_run (call
// :467).  Contract: K2's (score.cu, fl_local_scores), the 16 x 16 window
// sums at origins (max(px0, 0), max(py0, 0)), features whose row start
// a = py0c + ry lies outside [0, Hd] dropped, column start min(px0c + col,
// Wd), reads past the plane 0; col as above, at stride 1 or 2 over the
// stride's buckets of the table's starts (bucket j from bstart[min(stride
// * j, NB)], ops/lab.bucket_starts, taken in the kernel), always on the
// planes themselves: an odd-rx feature of a stride-2 bucket is read one
// byte on, where the TPU needed a copy shifted one column.  The lab's
// use_cond (skip empty buckets) is not an argument: the walk below reaches
// no empty bucket, so both settings are this one launch.
//
// L4 fl_lab_nn_mma replaces kernel_lab.py:690 nn_mxu (kernel
// _nn_mxu_kernel :664, call :702).  Contract: per query i, the first j
// minimising d2 = (|q_i|^2 + |r_j|^2) - 2 q_i.r_j, with the dot at float32
// accuracy, and that d2; near-ties may pick another index than K3's
// elementwise d2 (the lab's rule: idx equal or |d2 - d2_K3| <= 1e-3 *
// max(d2_K3, 1)).
//
// What bounds them on this card.  L1/L2 are K1's work (one integer add per
// live feature and output position, ~3.2e7 at the lab's 1024 x 30 x 40 x
// ~26 features) out of an L2-resident 1.2 MB plane stack: instruction
// issue, L1 load throughput and the latency of each thread's chain of
// loads, as K1.  L3 is K2's tiny work (64 windows), bound by latency.
// L4 at 16384 x 16384 is 2.7e8 pairs.  Any form needs the dot at float32
// accuracy (three TF32 passes of a 3-long dot, 18 operations a pair:
// ~0.0098 ms at 495 TFLOP/s) and one compare and one select a pair on
// the CUDA cores (~0.0080 ms at 67 TFLOP/s); the norms and the -2 can
// ride in the product, as here.  So the dot bounds it (ops/bounds.py).
// This kernel's product has 16 slots (32 operations a pair, 0.0174 ms at
// the peak).  On the card compares and selects run on the half-rate ALU
// pipe, so the epilogue keeps one compare a pair there and moves the rest
// to the FMA pipe (scan, below).
//
// L1/L2 design: K1's mapping (a block a template, 160 threads at the
// lab's shapes, a thread kRun adjacent x positions of a row, kRun/4 + 1
// aligned 32-bit loads and a funnel shift a feature, bytes added as
// packed 16-bit lanes), with the walk rebuilt so that no bucket boundary
// stops the loads:
// - The block stages only the live slots [starts[0], starts[NB]) (K1
//   stages its nvalid): the starts first, then the slots in walk order,
//   each with its bucket's column folded into its offset (where Wd is a
//   multiple of 4, the column's word part: every offset c*Hd*Wd + ry*Wd,
//   a copy and y*Wd + x0 is then a multiple of 4) and the bucket's index
//   beside ry.  A feature's load address is then its entry plus the
//   thread's y*Wd + x0, whatever its bucket.
// - The walk is one loop over the staged features in groups of kDepth = 4:
//   the group's 12 loads issue before any of its adds, across bucket
//   boundaries.  A thread sets a bucket up once, when the walk reaches its
//   first feature (a uniform branch, the same for every thread): the
//   funnel shift (where Wd is a multiple of 4 the byte alignment of x0 +
//   col is the bucket's, the Hopper meaning of the TPU's per-bucket lane
//   shift; otherwise the shift is taken per feature as in K1) and the
//   row-end masks for x0 + col as even- and odd-lane masks.  A feature
//   then costs a broadcast load, an add and three clamped loads, two
//   funnel shifts, and four three-input ANDs (lane, mask, row past the
//   plane as a sign mask) into the lanes.
// - The lanes are flushed once every kFlush = 256 features of the whole
//   walk, wherever the buckets end (a 16-bit lane holds 257 adds of 255);
//   a flush before the last adds to the partial sums kept in out, and the
//   last writes out with 16-byte stores where Wd is a multiple of 4.
//   Integer sums are order-free, so the results are bitwise equal to the
//   twins.
// - Tried on the card and slower (PERF.md §6): loads predicated on the
//   row instead of the mask, 8-byte load pairs, deeper groups or two
//   groups in flight (more registers, fewer blocks a SM), skipping the
//   third word of a 4-aligned bucket, and unclamped loads behind a
//   staged bound check (the branch breaks the group's batch of loads).
//
// L3 design.  A block is one candidate, K2's block: 256 threads, 8 slices
// (warps) x 16 window rows x 2 lanes of kRun = 8 window columns.  Its work
// is tiny (~20 live features x 256 adds at the lab's local2 inputs, a
// 0.00012 ms bound), so what bounds it is latency: the dependent round
// trips to L2 (the table, then the plane rows) and the barriers, over the
// graph's launch floor.  The design keeps a block to those two trips:
// - Staging: the walk's bounds, the origins, thread b's bucket bounds (at
//   stride 2 the stride-2 starts, bstart[min(2b, NB)]) and slot b of the
//   table load together.  Each bucket's thread then marks its slots with
//   its index (atomicMax in shared memory: where starts decrease, the
//   largest index that claims a slot takes it), and the live slots
//   [starts[0], starts[NB]) are staged in walk order as L1's entries are:
//   the plane offset of the window row's start with its column min(px0c +
//   col, Wd) folded in (where Wd is a multiple of 4, the column's word
//   part), and (16 - valid rows) << 16 | col, col = stride * j + rx %
//   stride the walk's key (a dropped feature has 0 valid rows).
// - One walk, split evenly: slice s takes the staged features [s * per,
//   (s + 1) * per), per = ceil(n / 8), whatever buckets they lie in, in
//   groups of kDepth whose loads (L1's feature_words: 3 clamped words)
//   issue before any of their adds, a group's tail guarded rather than
//   walked one by one.  A slice sets a column up (L1's bucket_setup: the
//   funnel shift where Wd is a multiple of 4, the row-end masks) once,
//   when its range reaches a new key, a branch uniform in the warp; the
//   row gate is a sign mask per feature (L1's feature_add).  At stride 2
//   the key is the column itself, so a bucket's even and odd runs each get
//   one set-up with its own alignment and masks (a bucketed table holds a
//   stride-2 bucket's even rx before its odd), and no feature selects.
// - The packed 16-bit lanes flush into 32-bit totals every kFlush = 256
//   features of a slice's range, wherever the buckets end (a lane holds
//   257 adds of 255); the 8 slices' partial rows are summed in shared
//   memory in a fixed order.  Integer sums are order-free, so the results
//   are bitwise equal to the twin's.
// - Measured on the card and not kept (PERF.md §6): each slot's bucket by
//   a scan of the starts (slower: 38 compares on the critical path at
//   stride 1), the shift taken per feature at Wd = 128 (no faster),
//   groups of 8 (72-80 registers, slower) and set-ups hoisted ahead of
//   the group's adds (74 registers, no faster).

// L4 design: d2 is the accumulator of one TF32 product on the tensor cores.
// Each point becomes 16 TF32 operand slots, two k8 steps (hi/lo the cvt.rna
// split of a coordinate, lo = tf32(x - hi); n0 + n1 + n2 the float32 norm
// (x*x + y*y) + z*z exactly, in three TF32 pieces):
//   step 0: A = [-2q_hi (3), -2q_lo (3), qn0, qn1],
//           B = [r_hi (3), r_hi (3), 1, 1];
//   step 1: A = [-2q_hi (3), qn2, 1, 1, 1, 0],
//           B = [r_lo (3), 1, rn0, rn1, rn2, 0],
// so the product is qn + rn - 2 (hi.hi + lo.hi + hi.lo): three passes,
// the dot at float32 accuracy as Precision.HIGHEST; -2 x is exact
// and every product of two TF32 values is exact in float32.  Error model
// against the float32 d2 of the same norms: the dot lacks lo.lo and the
// lo parts' own TF32 rounding, each <= 2^-22 |q||r|, so 2 dot is off by
// <= 6 * 2^-22 |q||r| <= 3 * 2^-22 (|q|^2 + |r|^2); the norms are exact;
// the tensor core's float32 sums of terms up to |q|^2 + |r|^2 add a few
// 2^-23 of it.  About 1e-6 (|q|^2 + |r|^2) in all, ~0.1 of the lab's d2
// limit (ops/lab.D2_CANCEL, 1e-5); the epilogue only compares and selects.
// A small kernel writes the operands once a call (lab_nn_operands_kernel;
// its twin ops/lab.nn_operands_plain): A (nq, 16) row-major, B in the tile
// order of wgmma's no-swizzle K-major layout (8-row groups of 512 bytes:
// k step, k half, row, 4 floats), rows past nr zero.
//
// A block is `groups` = ceil(tq / 64) warpgroups of 64 queries and walks
// the reference rows of its chunk (tr rounded up to 128) in tiles of 128
// rows x 16 slots (8 KB).  Thread 0 starts the first kStages tiles with
// cp.async.bulk (TMA), each on an mbarrier; the warpgroup that is the last
// to release a stage (a count in shared memory) starts the copy of the
// tile kStages on, so no warp waits to produce.  A warpgroup holds its
// queries' A in registers for the whole walk and starts
// wgmma.mma_async.m64n128k8.f32.tf32.tf32 twice a tile (B by descriptor
// from the stage), waits for it, then scans the accumulator while the
// block's other warpgroups run.  (Two accumulator sets, a tile's product
// in flight during the previous scan, measured slower on the card: at 512
// threads a block they leave room for 64-row tiles only, whose per-tile
// fences and waits cost more.)  Each
// thread keeps, per query row and column parity of the 8-column blocks, a
// running (d2, first index) with a strict "<" in reference order; the
// partials and the four threads of a row are merged by (d2, index), so a
// block writes its chunk's first minimum.  Columns past nr (the last tile
// of the last chunk only) are never compared.  A merge kernel takes the
// chunks' minima in reference order with a strict "<" (the TPU kernel's
// walk across tiles).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---- L1/L2 ----------------------------------------------------------------

constexpr int kRun = 8;              // adjacent x positions a thread
constexpr int kWords = kRun / 4;
constexpr int kMaxThreads = 256;
constexpr int kFlush = 256;          // features per packed-lane flush
constexpr int kDepth = 4;            // features whose loads issue together

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

// A bucket's set-up for one thread: the funnel shift that brings the run's
// first byte to bit 0 (aligned planes; otherwise it is taken per feature)
// and the valid bits of the run's words, 8 * (Wd - x0 - col) from its
// first byte, as the even and the odd bytes' 16-bit lanes.
struct Setup {
  unsigned sh;
  uint32_t even[kWords], odd[kWords];
};

__device__ __forceinline__ Setup bucket_setup(int col, int xlim,
                                              unsigned mis) {
  Setup s;
  s.sh = ((mis + static_cast<unsigned>(col)) & 3u) << 3;
  const int n8 = (xlim - col) * 8;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t m = __funnelshift_lc(
        0xFFFFFFFFu, 0u, static_cast<unsigned>(max(n8 - 32 * q, 0)));
    s.even[q] = m & 0x00FF00FFu;
    s.odd[q] = (m >> 8) & 0x00FF00FFu;
  }
  return s;
}

// A feature's loads, which need no set-up: kWords + 1 aligned words from
// the one holding the run's first byte (noshift: kWords), each clamped to
// the stack's last word.  t: the run's first byte.
template <int kMode, bool kAligned>
__device__ __forceinline__ void feature_words(
    const int2 e, const uint8_t* __restrict__ base, unsigned run, unsigned lim,
    uint32_t (&w)[kWords + 1], unsigned& t) {
  t = static_cast<unsigned>(e.x) + run;
  const unsigned a = kAligned ? t : (t & ~3u);
  w[kWords] = 0u;
#pragma unroll
  for (int q = 0; q < (kMode == kNoShift ? kWords : kWords + 1); ++q)
    w[q] = __ldg(reinterpret_cast<const unsigned int*>(
        base + min(a + 4u * q, lim)));
}

// A feature's adds into the packed 16-bit lanes, under the set-up of its
// bucket; a row past the plane (ry >= Hd - y) adds nothing.
template <int kMode, bool kAligned>
__device__ __forceinline__ void feature_add(
    const uint32_t (&w)[kWords + 1], unsigned t, int ey, int ylim16,
    const Setup& s, uint32_t (&lo)[kWords], uint32_t (&hi)[kWords]) {
  if (kMode == kNoShift) {
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      lo[q] += w[q] & 0x00FF00FFu;
      hi[q] += (w[q] >> 8) & 0x00FF00FFu;
    }
    return;
  }
  const uint32_t live = static_cast<uint32_t>((ey - ylim16) >> 31);
  const unsigned sh = kAligned ? s.sh : t << 3;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint32_t v = __funnelshift_r(w[q], w[q + 1], sh);
    lo[q] += v & s.even[q] & live;
    hi[q] += (v >> 8) & s.odd[q] & live;
  }
}

template <int kMode, bool kAligned>
__global__ void __launch_bounds__(kMaxThreads)
lab_coarse_kernel(const CoarseArgs p) {
  extern __shared__ int2 tab[];   // the walk's features, then nb1 starts
  int* sb = reinterpret_cast<int*>(tab + p.nf);
  const int n = blockIdx.x;
  const int nbk = p.nb1 - 1;
  const int32_t* st = p.starts + (size_t)n * p.nb1;
  for (int b = threadIdx.x; b < p.nb1; b += blockDim.x)
    sb[b] = min(max(st[b], 0), p.nf);
  const int f0 = min(max(st[0], 0), p.nf);
  const int f1 = max(min(max(st[nbk], 0), p.nf), f0);
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(p.stack) & 3u);
  const unsigned plane = static_cast<unsigned>(p.hd * p.wd);
  const size_t row = (size_t)n * p.nf;
  __syncthreads();
  // Stage the live slots [f0, f1) in walk order (halftrip: the first half
  // of each bucket, compacted): {c*Hd*Wd + ry*Wd (+ a copy for an odd rx
  // in L2) + the bucket's column (aligned planes: its word part); ry << 16
  // | bucket}.
  int nwalk = f1 - f0;
  if (kMode == kHalfTrip) {
    nwalk = 0;
    for (int k = 0; k < nbk; ++k) nwalk += max((sb[k + 1] - sb[k]) / 2, 0);
    nwalk = min(nwalk, p.nf);
  }
  for (int f = f0 + threadIdx.x; f < f1; f += blockDim.x) {
    const int ry = p.tr[row + f];
    unsigned off = static_cast<unsigned>(p.tc[row + f]) * plane +
                   static_cast<unsigned>(ry * p.wd);
    if (p.stride == 2)
      off += static_cast<unsigned>(p.tx[row + f] & 1) * p.copy;
    int j = 0;   // the feature's bucket: the last start at or below it
    for (int k = 1; k < nbk; ++k) j += sb[k] <= f;
    int pos = f - f0;
    if (kMode == kHalfTrip) {
      const int lo = sb[j], half = (sb[j + 1] - lo) / 2;
      if (f < lo || f - lo >= half) continue;
      pos = f - lo;
      for (int k = 0; k < j; ++k) pos += max((sb[k + 1] - sb[k]) / 2, 0);
      if (pos >= nwalk) continue;
    }
    const unsigned col = mis + static_cast<unsigned>(p.stride * j);
    tab[pos] = make_int2(static_cast<int>(off + (kAligned ? col & ~3u : col)),
                         (ry << 16) | j);
  }
  __syncthreads();
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  if (g >= p.hd * p.groups) return;
  const int y = g / p.groups;
  const int x0 = (g - y * p.groups) * kRun;
  // byte offsets from the 4-byte-aligned address at or below the stack
  const uint8_t* base = p.stack - mis;
  const unsigned lim = (mis + p.last_byte) & ~3u;
  const unsigned run = static_cast<unsigned>(y * p.wd + x0);
  const int ylim16 = (p.hd - y) << 16;
  const int xlim = p.wd - x0;
  int jc = -1;        // the bucket of the set-up in hand
  Setup s = {};
  const auto enter = [&](int ey) {   // uniform: one walk for all threads
    const int j = ey & 0xFFFF;
    if (j != jc) {
      jc = j;
      s = bucket_setup(p.stride * j, xlim, mis);
    }
  };
  int32_t* o = p.out + (size_t)n * plane + (size_t)y * p.wd + x0;
  int c0 = 0;
  do {   // chunks of kFlush features, whatever buckets they span
    const int c1 = min(c0 + kFlush, nwalk);
    uint32_t lo[kWords] = {}, hi[kWords] = {};
    int f = c0;
    for (; f + kDepth <= c1; f += kDepth) {
      uint32_t w[kDepth][kWords + 1];
      unsigned t[kDepth];
      int ey[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int2 e = tab[f + u];
        ey[u] = e.y;
        feature_words<kMode, kAligned>(e, base, run, lim, w[u], t[u]);
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (kMode != kUnroll2 || u % 2 == 0) enter(ey[u]);
        feature_add<kMode, kAligned>(w[u], t[u], ey[u], ylim16, s, lo, hi);
      }
    }
    for (; f < c1; ++f) {
      uint32_t w[kWords + 1];
      unsigned t;
      const int2 e = tab[f];
      feature_words<kMode, kAligned>(e, base, run, lim, w, t);
      enter(e.y);
      feature_add<kMode, kAligned>(w, t, e.y, ylim16, s, lo, hi);
    }
    // the flush: the lanes' sums plus the earlier chunks' (kept in out)
    int32_t v[kRun];
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      v[4 * q] = lo[q] & 0xFFFFu;
      v[4 * q + 1] = hi[q] & 0xFFFFu;
      v[4 * q + 2] = lo[q] >> 16;
      v[4 * q + 3] = hi[q] >> 16;
    }
    if (kAligned) {   // o is 16-byte aligned; x0 + 4k < Wd holds 4 more
#pragma unroll
      for (int k = 0; k < kRun / 4; ++k) {
        if (x0 + 4 * k >= p.wd) break;
        int4* o4 = reinterpret_cast<int4*>(o) + k;
        int4 r = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                           v[4 * k + 3]);
        if (c0 > 0) {
          const int4 prev = *o4;
          r.x += prev.x;
          r.y += prev.y;
          r.z += prev.z;
          r.w += prev.w;
        }
        *o4 = r;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        if (x0 + k < p.wd) o[k] = v[k] + (c0 > 0 ? o[k] : 0);
    }
    c0 = c1;
  } while (c0 < nwalk);
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
constexpr int kLanes = kWin / kRun;  // threads a window row
constexpr int kSlices = 8;           // warps of a block, each a range
constexpr int kLThreads = kSlices * kWin * kLanes;
constexpr int kPartStride = kWin + 1;   // padded partial rows
static_assert(kWin * kLanes == 32, "a slice is one warp");

struct LocalArgs {
  const uint8_t* planes;
  int hd, wd, stride;
  unsigned last_byte;     // of the planes
  const int32_t* tc;
  const int32_t* tr;
  const int32_t* tx;      // stride 2 only: rx, for its parity
  const int32_t* bstart;  // (K, nb1) the table's own starts
  int nf, nb1;
  const int32_t* px0;
  const int32_t* py0;
  int32_t* out;   // (K, 16, 16)
};

template <bool kAligned>
__global__ void __launch_bounds__(kLThreads)
lab_local_kernel(const LocalArgs p) {
  extern __shared__ int2 ltab[];   // the walk's features; then the partials
  const int nb = p.nb1 - 1;
  const int nbk = (nb + p.stride - 1) / p.stride;   // the stride's buckets
  const int k = blockIdx.x;
  const int32_t* st = p.bstart + (size_t)k * p.nb1;
  const auto start = [&](int j) {   // ops/lab.bucket_starts(bstart, stride)
    return min(max(st[min(p.stride * j, nb)], 0), p.nf);
  };
  // One round trip: the walk's bounds, the origins, thread b's bucket
  // bounds and slot b (the first staged, where the walk starts at slot 0
  // as a bucketed table's does).
  const int f0 = start(0);
  const int nwalk = max(start(nbk), f0) - f0;
  const int px0c = max(p.px0[k], 0);
  const int py0c = max(p.py0[k], 0);
  const int tid = threadIdx.x;
  const size_t trow = (size_t)k * p.nf;
  int blo = 0, bhi = 0, c_first = 0, ry_first = 0, rx_first = 0;
  if (tid < nbk) {
    blo = start(tid);
    bhi = start(tid + 1);
  }
  if (tid < p.nf) {
    c_first = p.tc[trow + tid];
    ry_first = p.tr[trow + tid];
    if (p.stride == 2) rx_first = p.tx[trow + tid];
  }
  for (int i = tid; i < p.nf; i += blockDim.x) ltab[i].y = 0;
  __syncthreads();
  // Each bucket marks its slots with its index (a bucketed table's
  // buckets are disjoint; where starts decrease, the largest index that
  // claims a slot takes it).
  for (int b = tid; b < nbk; b += blockDim.x) {
    if (b != tid) {
      blo = start(b);
      bhi = start(b + 1);
    }
    for (int i = max(blo - f0, 0); i < min(bhi - f0, nwalk); ++i)
      atomicMax(&ltab[i].y, b);
  }
  __syncthreads();
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(p.planes) & 3u);
  const unsigned plane = static_cast<unsigned>(p.hd * p.wd);
  // Stage the live slots [f0, f0 + nwalk) in walk order: {c*Hd*Wd + a*Wd +
  // mis + the column (aligned planes: its word part), or 0 if dropped;
  // (16 - valid rows) << 16 | col}.
  for (int i = tid; i < nwalk; i += blockDim.x) {
    const int f = f0 + i;
    int cc = c_first, ry = ry_first, rx = rx_first;
    if (f != tid) {
      cc = p.tc[trow + f];
      ry = p.tr[trow + f];
      rx = p.stride == 2 ? p.tx[trow + f] : 0;
    }
    const int col = p.stride * ltab[i].y + (rx & (p.stride - 1));
    const int a = py0c + ry;
    const bool ok = a >= 0 && a <= p.hd;
    const unsigned cb = mis + static_cast<unsigned>(min(px0c + col, p.wd));
    const unsigned off = static_cast<unsigned>(cc) * plane +
                         static_cast<unsigned>(a * p.wd) +
                         (kAligned ? cb & ~3u : cb);
    const int rows = ok ? min(p.hd - a, kWin) : 0;
    ltab[i] = make_int2(ok ? static_cast<int>(off) : 0,
                        ((kWin - rows) << 16) | col);
  }
  __syncthreads();
  const int jl = tid % kLanes;
  const int r = tid / kLanes % kWin;
  const int s = tid / (kLanes * kWin);
  const uint8_t* base = p.planes - mis;
  const unsigned lim = (mis + p.last_byte) & ~3u;
  const unsigned run = static_cast<unsigned>(r * p.wd + kRun * jl);
  const int ylim16 = (kWin - r) << 16;   // live: valid rows > r
  const int xlim = p.wd - kRun * jl;
  const int per = (nwalk + kSlices - 1) / kSlices;
  const int first = min(s * per, nwalk);
  const int last = min(first + per, nwalk);
  int kc = -1;        // the column of the set-up in hand
  Setup su = {};
  const auto enter = [&](int ey) {   // uniform: one range for the warp
    const int key = ey & 0xFFFF;
    if (key != kc) {
      kc = key;
      su = bucket_setup(min(px0c + key, p.wd), xlim, mis);
    }
  };
  uint32_t total[kRun] = {};
  for (int c0 = first; c0 < last; c0 += kFlush) {   // whatever buckets
    const int c1 = min(c0 + kFlush, last);
    uint32_t lo[kWords] = {}, hi[kWords] = {};
    for (int f = c0; f < c1; f += kDepth) {
      uint32_t w[kDepth][kWords + 1];
      unsigned t[kDepth];
      int ey[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (f + u < c1) {
          const int2 e = ltab[f + u];
          ey[u] = e.y;
          feature_words<kBase, kAligned>(e, base, run, lim, w[u], t[u]);
        }
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        if (f + u < c1) {
          enter(ey[u]);
          feature_add<kBase, kAligned>(w[u], t[u], ey[u], ylim16, su, lo,
                                       hi);
        }
    }
#pragma unroll
    for (int q = 0; q < kWords; ++q) {   // the flush
      total[4 * q] += lo[q] & 0xFFFFu;
      total[4 * q + 1] += hi[q] & 0xFFFFu;
      total[4 * q + 2] += lo[q] >> 16;
      total[4 * q + 3] += hi[q] >> 16;
    }
  }
  __syncthreads();   // every thread is done with the staged table
  uint32_t* part = reinterpret_cast<uint32_t*>(ltab);
#pragma unroll
  for (int q = 0; q < kRun; ++q)
    part[(s * kWin + r) * kPartStride + kRun * jl + q] = total[q];
  __syncthreads();
  const int orow = tid / kWin;
  const int ocol = tid - orow * kWin;
  uint32_t sum = 0;
#pragma unroll
  for (int q = 0; q < kSlices; ++q)
    sum += part[(q * kWin + orow) * kPartStride + ocol];
  p.out[(size_t)k * kWin * kWin + tid] = static_cast<int32_t>(sum);
}

// ---- L4 -------------------------------------------------------------------

constexpr int kNnSlots = 16;         // TF32 operand slots a point (ops/lab)
constexpr int kTileRows = 128;       // reference rows a tile: wgmma's n128
constexpr int kTileBytes = kTileRows * kNnSlots * 4;
constexpr int kStepBytes = 256;      // one k8 step of an 8-row group
constexpr int kGroupBytes = 8 * kNnSlots * 4;   // an 8-row group's operand
constexpr int kStages = 4;           // tiles in flight a block
constexpr int kMaxGroups = 4;        // warpgroups a block: tq 256
constexpr int kNnThreads = 128 * kMaxGroups;
constexpr int kAcc = kTileRows / 2;  // accumulator floats a thread
constexpr int kPartials = 2;         // running minima a query row
constexpr int kPrepThreads = 256;
constexpr uint32_t kWaitLimit = 1u << 26;   // polls before a trap
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// cvt.rna: round to TF32 (10 mantissa bits), ties away from zero; the low
// 13 bits of the result are 0, so the tensor core's truncation keeps it.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// (x*x + y*y) + z*z in three TF32 pieces whose sum is it exactly: each
// remainder is exact in float32 and the third has at most 2 bits.
__device__ __forceinline__ void norm_pieces(const float (&p)[3],
                                            float (&n)[3]) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]),
                                      __fmul_rn(p[1], p[1])),
                            __fmul_rn(p[2], p[2]));
  n[0] = tf32(v);
  const float r = __fsub_rn(v, n[0]);
  n[1] = tf32(r);
  n[2] = tf32(__fsub_rn(r, n[1]));
}

__device__ __forceinline__ void split(const float* src, float (&p)[3],
                                      float (&hi)[3], float (&lo)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    p[d] = src[d];
    hi[d] = tf32(p[d]);
    lo[d] = tf32(__fsub_rn(p[d], hi[d]));
  }
}

// The operands (ops/lab.nn_operands_plain): query row i of A (nq, 16),
// reference row j of B in the tile order (nr_pad / 8, k step, k half, row
// in the group, 4): the no-swizzle K-major layout of wgmma's B, 8-row core
// matrices of 16 bytes a row.  Rows nr..nr_pad - 1 are 0.
__global__ void lab_nn_operands_kernel(const float* __restrict__ query,
                                       int nq, const float* __restrict__ ref,
                                       int nr, int nr_pad,
                                       float4* __restrict__ a_op,
                                       float4* __restrict__ b_op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float p[3], hi[3], lo[3], n[3];
  if (i < nq) {
    split(query + 3 * (size_t)i, p, hi, lo);
    norm_pieces(p, n);
    float h2[3], l2[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      h2[d] = __fmul_rn(-2.f, hi[d]);   // exact
      l2[d] = __fmul_rn(-2.f, lo[d]);
    }
    float4* a = a_op + 4 * (size_t)i;
    a[0] = make_float4(h2[0], h2[1], h2[2], l2[0]);
    a[1] = make_float4(l2[1], l2[2], n[0], n[1]);
    a[2] = make_float4(h2[0], h2[1], h2[2], n[2]);
    a[3] = make_float4(1.f, 1.f, 1.f, 0.f);
  }
  if (i < nr_pad) {
    float one = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) hi[d] = lo[d] = n[d] = 0.f;
    if (i < nr) {
      split(ref + 3 * (size_t)i, p, hi, lo);
      norm_pieces(p, n);
      one = 1.f;
    }
    float4* b = b_op + (size_t)(i / 8) * 32 + i % 8;
    b[0] = make_float4(hi[0], hi[1], hi[2], hi[0]);    // step 0, half 0
    b[8] = make_float4(hi[1], hi[2], one, one);        // step 0, half 1
    b[16] = make_float4(lo[0], lo[1], lo[2], one);     // step 1, half 0
    b[24] = make_float4(n[0], n[1], n[2], 0.f);        // step 1, half 1
  }
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// A wait that never ends (a lost copy) traps, so the launch fails instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == kWaitLimit) __trap();
  }
}

// Arm ``bar`` with one tile's bytes and start its bulk copy (TMA).
__device__ __forceinline__ void load_tile(uint32_t dst, const void* src,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(kTileBytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(kTileBytes), "r"(bar) : "memory");
}

// wgmma's shared-memory descriptor of one k8 step of a tile: no swizzle,
// K-major core matrices of 8 rows x 16 bytes; the K-adjacent one (leading
// byte offset) 128 bytes on, the next 8 rows (stride byte offset) one
// 8-row group on.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(kGroupBytes >> 4) << 32);
}

// d = A B (scale_d 0) or d += A B (1) for a 64 x 128 x 8 TF32 step, A
// from registers (thread: rows g, g + 8 of its warp's 16, columns t, t + 4),
// B by descriptor; d[4i + 2h + e] = (row g + 8h, column 8i + 2t + e).
__device__ __forceinline__ void wgmma_step(float (&d)[kAcc],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

// The accumulator is written behind the compiler's back until the wait:
// make every read come after it.
__device__ __forceinline__ void hold(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Tile t of the block's walk into d: wait for its bytes, both k8 steps,
// and wait for the product.
__device__ __forceinline__ void product(float (&d)[kAcc],
                                        const uint32_t (&a)[2][4],
                                        uint32_t tiles, uint32_t full,
                                        int t) {
  const int s = t % kStages;
  mbar_wait(full + 8 * s, (t / kStages) & 1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t tile = tiles + s * kTileBytes;
  wgmma_step(d, a[0], b_desc(tile), 0);
  wgmma_step(d, a[1], b_desc(tile + kStepBytes), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hold(d);
}

// The epilogue: per row h and column parity of the 8-column block, the
// running (d2, column in its tile, tile), strict "<" in reference order.  A
// pair costs a compare on the ALU pipe and two predicated moves on the FMA
// pipe: d2 + -0 (exact for every value) and col * 0 + k, with a 0 that
// ptxas cannot fold (as selects, or as an FFMA it could hoist, both would
// take the half-rate ALU pipe too).  The tile is taken once a tile, where
// the minimum moved.  With kMask only columns < lim.
template <bool kMask>
__device__ __forceinline__ void scan(const float (&c)[kAcc], int lim, int t,
                                     float (&best)[2][kPartials],
                                     float (&col)[2][kPartials],
                                     int (&bt)[2][kPartials]) {
  const float zero = __int_as_float(t >> 30);   // +0: t < 2^30
  float was[2][kPartials];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < kPartials; ++p) was[h][p] = best[h][p];
#pragma unroll
  for (int i = 0; i < kTileRows / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * i + e;
        if (kMask && k >= lim) continue;
        asm("{\n.reg .pred p;\nsetp.lt.f32 p, %2, %0;\n"
            "@p add.rn.f32 %0, %2, 0f80000000;\n"
            "@p fma.rn.f32 %1, %1, %3, %4;\n}\n"
            : "+f"(best[h][i % kPartials]), "+f"(col[h][i % kPartials])
            : "f"(c[4 * i + 2 * h + e]), "f"(zero),
              "f"(static_cast<float>(k)));
      }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < kPartials; ++p)
      if (best[h][p] != was[h][p]) bt[h][p] = t;
}

// Warpgroup done with tile t: one thread counts it on the stage; the
// warpgroup that completes the count starts the copy of tile t + kStages
// into the stage.
__device__ __forceinline__ void release(uint32_t done, uint32_t tiles,
                                        uint32_t full, const char* src,
                                        int t, int ntiles, int groups,
                                        bool signals) {
  if (signals) {
    const int s = t % kStages;
    uint32_t n;
    asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
                 : "=r"(n) : "r"(done + 4 * s) : "memory");
    if (n + 1 == static_cast<uint32_t>(groups * (t / kStages + 1)) &&
        t + kStages < ntiles)
      load_tile(tiles + s * kTileBytes,
                src + (size_t)(t + kStages) * kTileBytes, full + 8 * s);
  }
  __syncwarp();
}

// (v, i) <- (ov, oi) if that is the smaller d2, or equal at a lower index.
__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// A block: `groups` warpgroups of 64 queries (the block's tq of them); it
// walks the reference rows [lo, hi) of its chunk in tiles, kStages tiles
// in flight.
__global__ void __launch_bounds__(kNnThreads, 1)
lab_nn_mma_kernel(const float* __restrict__ a_op, int nq,
                  const char* __restrict__ b_op, int nr, int tq, int chunk,
                  int groups, int32_t* __restrict__ idx_out,
                  float* __restrict__ d2_out) {
  __shared__ __align__(128) uint8_t s_tiles[kStages * kTileBytes];
  __shared__ __align__(8) uint64_t s_full[kStages];
  __shared__ uint32_t s_done[kStages];
  const int lo = blockIdx.y * chunk;
  const int hi = min(nr, lo + chunk);
  const int ntiles = (hi - lo + kTileRows - 1) / kTileRows;
  const uint32_t full = smem(s_full);
  const uint32_t done = smem(s_done);
  const uint32_t tiles = smem(s_tiles);
  const char* src = b_op + (size_t)lo * kNnSlots * 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      s_done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < ntiles && t < kStages; ++t)
      load_tile(tiles + t * kTileBytes, src + (size_t)t * kTileBytes,
                full + 8 * t);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int row = 16 * (threadIdx.x >> 5) + g;   // of the block's queries
  const int q0 = blockIdx.x * tq + row;
  uint32_t a[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = q0 + 8 * (v & 1);
      a[s][v] = i < nq ? __float_as_uint(
                             a_op[kNnSlots * (size_t)i + 8 * s + 4 * (v >> 1) +
                                  tg])
                       : 0u;
    }
  float best[2][kPartials], col[2][kPartials];
  int bt[2][kPartials];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int p = 0; p < kPartials; ++p) {
      best[h][p] = inf_f();
      col[h][p] = 0.f;
      bt[h][p] = 0;
    }
  const bool signals = threadIdx.x % 128 == 0;
  float c[kAcc];
  for (int t = 0; t < ntiles; ++t) {
    product(c, a, tiles, full, t);
    release(done, tiles, full, src, t, ntiles, groups, signals);
    const int j0 = lo + kTileRows * t;
    if (hi - j0 >= kTileRows)
      scan<false>(c, 0, t, best, col, bt);
    else   // the last tile of the last chunk: rows past nr never compared
      scan<true>(c, hi - j0 - 2 * tg, t, best, col, bt);
  }
  // a row's four threads hold its columns 2t, 2t + 1 of every 8: the least
  // (d2, index) of the partials and lanes is the chunk's first minimum
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best[h][0];
    int bi = lo + kTileRows * bt[h][0] + 2 * tg + static_cast<int>(col[h][0]);
#pragma unroll
    for (int p = 1; p < kPartials; ++p)
      take_min(v, bi, best[h][p],
               lo + kTileRows * bt[h][p] + 2 * tg +
                   static_cast<int>(col[h][p]));
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      take_min(v, bi, __shfl_xor_sync(0xFFFFFFFFu, v, o),
               __shfl_xor_sync(0xFFFFFFFFu, bi, o));
    const int i = q0 + 8 * h;
    if (tg == 0 && row + 8 * h < tq && i < nq) {
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

// planes (C, Hd, Wd) u8 at either stride; c/ry/rx (K, nf); the table's own
// bucket starts (K, nb1); stride 1 or 2; origins px0/py0 (K,).  The lab's
// use_cond stays in ops/lab.local_variant: the walk meets no empty bucket,
// so the kernel has nothing to skip.
extern "C" int fl_lab_local(const void* planes, int c, int hd, int wd,
                            const void* tc, const void* tr, const void* tx,
                            const void* bstart, int k, int nf, int nb1,
                            int stride, const void* px0, const void* py0,
                            void* out, void* stream) {
  if ((stride != 1 && stride != 2) || nb1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LocalArgs p = {};
  p.planes = static_cast<const uint8_t*>(planes);
  p.hd = hd;
  p.wd = wd;
  p.stride = stride;
  p.last_byte = static_cast<unsigned>((size_t)c * hd * wd - 1);
  p.tc = static_cast<const int32_t*>(tc);
  p.tr = static_cast<const int32_t*>(tr);
  p.tx = static_cast<const int32_t*>(tx);
  p.bstart = static_cast<const int32_t*>(bstart);
  p.nf = nf;
  p.nb1 = nb1;
  p.px0 = static_cast<const int32_t*>(px0);
  p.py0 = static_cast<const int32_t*>(py0);
  p.out = static_cast<int32_t*>(out);
  const size_t part = (size_t)kSlices * kWin * kPartStride * 4;
  const size_t staged = (size_t)nf * sizeof(int2);
  const size_t smem = staged > part ? staged : part;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wd % 4 == 0)
    lab_local_kernel<true><<<k, kLThreads, smem, s>>>(p);
  else
    lab_local_kernel<false><<<k, kLThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// query (nq, 3) and ref (nr, 3) f32 -> a_op (nq, 16) and b_op (nr_pad,
// 16) f32 in the tile order, nr_pad = nr rounded up to 64
// (ops/lab.nn_operands).
extern "C" int fl_lab_nn_operands(const void* query, int nq, const void* ref,
                                  int nr, int nr_pad, void* a_op, void* b_op,
                                  void* stream) {
  if (nr_pad % kTileRows || nr_pad < nr) return cudaErrorInvalidValue;
  const int n = nq > nr_pad ? nq : nr_pad;
  if (n == 0) return cudaSuccess;
  lab_nn_operands_kernel<<<(n + kPrepThreads - 1) / kPrepThreads,
                           kPrepThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(ref),
      nr, nr_pad, static_cast<float4*>(a_op), static_cast<float4*>(b_op));
  return static_cast<int>(cudaGetLastError());
}

// The operands of fl_lab_nn_operands; blocks of tq queries (at most 256:
// ceil(tq / 64) warpgroups) each walk `chunk` reference rows (a multiple
// of 64); with nchunks = ceil(nr / chunk) > 1, part_idx/part_d2 hold the
// (nchunks, nq) minima for the merge.
extern "C" int fl_lab_nn_mma(const void* a_op, int nq, const void* b_op,
                             int nr, int tq, int chunk, int nchunks,
                             void* part_idx, void* part_d2, void* idx,
                             void* d2, void* stream) {
  const int groups = (tq + 63) / 64;
  if (tq < 1 || groups > kMaxGroups || chunk < 1 || chunk % kTileRows ||
      nr < 1 || nchunks != (nr + chunk - 1) / chunk)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool merge = nchunks > 1;
  const dim3 grid((nq + tq - 1) / tq, nchunks);
  lab_nn_mma_kernel<<<grid, 128 * groups, 0, s>>>(
      static_cast<const float*>(a_op), nq, static_cast<const char*>(b_op),
      nr, tq, chunk, groups, static_cast<int32_t*>(merge ? part_idx : idx),
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
