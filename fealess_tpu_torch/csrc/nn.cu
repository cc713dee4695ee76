// Brute-force nearest neighbour for ICP on Hopper: K3.
//
// fl_nearest_neighbor replaces fealess_tpu/ops/nn_pallas.py:35 _nn_kernel
// (launched by nearest_neighbor_tiled, reached from icp.nearest_neighbor);
// contract _nn_xla_blocked.  For each query row i:
//   idx[i] = the first j minimising d2(i, j),
//   d2(i, j) = (dx*dx + dy*dy) + dz*dz  (f32, d = query[i] - ref[j]),
// and (idx, d2) = (0, +inf) when no d2 is below +inf.  Callers pad invalid
// rows to icp.PAD_COORD so they never win.
//
// What bounds it on this card: Nq x Nr pairs at 8 f32 operations each.  At
// the ICP's 16384 x 16384 that is 2.15e9 operations on 2 x 196 KB of input
// that stays in L2: 0.032 ms at the 67 TFLOP/s non-tensor f32 peak, so it
// is compute-bound.  That peak counts a fused multiply-add as two
// operations; d2 may not fuse (below), and the running minimum adds a
// compare and two selects, so ~11 issued instructions a pair put the
// practical ceiling near 0.09 ms, about a third of the bound's rate.
//
// Rounding: d2 is formed with round-to-nearest intrinsics and no fused
// multiply-add (the library is built with -fmad=false) in the order
// ((dx*dx + dy*dy) + dz*dz), so it is bitwise equal to the plain twin's
// separate elementwise kernels; an FMA rounds differently and flips argmin
// on near-ties.  The tensor-core form |q|^2 + |r|^2 - 2 q.r is not used for
// the same reason.
//
// Design:
// - Work is split over query tiles AND reference chunks: a block of 128
//   threads holds 4 queries per thread in registers (a 512-query tile) and
//   scans one chunk of the reference set.  The wrapper picks the chunk
//   count so that about 4 blocks land on every SM (16384 x 16384: 32 query
//   tiles x 16 chunks of 1024 rows = 512 blocks).
// - The chunk streams through shared memory in 512-row tiles, each row
//   stored as a float4 so that one broadcast 16-byte load feeds 4 queries'
//   12 subtractions, multiplies and adds.  Tiles are double-buffered: the
//   next tile is copied with cp.async while the current one is scanned.
//   Rows past the chunk's end are staged as +inf, whose d2 (+inf or NaN)
//   never passes the strict "<".
// - Within a chunk each query keeps a running (best, best_j) in j order
//   with a strict "<", i.e. the chunk's first minimum.  A second kernel
//   merges the (chunks, Nq) partials in chunk order with a strict "<", so
//   the earliest chunk wins a tie across chunks and the result is the
//   global first minimum, exactly, whatever the split.  With one chunk the
//   first kernel writes the result itself.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                 // 4 warps a block
constexpr int kQ = 4;                         // queries a thread
constexpr int kQueryTile = kThreads * kQ;     // ops/nn.py QUERY_TILE
constexpr int kRefTile = 512;  // rows a shared-memory stage (REF_TILE)
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Copy reference rows [lo, min(lo + kRefTile, hi)) into `tile` as
// (x, y, z, -) float4s; rows from hi on get +inf coordinates.
__device__ __forceinline__ void stage(float4* tile, const float* ref, int lo,
                                      int hi) {
  float* t = reinterpret_cast<float*>(tile);
  const int n = min(kRefTile, hi - lo);
  const float* src = ref + 3 * (size_t)lo;
  for (int e = threadIdx.x; e < 3 * kRefTile; e += kThreads) {
    const int row = e / 3;
    const int col = e - 3 * row;
    if (row < n)
      cp_async4(t + 4 * row + col, src + e);
    else
      t[4 * row + col] = inf_f();
  }
}

__global__ void __launch_bounds__(kThreads)
nn_chunk_kernel(const float* __restrict__ query, int nq,
                const float* __restrict__ ref, int nr, int chunk,
                int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float4 tiles[2][kRefTile];
  const int c = blockIdx.y;
  const int lo = c * chunk;
  const int hi = min(nr, lo + chunk);
  const int q0 = blockIdx.x * kQueryTile + threadIdx.x;
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
  int bj[kQ];
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = q0 + u * kThreads;
    const bool live = i < nq;
    qx[u] = live ? query[3 * (size_t)i] : 0.f;
    qy[u] = live ? query[3 * (size_t)i + 1] : 0.f;
    qz[u] = live ? query[3 * (size_t)i + 2] : 0.f;
    best[u] = inf_f();
    bj[u] = 0;
  }
  const int ntiles = hi > lo ? (hi - lo + kRefTile - 1) / kRefTile : 0;
  if (ntiles > 0) stage(tiles[0], ref, lo, hi);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      stage(tiles[(t + 1) & 1], ref, lo + (t + 1) * kRefTile, hi);
    cp_async_commit();
    cp_async_wait_prior();  // every group but the newest: tile t is in
    __syncthreads();
    const float4* tile = tiles[t & 1];
    const int base = lo + t * kRefTile;
#pragma unroll 8
    for (int k = 0; k < kRefTile; ++k) {
      const float4 r = tile[k];
      const int j = base + k;
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        const float dx = __fsub_rn(qx[u], r.x);
        const float dy = __fsub_rn(qy[u], r.y);
        const float dz = __fsub_rn(qz[u], r.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        if (d2 < best[u]) {
          best[u] = d2;
          bj[u] = j;
        }
      }
    }
    __syncthreads();  // tile t is read before tile t + 2 overwrites it
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = q0 + u * kThreads;
    if (i < nq) {
      idx_out[(size_t)c * nq + i] = bj[u];
      d2_out[(size_t)c * nq + i] = best[u];
    }
  }
}

__global__ void nn_merge_kernel(const int32_t* __restrict__ part_idx,
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

// The tile sizes, which ops/nn.py plans the chunk split with and checks
// against these at first use.
extern "C" int fl_nn_query_tile() { return kQueryTile; }
extern "C" int fl_nn_ref_tile() { return kRefTile; }

// query (nq, 3) and ref (nr, 3) f32; the reference set is cut into nchunks
// chunks of `chunk` rows (the last may be shorter, none empty).  With
// nchunks > 1, part_idx/part_d2 hold (nchunks, nq) partials for the merge.
extern "C" int fl_nearest_neighbor(const void* query, int nq, const void* ref,
                                   int nr, int chunk, int nchunks,
                                   void* part_idx, void* part_d2, void* idx,
                                   void* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool merge = nchunks > 1;
  const dim3 grid((nq + kQueryTile - 1) / kQueryTile, nchunks);
  nn_chunk_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(ref),
      nr, chunk, static_cast<int32_t*>(merge ? part_idx : idx),
      static_cast<float*>(merge ? part_d2 : d2));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return static_cast<int>(err);
  nn_merge_kernel<<<(nq + kMergeThreads - 1) / kMergeThreads, kMergeThreads,
                    0, s>>>(
      static_cast<const int32_t*>(part_idx),
      static_cast<const float*>(part_d2), nq, nchunks,
      static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
