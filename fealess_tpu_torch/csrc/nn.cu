// Brute-force nearest neighbour for ICP on Hopper: K3.
//
// fl_nearest_neighbor replaces fealess_tpu/ops/nn_pallas.py _nn_kernel
// (launched by nearest_neighbor_tiled, reached from icp.nearest_neighbor);
// contract _nn_xla_blocked.  For each query row i:
//   idx[i] = the first j minimising d2(i, j),
//   d2(i, j) = dx*dx + dy*dy + dz*dz  (f32, d = query[i] - ref[j]).
// Callers pad invalid rows to icp.PAD_COORD so they never win.
//
// What bounds it on this card: 16384 x 16384 pairs at ~8 f32 operations
// each (~2.1 GFLOP) on 2 x 196 KB of input, so it is compute- and
// issue-bound on the SMs' FP32 pipes, far from any memory roofline.
//
// Design: one thread per query keeps a running (min, argmin) over the
// reference rows in order with a strict "<", so the first minimum wins as
// in argmin.  Reference rows are staged through shared memory in tiles
// that every thread of the block reads as a broadcast.  d2 is formed with
// round-to-nearest intrinsics (no fused multiply-add) in the order
// ((dx*dx + dy*dy) + dz*dz), so it is bitwise equal to the plain twin's
// separate elementwise multiply and add kernels; an FMA would round
// differently and flip argmin on near-ties.  The matrix-unit form
// |q|^2 + |r|^2 - 2 q.r is not used for the same reason.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

__global__ void nearest_neighbor_kernel(const float* __restrict__ query,
                                        int nq,
                                        const float* __restrict__ ref, int nr,
                                        int32_t* __restrict__ idx_out,
                                        float* __restrict__ d2_out) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < nq) {
    qx = query[3 * (size_t)i];
    qy = query[3 * (size_t)i + 1];
    qz = query[3 * (size_t)i + 2];
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  for (int base = 0; base < nr; base += kTile) {
    const int cnt = min(kTile, nr - base);
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      const size_t o = 3 * (size_t)(base + j);
      sx[j] = ref[o];
      sy[j] = ref[o + 1];
      sz[j] = ref[o + 2];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float dx = __fsub_rn(qx, sx[j]);
      const float dy = __fsub_rn(qy, sy[j]);
      const float dz = __fsub_rn(qz, sz[j]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_j = base + j;
      }
    }
    __syncthreads();
  }
  if (i < nq) {
    idx_out[i] = best_j;
    d2_out[i] = best;
  }
}

}  // namespace

extern "C" int fl_nearest_neighbor(const void* query, int nq, const void* ref,
                                   int nr, void* idx, void* d2,
                                   void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  nearest_neighbor_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), nq, static_cast<const float*>(ref),
      nr, static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
