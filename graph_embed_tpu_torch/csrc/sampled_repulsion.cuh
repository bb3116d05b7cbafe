// The sampled repulsion estimator of one vertex, shared by kernel C
// (repulsion.cu) and kernel D (fused_step.cu).
//
// Counterpart of graph_embed_tpu/ops/pallas/repulsion.py:_rep_math (:37):
// over s shared samples j (ids idx_j, drawn with replacement; coordinates
// xs_j, weights degs_j = deg_j + 1),
//
//   d2  = sum_k (xs_jk - x_ik)^2            (diff form, exact in float32)
//   inv = rsqrt(max(d2, eps^2))
//   w_j = degs_j * inv^3,  w_j = 0 where idx_j == i  (self pair)
//   f_i = x_i * sum_j w_j - sum_j w_j xs_j
//
// and the caller scales f_i by repel * (n/s) * (deg_i + 1).  The TPU
// kernel lays the samples out lane- and sublane-replicated and takes the
// last sum as a bf16 matmul; here every thread owns one vertex and adds
// the samples in their draw order in float32, so no tensor core, no TF32
// and no atomics enter and the result is deterministic.
//
// The block stages SAMPLE_TILE samples at a time in shared memory
// (coordinates, weights and ids, gathered by the block itself), and every
// thread reads each staged sample as a broadcast.

#pragma once

#include <cuda_runtime.h>

namespace ge {

constexpr int SAMPLE_TILE = 256;
constexpr int ROW_BLOCK = 256;  // threads per block, one vertex each

template <int D>
struct SampleTile {
  float xs[SAMPLE_TILE][D];
  float degs[SAMPLE_TILE];
  int idx[SAMPLE_TILE];
};

// f (unscaled, see above) for vertex i at coordinates xi.  Every thread of
// the block must call it, active or not: it synchronises the block.
template <int D>
__device__ __forceinline__ void sampled_repulsion_row(
    const float* __restrict__ x, const float* __restrict__ deg_p1,
    const int* __restrict__ idx, int s, int i, bool active,
    const float (&xi)[D], float eps2, SampleTile<D>& tile, float (&f)[D]) {
  float colsum = 0.f;
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < s; j0 += SAMPLE_TILE) {
    const int cnt = min(SAMPLE_TILE, s - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const int id = idx[j0 + t];
      tile.idx[t] = id;
      tile.degs[t] = deg_p1[id];
#pragma unroll
      for (int k = 0; k < D; ++k)
        tile.xs[t][k] = x[static_cast<size_t>(id) * D + k];
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < cnt; ++t) {
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float dk = tile.xs[t][k] - xi[k];
          d2 += dk * dk;
        }
        const float inv = rsqrtf(fmaxf(d2, eps2));
        const float w = tile.idx[t] == i ? 0.f
                                         : tile.degs[t] * (inv * inv * inv);
        colsum += w;
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] += w * tile.xs[t][k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) f[k] = xi[k] * colsum - acc[k];
}

}  // namespace ge
