// Kernel C: sampled repulsion over s shared samples, [n, d] float32 state.
//
//   rep_i = repel * (n/s) * (deg_i + 1) * f_i   (f_i: sampled_repulsion.cuh)
//
// Replaces graph_embed_tpu/ops/pallas/repulsion.py:repulsion_sampled_fused
// (:86, pallas_call :108), body _rep_kernel (:76) over _rep_math (:37).
// The step runs it where kernel D does not apply (linlog graphs).
//
// Bound on this card: operations.  Each vertex does s sample terms of
// ~3d+8 float32 operations and one rsqrt against (2d+1)*4 bytes of its own
// state; the samples sit in shared memory.  Design: one thread per vertex,
// samples staged per block and read as broadcasts, summed in draw order
// (deterministic).  Later work: several vertices per thread to reuse each
// staged sample from registers.

#include <cuda_runtime.h>

#include "sampled_repulsion.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(ge::ROW_BLOCK)
repulsion_kernel(int n, int s, const float* __restrict__ x,
                 const float* __restrict__ deg_p1,
                 const int* __restrict__ idx, float coef, float eps2,
                 float* __restrict__ out) {
  __shared__ ge::SampleTile<D> tile;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float xi[D], f[D];
#pragma unroll
  for (int k = 0; k < D; ++k)
    xi[k] = active ? x[static_cast<size_t>(i) * D + k] : 0.f;
  ge::sampled_repulsion_row<D>(x, deg_p1, idx, s, i, active, xi, eps2, tile,
                               f);
  if (!active) return;
  const float scale = coef * deg_p1[i];
#pragma unroll
  for (int k = 0; k < D; ++k)
    out[static_cast<size_t>(i) * D + k] = scale * f[k];
}

template <int D>
void launch(int n, int s, const float* x, const float* deg_p1, const int* idx,
            float coef, float eps2, float* out, cudaStream_t stream) {
  const int grid = (n + ge::ROW_BLOCK - 1) / ge::ROW_BLOCK;
  repulsion_kernel<D><<<grid, ge::ROW_BLOCK, 0, stream>>>(
      n, s, x, deg_p1, idx, coef, eps2, out);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// guarantees n > 0, s > 0, 1 <= d <= 4 and every id in [0, n).
// coef = repel * n / s; eps2 = eps * eps.
extern "C" int ge_sampled_repulsion(int n, int d, int s, const void* x,
                                    const void* deg_p1, const void* idx,
                                    float coef, float eps2, void* out,
                                    void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(deg_p1);
  const int* id = static_cast<const int*>(idx);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(n, s, xf, df, id, coef, eps2, of, st); break;
    case 2: launch<2>(n, s, xf, df, id, coef, eps2, of, st); break;
    case 3: launch<3>(n, s, xf, df, id, coef, eps2, of, st); break;
    case 4: launch<4>(n, s, xf, df, id, coef, eps2, of, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
