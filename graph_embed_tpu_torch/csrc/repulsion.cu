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
// state; the samples sit in shared memory.  Design: kernel D's sample loop
// (sampled_repulsion.cuh): V consecutive vertices per thread, each staged
// sample one 16-byte shared record read once for all V, the self-pair
// test only where a sample is one of them, rsqrt without subnormal scaling
// where eps^2 is normal; rows read and written in 16-byte words.  One
// block per tile of BLOCK * V vertices: the whole grid is resident at
// once, so the SM that holds the most blocks sets the time, and blocks of
// 128 threads (twice kernel D's count of blocks) spread the tiles more
// evenly over the 132 SMs.  Every vertex adds its samples in draw order
// with the expressions of a thread-per-vertex walk (deterministic,
// bitwise that walk's).

#include <cuda_runtime.h>

#include "sampled_repulsion.cuh"

namespace {

using ge::V;

constexpr int BLOCK = 128;
constexpr int TILE = BLOCK * V;

template <int D, bool FTZ>
__global__ void __launch_bounds__(BLOCK)
repulsion_kernel(int n, int s, const float* __restrict__ x,
                 const float* __restrict__ deg_p1,
                 const int* __restrict__ idx, float coef, float eps2,
                 float* __restrict__ out) {
  __shared__ ge::Samples<D> sm;
  const int i0 = blockIdx.x * TILE + threadIdx.x * V;
  float xi[V][D], colsum[V], acc[V][D];
  ge::load_rows<D>(x, i0, n, xi);
  ge::sample_sums<D, FTZ, BLOCK>(sm, x, deg_p1, idx, s, i0, eps2, xi,
                                 colsum, acc);
  float dp1[V], rep[V][D];
  ge::load_vec(deg_p1, i0, n, dp1);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float scale = coef * dp1[v];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float f = xi[v][k] * colsum[v] - acc[v][k];
      rep[v][k] = scale * f;
    }
  }
  ge::store_rows<D>(out, i0, n, rep);
}

template <int D>
void launch(int n, int s, const float* x, const float* deg_p1, const int* idx,
            float coef, float eps2, float* out, cudaStream_t stream) {
  const int grid = (n + TILE - 1) / TILE;
  if (ge::use_ftz(eps2))
    repulsion_kernel<D, true><<<grid, BLOCK, 0, stream>>>(
        n, s, x, deg_p1, idx, coef, eps2, out);
  else
    repulsion_kernel<D, false><<<grid, BLOCK, 0, stream>>>(
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
