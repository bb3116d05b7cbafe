// Kernel D: one whole ForceAtlas iteration for sampled-repulsion graphs,
// [n, d] float32 state in, (x', f) out.
//
// Per vertex i, in this order:
//   y    = y_res_i (if given) + sum_k w_k[i] * x[i + o_k]  (DIA offsets in
//          plan order; i + o_k outside [0, n) is skipped: its weight is 0)
//   att  = attract * (y - x_i * deg_w_i)
//   rep  = repel * (n/s) * (deg_i + 1) * f_i   (sampled_repulsion.cuh)
//   grav = -(x_i / max(|x_i|, TINY)) * gravity * (deg_i + 1)
//   f    = att + rep + grav
//   swing = |f - f_prev|,  speed = ks*tol / (1 + tol*sqrt(swing)),
//   speed = min(speed, ksmax / max(|f|, TINY)) where |f| > 0
//   x'   = x_i + f * speed
//
// Replaces graph_embed_tpu/ops/pallas/fused_step.py:fa_step_fused (:127,
// pallas_call :199), body _fused_kernel (:85).  The TPU kernel rolls x
// within a lane block plus one block of halo (prev/cur/next views), so far
// DIA offsets are pre-applied by the caller; here a thread reads x[i + o]
// straight from device memory, so every offset is applied in-kernel and
// there is no near/far split.  Residual (non-DIA) edges arrive as y_res,
// kernel A's output, launched before this kernel.
//
// Bound on this card: bytes at small s, operations at large s.  Per vertex
// the kernel reads x_i, K neighbour rows (mostly L2 hits along the mesh's
// strides), K DIA weights, f_prev, y_res, deg_w and deg + 1, and writes x'
// and f: ~(4d + K + 3) * 4 bytes; the s sample terms add ~(3d+8)*s float32
// operations from shared memory.  Design: one thread per vertex, the
// offsets and the sample tiles in shared memory, every sum in a fixed
// order: deterministic, no atomics.  Later work: fuse kernel A's residual
// gather, several vertices per thread.

#include <cuda_runtime.h>

#include "sampled_repulsion.cuh"

namespace {

constexpr int MAX_OFFSETS = 32;  // ops/dia.py MAX_OFFSETS
constexpr float TINY = 1e-30f;   // forceatlas/forces.py TINY

struct StepParams {
  float coef;     // repel * n / s
  float eps2;     // eps^2
  float attract;
  float gravity;
  float ks_tol;   // ks * tolerate
  float tolerate;
  float ksmax;
};

template <int D>
__global__ void __launch_bounds__(ge::ROW_BLOCK)
fused_step_kernel(int n, int s, int n_off, const int* __restrict__ offsets,
                  const float* __restrict__ dia_w,
                  const float* __restrict__ y_res,
                  const float* __restrict__ x,
                  const float* __restrict__ f_prev,
                  const float* __restrict__ deg_w,
                  const float* __restrict__ deg_p1,
                  const int* __restrict__ idx, StepParams p,
                  float* __restrict__ x_out, float* __restrict__ f_out) {
  __shared__ ge::SampleTile<D> tile;
  __shared__ int off[MAX_OFFSETS];
  if (threadIdx.x < n_off) off[threadIdx.x] = offsets[threadIdx.x];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const size_t row = static_cast<size_t>(i) * D;
  float xi[D], rep[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xi[k] = active ? x[row + k] : 0.f;
  // synchronises the block before the offsets are read
  ge::sampled_repulsion_row<D>(x, deg_p1, idx, s, i, active, xi, p.eps2,
                               tile, rep);
  if (!active) return;

  float y[D];
#pragma unroll
  for (int k = 0; k < D; ++k) y[k] = y_res ? y_res[row + k] : 0.f;
  for (int o = 0; o < n_off; ++o) {
    const long long j = static_cast<long long>(i) + off[o];
    if (j < 0 || j >= n) continue;
    const float w = dia_w[static_cast<size_t>(o) * n + i];
    const float* xj = x + static_cast<size_t>(j) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) y[k] += w * xj[k];
  }

  const float dp1 = deg_p1[i];
  const float dw = deg_w[i];
  const float rep_scale = p.coef * dp1;
  float n2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) n2 += xi[k] * xi[k];
  const float mag = fmaxf(sqrtf(n2), TINY);
  const float g = p.gravity * dp1;

  float f[D];
  float swing2 = 0.f, total2 = 0.f;
  const float* fp = f_prev + row;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float att = p.attract * (y[k] - xi[k] * dw);
    const float grav = -(xi[k] / mag) * g;
    f[k] = att + rep_scale * rep[k] + grav;
    const float df = f[k] - fp[k];
    swing2 += df * df;
    total2 += f[k] * f[k];
  }
  float speed = p.ks_tol / (1.f + p.tolerate * sqrtf(sqrtf(swing2)));
  const float total = sqrtf(total2);
  if (total > 0.f) speed = fminf(speed, p.ksmax / fmaxf(total, TINY));
#pragma unroll
  for (int k = 0; k < D; ++k) {
    x_out[row + k] = xi[k] + f[k] * speed;
    f_out[row + k] = f[k];
  }
}

template <int D>
void launch(int n, int s, int n_off, const int* offsets, const float* dia_w,
            const float* y_res, const float* x, const float* f_prev,
            const float* deg_w, const float* deg_p1, const int* idx,
            StepParams p, float* x_out, float* f_out, cudaStream_t stream) {
  const int grid = (n + ge::ROW_BLOCK - 1) / ge::ROW_BLOCK;
  fused_step_kernel<D><<<grid, ge::ROW_BLOCK, 0, stream>>>(
      n, s, n_off, offsets, dia_w, y_res, x, f_prev, deg_w, deg_p1, idx, p,
      x_out, f_out);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// guarantees n > 0, s > 0, 1 <= d <= 4, 0 <= n_off <= 32 (dia_w [n_off, n]
// row-major, may be null when n_off == 0), every sample id in [0, n);
// y_res may be null.
extern "C" int ge_fused_step(int n, int d, int s, int n_off,
                             const void* offsets, const void* dia_w,
                             const void* y_res, const void* x,
                             const void* f_prev, const void* deg_w,
                             const void* deg_p1, const void* idx, float coef,
                             float eps2, float attract, float gravity,
                             float ks_tol, float tolerate, float ksmax,
                             void* x_out, void* f_out, void* stream) {
  if (n_off < 0 || n_off > MAX_OFFSETS)
    return static_cast<int>(cudaErrorInvalidValue);
  const StepParams p{coef, eps2, attract, gravity, ks_tol, tolerate, ksmax};
  const int* o = static_cast<const int*>(offsets);
  const float* w = static_cast<const float*>(dia_w);
  const float* yr = static_cast<const float*>(y_res);
  const float* xf = static_cast<const float*>(x);
  const float* fp = static_cast<const float*>(f_prev);
  const float* dw = static_cast<const float*>(deg_w);
  const float* dp = static_cast<const float*>(deg_p1);
  const int* id = static_cast<const int*>(idx);
  float* xo = static_cast<float*>(x_out);
  float* fo = static_cast<float*>(f_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1:
      launch<1>(n, s, n_off, o, w, yr, xf, fp, dw, dp, id, p, xo, fo, st);
      break;
    case 2:
      launch<2>(n, s, n_off, o, w, yr, xf, fp, dw, dp, id, p, xo, fo, st);
      break;
    case 3:
      launch<3>(n, s, n_off, o, w, yr, xf, fp, dw, dp, id, p, xo, fo, st);
      break;
    case 4:
      launch<4>(n, s, n_off, o, w, yr, xf, fp, dw, dp, id, p, xo, fo, st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
