// Kernel D: one whole ForceAtlas iteration for sampled-repulsion graphs,
// [n, d] float32 state in, (x', f) out.
//
// Per vertex i, in this order:
//   y    = y_res_i (if given) + sum_k w_k[i] * x[i + o_k]  (DIA offsets in
//          plan order; i + o_k outside [0, n) is skipped: its weight is 0)
//   att  = attract * (y - x_i * deg_w_i)
//   rep  = repel * (n/s) * (deg_i + 1) * f_i   (the estimator of
//          sampled_repulsion.cuh: samples in draw order)
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
// Bound on this card.  Per vertex the kernel must move ~(4d + K + 3) * 4
// bytes (x_i, f_prev, y_res, K DIA weights, deg_w, deg + 1 in; x' and f
// out; the K neighbour rows are mostly L1/L2 hits along the mesh's
// strides): that bounds it at small s.  At s = 64 samples the pairs weigh
// as much, and the SM's issue rate, not HBM, sets that half.  Design:
// * the sample loop of sampled_repulsion.cuh (kernel C's too): V
//   consecutive vertices per thread sharing one 16-byte staged sample
//   record, the self-pair test only where a sample is one of them, rsqrt
//   without subnormal scaling where eps^2 is normal (the same bits);
// * one block per tile of THREADS * V vertices, the s samples staged
//   SAMPLES at a time (a grid of resident blocks looping over tiles, which
//   gathers the samples once per block, ran slower: blocks that start
//   together keep their memory and arithmetic phases in step);
// * a thread's V rows of x, f_prev and y_res are d 16-byte loads (and its
//   x' and f d 16-byte stores), deg_w, deg + 1 and each DIA weight row one
//   where the rows align.
// Each vertex adds in a fixed order (the samples in draw order, the DIA
// offsets in plan order, y_res first) with the expressions of a
// thread-per-vertex walk, so the result is bitwise that walk's; no
// atomics.

#include <cuda_runtime.h>

#include "sampled_repulsion.cuh"

namespace {

using ge::V;

constexpr int MAX_OFFSETS = 32;  // ops/dia.py MAX_OFFSETS
constexpr float TINY = 1e-30f;   // forceatlas/forces.py TINY
constexpr int THREADS = 256;
constexpr int TILE = THREADS * V;

struct StepParams {
  float coef;     // repel * n / s
  float eps2;     // eps^2
  float attract;
  float gravity;
  float ks_tol;   // ks * tolerate
  float tolerate;
  float ksmax;
};

// y = y_res + the DIA offsets' terms in plan order, for the V vertices
template <int D>
__device__ __forceinline__ void dia_sums(
    int n, int n_off, const int* off, const float* __restrict__ dia_w,
    const float* __restrict__ y_res, const float* __restrict__ x, int i0,
    float (&y)[V][D]) {
  if (y_res != nullptr) {
    ge::load_rows<D>(y_res, i0, n, y);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < D; ++k) y[v][k] = 0.f;
  }
  for (int o = 0; o < n_off; ++o) {
    float w[V];
    ge::load_vec(dia_w + static_cast<size_t>(o) * n, i0, n, w);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long j = static_cast<long long>(i0 + v) + off[o];
      if (i0 + v >= n || j < 0 || j >= n) continue;
      const float* xj = x + static_cast<size_t>(j) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) y[v][k] += w[v] * xj[k];
    }
  }
}

template <int D, bool FTZ>
__global__ void __launch_bounds__(THREADS)
fused_step_kernel(int n, int s, int n_off, const int* __restrict__ offsets,
                  const float* __restrict__ dia_w,
                  const float* __restrict__ y_res,
                  const float* __restrict__ x,
                  const float* __restrict__ f_prev,
                  const float* __restrict__ deg_w,
                  const float* __restrict__ deg_p1,
                  const int* __restrict__ idx, StepParams p,
                  float* __restrict__ x_out, float* __restrict__ f_out) {
  __shared__ ge::Samples<D> sm;
  __shared__ int off[MAX_OFFSETS];
  if (threadIdx.x < n_off) off[threadIdx.x] = offsets[threadIdx.x];
  const int i0 = blockIdx.x * TILE + threadIdx.x * V;
  float xi[V][D], colsum[V], acc[V][D], y[V][D];
  ge::load_rows<D>(x, i0, n, xi);
  // its first barrier also publishes ``off``
  ge::sample_sums<D, FTZ, THREADS>(sm, x, deg_p1, idx, s, i0, p.eps2, xi,
                                   colsum, acc);
  dia_sums<D>(n, n_off, off, dia_w, y_res, x, i0, y);

  float fp[V][D], dp1[V], dw[V];
  ge::load_rows<D>(f_prev, i0, n, fp);
  ge::load_vec(deg_p1, i0, n, dp1);
  ge::load_vec(deg_w, i0, n, dw);
  float xo[V][D], f[V][D];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float rep[D];
#pragma unroll
    for (int k = 0; k < D; ++k) rep[k] = xi[v][k] * colsum[v] - acc[v][k];
    const float rep_scale = p.coef * dp1[v];
    float n2 = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) n2 += xi[v][k] * xi[v][k];
    const float mag = fmaxf(sqrtf(n2), TINY);
    const float g = p.gravity * dp1[v];

    float swing2 = 0.f, total2 = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float att = p.attract * (y[v][k] - xi[v][k] * dw[v]);
      const float grav = -(xi[v][k] / mag) * g;
      f[v][k] = att + rep_scale * rep[k] + grav;
      const float df = f[v][k] - fp[v][k];
      swing2 += df * df;
      total2 += f[v][k] * f[v][k];
    }
    float speed = p.ks_tol / (1.f + p.tolerate * sqrtf(sqrtf(swing2)));
    const float total = sqrtf(total2);
    if (total > 0.f) speed = fminf(speed, p.ksmax / fmaxf(total, TINY));
#pragma unroll
    for (int k = 0; k < D; ++k) xo[v][k] = xi[v][k] + f[v][k] * speed;
  }
  ge::store_rows<D>(x_out, i0, n, xo);
  ge::store_rows<D>(f_out, i0, n, f);
}

template <int D, bool FTZ>
void launch_as(int n, int s, int n_off, const int* offsets,
               const float* dia_w, const float* y_res, const float* x,
               const float* f_prev, const float* deg_w, const float* deg_p1,
               const int* idx, StepParams p, float* x_out, float* f_out,
               cudaStream_t stream) {
  fused_step_kernel<D, FTZ><<<(n + TILE - 1) / TILE, THREADS, 0, stream>>>(
      n, s, n_off, offsets, dia_w, y_res, x, f_prev, deg_w, deg_p1, idx, p,
      x_out, f_out);
}

template <int D>
void launch(int n, int s, int n_off, const int* offsets, const float* dia_w,
            const float* y_res, const float* x, const float* f_prev,
            const float* deg_w, const float* deg_p1, const int* idx,
            StepParams p, float* x_out, float* f_out, cudaStream_t stream) {
  if (ge::use_ftz(p.eps2))
    launch_as<D, true>(n, s, n_off, offsets, dia_w, y_res, x, f_prev, deg_w,
                       deg_p1, idx, p, x_out, f_out, stream);
  else
    launch_as<D, false>(n, s, n_off, offsets, dia_w, y_res, x, f_prev,
                        deg_w, deg_p1, idx, p, x_out, f_out, stream);
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
