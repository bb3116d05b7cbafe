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
// as much: each vertex-sample pair is 16 instructions (3 differences, d^2
// in 3, a clamp, an rsqrt, the cube and weight in 3, the colsum add and 3
// multiply-adds), so the SM's issue rate, not HBM, sets that half, and a
// thread that owns one vertex also spends five scalar shared loads per
// sample (the sample's coordinates, weight and id).  Design:
// * each thread owns V consecutive vertices, so each staged sample is read
//   from shared memory once for all V: one 16-byte record {x, y, z,
//   deg + 1} (d = 4: the coordinates, the weight apart) and its id;
// * the self-pair test runs only for a sample that is one of the thread's
//   V vertices; rsqrt skips its subnormal-input scaling when eps^2 is a
//   normal float, as max(d^2, eps^2) then is (the same bits);
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

#include <cfloat>
#include <cstdint>

namespace {

constexpr int MAX_OFFSETS = 32;  // ops/dia.py MAX_OFFSETS
constexpr float TINY = 1e-30f;   // forceatlas/forces.py TINY
constexpr int THREADS = 256;
constexpr int V = 4;             // consecutive vertices per thread
constexpr int TILE = THREADS * V;
constexpr int SAMPLES = 256;     // samples staged per pass

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
struct Samples {
  float4 rec[SAMPLES];                 // coordinates; d <= 3: .w = deg + 1
  float deg[D == 4 ? SAMPLES : 1];     // d = 4: deg + 1
  int id[SAMPLES];
};

// samples [j0, j0 + cnt) of the draw into shared memory
template <int D>
__device__ __forceinline__ void stage_samples(
    Samples<D>& sm, const float* __restrict__ x,
    const float* __restrict__ deg_p1, const int* __restrict__ idx, int j0,
    int cnt) {
  for (int t = threadIdx.x; t < cnt; t += THREADS) {
    const int id = idx[j0 + t];
    float r[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < D; ++k) r[k] = x[static_cast<size_t>(id) * D + k];
    if (D < 4)
      r[3] = deg_p1[id];
    else
      sm.deg[t] = deg_p1[id];
    sm.rec[t] = make_float4(r[0], r[1], r[2], r[3]);
    sm.id[t] = id;
  }
}

static_assert(V % 4 == 0, "a thread's V rows are whole 16-byte words");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// N contiguous floats from p into q, in 16-byte loads
template <int N>
__device__ __forceinline__ void load_span(const float* __restrict__ p,
                                          float (&q)[N]) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + u);
    q[4 * u] = v.x;
    q[4 * u + 1] = v.y;
    q[4 * u + 2] = v.z;
    q[4 * u + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_span(float* __restrict__ p,
                                           const float (&q)[N]) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u)
    reinterpret_cast<float4*>(p)[u] =
        make_float4(q[4 * u], q[4 * u + 1], q[4 * u + 2], q[4 * u + 3]);
}

// rows i0 .. i0 + V - 1 of a row-major [n, D] array, 0 past n: V * D
// contiguous floats, 16-byte loads where the V rows exist and align
template <int D>
__device__ __forceinline__ void load_rows(const float* __restrict__ a,
                                          int i0, int n, float (&r)[V][D]) {
  const float* p = a + static_cast<size_t>(i0) * D;
  if (i0 + V <= n && aligned16(p)) {
    float q[V * D];
    load_span<V * D>(p, q);
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < D; ++k) r[v][k] = q[v * D + k];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < D; ++k) r[v][k] = i0 + v < n ? p[v * D + k] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ a, int i0,
                                           int n, const float (&r)[V][D]) {
  float* p = a + static_cast<size_t>(i0) * D;
  if (i0 + V <= n && aligned16(p)) {
    float q[V * D];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < D; ++k) q[v * D + k] = r[v][k];
    store_span<V * D>(p, q);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (i0 + v < n) {
#pragma unroll
        for (int k = 0; k < D; ++k) p[v * D + k] = r[v][k];
      }
  }
}

// entries i0 .. i0 + V - 1 of a [n] vector, 0 past n
__device__ __forceinline__ void load_vec(const float* __restrict__ a, int i0,
                                         int n, float (&r)[V]) {
  if (i0 + V <= n && aligned16(a + i0)) {
    load_span<V>(a + i0, r);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = i0 + v < n ? a[i0 + v] : 0.f;
  }
}

// 1/sqrt(v), the approximation of rsqrtf without its scaling of subnormal
// inputs: the same bits wherever v is a normal float
__device__ __forceinline__ float rsqrt_ftz(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// one vertex-sample pair of the estimator (sampled_repulsion.cuh), added
// to the vertex's sums; FTZ where eps^2 is a normal float, so that
// max(d2, eps^2) is one too
template <int D, bool FTZ>
__device__ __forceinline__ void pair(const float (&xs)[4], float degs,
                                     bool self, const float (&xi)[D],
                                     float eps2, float& colsum,
                                     float (&acc)[D]) {
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float dk = xs[k] - xi[k];
    d2 += dk * dk;
  }
  const float m = fmaxf(d2, eps2);
  const float inv = FTZ ? rsqrt_ftz(m) : rsqrtf(m);
  const float w = self ? 0.f : degs * (inv * inv * inv);
  colsum += w;
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] += w * xs[k];
}

// the V vertices' sampled repulsion sums (colsum, acc), each vertex's
// samples in draw order; every thread of the block must call it
template <int D, bool FTZ>
__device__ __forceinline__ void sample_sums(
    Samples<D>& sm, const float* __restrict__ x,
    const float* __restrict__ deg_p1, const int* __restrict__ idx, int s,
    int i0, float eps2, const float (&xi)[V][D],
    float (&colsum)[V], float (&acc)[V][D]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    colsum[v] = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) acc[v][k] = 0.f;
  }
  for (int j0 = 0; j0 < s; j0 += SAMPLES) {
    const int cnt = min(SAMPLES, s - j0);
    __syncthreads();
    stage_samples<D>(sm, x, deg_p1, idx, j0, cnt);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float4 rec = sm.rec[t];
      const float xs[4] = {rec.x, rec.y, rec.z, rec.w};
      const float degs = D < 4 ? rec.w : sm.deg[t];
      const int sid = sm.id[t];
      // the self-pair test only where the sample is one of the V vertices
      if (static_cast<unsigned>(sid - i0) < static_cast<unsigned>(V)) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          pair<D, FTZ>(xs, degs, sid == i0 + v, xi[v], eps2, colsum[v],
                       acc[v]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          pair<D, FTZ>(xs, degs, false, xi[v], eps2, colsum[v], acc[v]);
      }
    }
  }
}

// y = y_res + the DIA offsets' terms in plan order, for the V vertices
template <int D>
__device__ __forceinline__ void dia_sums(
    int n, int n_off, const int* off, const float* __restrict__ dia_w,
    const float* __restrict__ y_res, const float* __restrict__ x, int i0,
    float (&y)[V][D]) {
  if (y_res != nullptr) {
    load_rows<D>(y_res, i0, n, y);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int k = 0; k < D; ++k) y[v][k] = 0.f;
  }
  for (int o = 0; o < n_off; ++o) {
    float w[V];
    load_vec(dia_w + static_cast<size_t>(o) * n, i0, n, w);
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
  __shared__ Samples<D> sm;
  __shared__ int off[MAX_OFFSETS];
  if (threadIdx.x < n_off) off[threadIdx.x] = offsets[threadIdx.x];
  const int i0 = blockIdx.x * TILE + threadIdx.x * V;
  float xi[V][D], colsum[V], acc[V][D], y[V][D];
  load_rows<D>(x, i0, n, xi);
  // its first barrier also publishes ``off``
  sample_sums<D, FTZ>(sm, x, deg_p1, idx, s, i0, p.eps2, xi, colsum, acc);
  dia_sums<D>(n, n_off, off, dia_w, y_res, x, i0, y);

  float fp[V][D], dp1[V], dw[V];
  load_rows<D>(f_prev, i0, n, fp);
  load_vec(deg_p1, i0, n, dp1);
  load_vec(deg_w, i0, n, dw);
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
  store_rows<D>(x_out, i0, n, xo);
  store_rows<D>(f_out, i0, n, f);
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
  if (p.eps2 >= FLT_MIN)
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
