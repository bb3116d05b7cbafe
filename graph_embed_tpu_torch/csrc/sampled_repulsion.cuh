// The sampled repulsion estimator over V consecutive vertices per thread:
// kernel C's (repulsion.cu) and kernel D's (fused_step.cu) one sample loop.
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
// last sum as a bf16 matmul; here every vertex adds the samples in their
// draw order in float32, so no tensor core, no TF32 and no atomics enter
// and the result is deterministic.
//
// Each vertex-sample pair is ~16 instructions (3 differences, d^2 in 3, a
// clamp, an rsqrt, the cube and weight in 3, the colsum add and 3
// multiply-adds), so the SM's issue rate bounds the loop.  Design:
// * each thread owns V consecutive vertices, so each staged sample is read
//   from shared memory once for all V: one 16-byte record {x, y, z,
//   deg + 1} (d = 4: the coordinates, the weight apart) and its id;
// * the self-pair test runs only for a sample that is one of the thread's
//   V vertices; rsqrt skips its subnormal-input scaling when eps^2 is a
//   normal float, as max(d^2, eps^2) then is (the same bits; ``use_ftz``);
// * the block stages SAMPLES samples at a time in shared memory, gathered
//   by the block itself;
// * a thread's V rows are d 16-byte loads and stores where the rows exist
//   and align (``load_rows``, ``store_rows``), scalar past n.
// Each vertex adds its samples in draw order with the expressions of a
// thread-per-vertex walk, so the result is bitwise that walk's.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace ge {

constexpr int V = 4;             // consecutive vertices per thread
constexpr int SAMPLES = 256;     // samples staged per pass

template <int D>
struct Samples {
  float4 rec[SAMPLES];                 // coordinates; d <= 3: .w = deg + 1
  float deg[D == 4 ? SAMPLES : 1];     // d = 4: deg + 1
  int id[SAMPLES];
};

// samples [j0, j0 + cnt) of the draw into shared memory, by a block of
// BLOCK threads
template <int D, int BLOCK>
__device__ __forceinline__ void stage_samples(
    Samples<D>& sm, const float* __restrict__ x,
    const float* __restrict__ deg_p1, const int* __restrict__ idx, int j0,
    int cnt) {
  for (int t = threadIdx.x; t < cnt; t += BLOCK) {
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

// whether the pair loop may take rsqrt_ftz (the FTZ instantiations): eps^2
// a normal float, so that max(d2, eps^2) is one too
inline bool use_ftz(float eps2) { return eps2 >= FLT_MIN; }

// one vertex-sample pair of the estimator, added to the vertex's sums
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
// samples in draw order; every thread of the block (BLOCK threads) must
// call it
template <int D, bool FTZ, int BLOCK>
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
    stage_samples<D, BLOCK>(sm, x, deg_p1, idx, j0, cnt);
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

}  // namespace ge
