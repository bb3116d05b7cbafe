// Kernel B: within-aggregate all-pairs repulsion in slot space.
//
//   out_i = repel * w_i * sum_{j in agg(i), j != i} w_j (x_i - x_j) / max(d_ij, eps)^3
//
// with w = deg_loc + 1 on member slots and w = 0 on ghost slots (the
// ghost padding of each aggregate up to its power-of-two size class S).
// Replaces the three Pallas bodies of the JAX package's
// graph_embed_tpu/forceatlas/multilevel_tiled.py:bucket_repulsion:
// _bucket_repulsion_roll_kernel (:258, S <= 16, lane rotations),
// _bucket_repulsion_chunk_kernel (:295, S = 32/64, [128,128] block-diagonal
// tiles) and _bucket_repulsion_kernel (:354, S <= 256, [C,S,S] masked
// pairs), plus the XLA gram batches of the exact buckets above 256 slots
// (:476-490).  Those TPU variants exist to fill 128-lane vregs; here one
// kernel family covers every exact bucket of a level in one launch.
//
// Bound on this card: operations.  Each slot does S pair terms of ~d+10
// float32 operations (sqrt and an IEEE divide among them) against ~(d+1)*4
// bytes of its own state, so the card's float32 rate, not memory, is the
// limit.  Design: a CTA of TILE = 256 threads owns 256 consecutive slots,
// one thread per slot.  Partner coordinates and weights are staged in
// shared memory and read as broadcasts (every thread of a warp reads the
// same partner).  For S <= 256 the CTA's own slots hold whole aggregates
// (S divides 256 and CTA starts are 256-aligned within a bucket): one stage.
// For S > 256 the CTA lies inside one aggregate and stages its S/256
// partner tiles in turn.  Each thread accumulates over partners in a fixed
// order with the diff-form d^2 (exact; no gram identity, so no TF32 or
// tensor cores), so the result is deterministic.  A per-CTA table
// (cta start, S, bucket base, bucket end) lets one launch cover buckets of
// every size class.  Later work: several slots per thread for the small
// classes, where a CTA finishes after 8-16 partners.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;

template <int D>
__global__ void __launch_bounds__(TILE)
bucket_repulsion_kernel(const int4* __restrict__ meta,
                        const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        float repel, float eps) {
  __shared__ float sx[D][TILE];
  __shared__ float sw[TILE];
  const int4 m = meta[blockIdx.x];
  const int start = m.x, S = m.y, base = m.z, end = m.w;
  const int tid = threadIdx.x;
  const int slot = start + tid;
  const bool live = slot < end;

  float xi[D], acc[D];
  float wi = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xi[k] = 0.f;
    acc[k] = 0.f;
  }
  if (live) {
    wi = w[slot];
#pragma unroll
    for (int k = 0; k < D; ++k) xi[k] = x[static_cast<size_t>(slot) * D + k];
  }

  const bool big = S > TILE;
  const int ntiles = big ? S / TILE : 1;
  // S > TILE: the aggregate holding this CTA; S <= TILE: this thread's own
  // aggregate, as a range of the staged tile
  const int agg_lo = base + ((start - base) / S) * S;
  int jlo = 0, jhi = TILE;
  if (!big) {
    jlo = base + ((slot - base) / S) * S - start;
    jhi = jlo + S;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int src0 = big ? agg_lo + t * TILE : start;
    const int src = src0 + tid;
    __syncthreads();
    if (src < end) {
      sw[tid] = w[src];
#pragma unroll
      for (int k = 0; k < D; ++k) sx[k][tid] = x[static_cast<size_t>(src) * D + k];
    } else {
      sw[tid] = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) sx[k][tid] = 0.f;
    }
    __syncthreads();
    if (live) {
      const int self = slot - src0;
      for (int j = jlo; j < jhi; ++j) {
        float diff[D];
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = xi[k] - sx[k][j];
          d2 = fmaf(diff[k], diff[k], d2);
        }
        const float dist = fmaxf(sqrtf(d2), eps);
        const float W = (j == self) ? 0.f : sw[j] / (dist * dist * dist);
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] = fmaf(W, diff[k], acc[k]);
      }
    }
  }
  if (live) {
    const float sc = repel * wi;
#pragma unroll
    for (int k = 0; k < D; ++k) out[static_cast<size_t>(slot) * D + k] = sc * acc[k];
  }
}

}  // namespace

// Slots per CTA; the caller's CTA table must be cut in steps of this.
extern "C" int ge_bucket_tile() { return TILE; }

// One launch over ``num_ctas`` rows of ``meta`` (int4: cta start slot, size
// class S, bucket base slot, bucket end slot).  x/out: [n_slots, d] float32,
// w: [n_slots] float32.  Returns cudaGetLastError() after the launch.  The
// caller guarantees num_ctas > 0, 1 <= d <= 4, S a power of two >= 2, and
// 16-byte aligned meta.
extern "C" int ge_bucket_repulsion(int num_ctas, int d, const void* meta,
                                   const void* x, const void* w, void* out,
                                   float repel, float eps, void* stream) {
  const int4* mt = static_cast<const int4*>(meta);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: bucket_repulsion_kernel<1><<<num_ctas, TILE, 0, s>>>(mt, xf, wf, of, repel, eps); break;
    case 2: bucket_repulsion_kernel<2><<<num_ctas, TILE, 0, s>>>(mt, xf, wf, of, repel, eps); break;
    case 3: bucket_repulsion_kernel<3><<<num_ctas, TILE, 0, s>>>(mt, xf, wf, of, repel, eps); break;
    case 4: bucket_repulsion_kernel<4><<<num_ctas, TILE, 0, s>>>(mt, xf, wf, of, repel, eps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
