// Kernel F: the cross-edge attraction of one ring slot, every shard at once.
//
// For ring slot k, shard s holds the boundary block of shard (s - k) % ndev
// (the slot buffer, filled by the ring transport in parallel/overlap.py).
// Each cross edge e of shard s in slot k (sender cs_e local to s, receiver
// cr_e an index into that block) gets
//
//   out_e = diff * (attract * fa(dist, cw_e, deg_s) / dist * mask_e),
//   diff  = block[s, cr_e] - x[s * blk + cs_e],  dist = max(|diff|, eps),
//
// with fa the attraction magnitude of forceatlas/forces.py:attraction_fa
// (linlog: log1p(dist); use_weights; delta: w, 1 or sign(w)|w|^delta; nohubs:
// divided by deg_s + 1).  Padding edges (mask_e == 0, or the ghost sender
// cs_e == blk) write zeros.  The per-edge forces are summed per sender
// outside, over all slots, by the row-owned segment sum (ops/segment.py).
//
// Replaces graph_embed_tpu/parallel/overlap.py:ring_cross_forces (:274,
// pallas_call :341), body _ring_kernel (:155).  What that kernel computes
// carries over; its TPU structure does not: the lo/hi one-hot matmul gather
// out of the landed block (:210-224) is a plain indexed load here, the VMEM-
// and HBM-staged ring buffers (:226-258, RING_VMEM_BUDGET_BYTES) are TPU
// memory policy, and the cross-device startup barrier (:174-185) has no
// counterpart in one process.  The remote DMA that forwards slot k to the
// right neighbour's slot k + 1 is a copy on a side stream (overlap.py), and
// this kernel runs slot k on the compute stream meanwhile.
//
// Bound on this card: bytes.  Per edge the kernel reads cs, cr, cw and mask
// (16 bytes), and for a live edge gathers the two endpoint rows (4 * d bytes
// each) and, under nohubs, the sender's degree (4 bytes); it writes 4 * d
// bytes.  At d = 3 a live edge moves 52 bytes against about 20 operations,
// far below the card's ~20 operations per byte, so the time is bytes over
// 3.35 TB/s.  Design: one thread per (shard, edge) of the slot, neighbouring
// threads on neighbouring edges, so the four group arrays are read and the
// output written in whole cache lines; the gathered block rows of one slot
// ([ndev, B_max, d]) are small enough to stay in the 50 MB L2.  No atomics:
// the sum per sender runs after, in a fixed order.  Later work: fuse that
// sum into the kernel, and sort each slot's edges by sender for locality.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

struct FaParams {
  float attract;
  float eps;
  float delta;
  int linlog;
  int nohubs;
  int use_weights;
};

template <int D>
__global__ void __launch_bounds__(BLOCK)
ring_slot_kernel(int n_edges, int ec, int blk, int b_max,
                 const int* __restrict__ cs, const int* __restrict__ cr,
                 const float* __restrict__ cw,
                 const float* __restrict__ mask,
                 const float* __restrict__ block,
                 const float* __restrict__ x,
                 const float* __restrict__ deg_p1, FaParams p,
                 float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_edges) return;
  const int shard = t / ec;
  const int s = __ldg(cs + t);
  const float m = __ldg(mask + t);
  float* o = out + static_cast<size_t>(t) * D;
  if (m == 0.f || s >= blk) {
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] = 0.f;
    return;
  }
  const size_t row = static_cast<size_t>(shard) * blk + s;
  const float* xs = x + row * D;
  const float* xr =
      block + (static_cast<size_t>(shard) * b_max + __ldg(cr + t)) * D;
  float diff[D];
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    diff[k] = __ldg(xr + k) - __ldg(xs + k);
    d2 += diff[k] * diff[k];
  }
  const float dist = fmaxf(sqrtf(d2), p.eps);
  float fa = p.linlog ? log1pf(dist) : dist;
  const float a = p.use_weights ? __ldg(cw + t) : 1.f;
  if (p.delta == 1.f) {
    fa = fa * a;
  } else if (p.delta != 0.f) {
    const float sign = static_cast<float>((a > 0.f) - (a < 0.f));
    fa = sign * powf(fabsf(a), p.delta) * fa;
  }
  if (p.nohubs) fa = fa / __ldg(deg_p1 + row);
  const float coef = p.attract * fa / dist * m;
#pragma unroll
  for (int k = 0; k < D; ++k) o[k] = diff[k] * coef;
}

template <int D>
void launch(int n_edges, int ec, int blk, int b_max, const int* cs,
            const int* cr, const float* cw, const float* mask,
            const float* block, const float* x, const float* deg_p1,
            const FaParams& p, float* out, cudaStream_t stream) {
  const int grid = (n_edges + BLOCK - 1) / BLOCK;
  ring_slot_kernel<D><<<grid, BLOCK, 0, stream>>>(
      n_edges, ec, blk, b_max, cs, cr, cw, mask, block, x, deg_p1, p, out);
}

}  // namespace

// One ring slot: ``n_edges`` = shards * ec group entries (shard-major, ec
// per shard); ``block`` the slot's [shards, b_max, d] boundary rows; ``x``
// the stacked [shards * blk, d] coordinates; ``deg_p1`` [shards * blk].
// Returns cudaGetLastError() after the launch.  The caller guarantees
// n_edges > 0, 1 <= d <= 4 and every live cr < b_max.
extern "C" int ge_ring_attraction(int n_edges, int ec, int d, int blk,
                                  int b_max, const void* cs, const void* cr,
                                  const void* cw, const void* mask,
                                  const void* block, const void* x,
                                  const void* deg_p1, float attract,
                                  float eps, float delta, int linlog,
                                  int nohubs, int use_weights, void* out,
                                  void* stream) {
  const int* csi = static_cast<const int*>(cs);
  const int* cri = static_cast<const int*>(cr);
  const float* cwf = static_cast<const float*>(cw);
  const float* mf = static_cast<const float*>(mask);
  const float* bf = static_cast<const float*>(block);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(deg_p1);
  float* of = static_cast<float*>(out);
  const FaParams p{attract, eps, delta, linlog, nohubs, use_weights};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(n_edges, ec, blk, b_max, csi, cri, cwf, mf, bf, xf, df, p, of, s); break;
    case 2: launch<2>(n_edges, ec, blk, b_max, csi, cri, cwf, mf, bf, xf, df, p, of, s); break;
    case 3: launch<3>(n_edges, ec, blk, b_max, csi, cri, cwf, mf, bf, xf, df, p, of, s); break;
    case 4: launch<4>(n_edges, ec, blk, b_max, csi, cri, cwf, mf, bf, xf, df, p, of, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
