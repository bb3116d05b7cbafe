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
// Bound on this card: bytes.  Per live edge the kernel reads cs, cr and,
// with use_weights, cw (12 bytes), and gathers the two endpoint rows (4 * d
// bytes each) and, under nohubs, the sender's degree (4 bytes); per group
// it reads the live count; it writes 4 * d bytes for every entry, padding
// included.  At d = 3 a live edge moves 48 bytes against about 20
// operations, far below the card's ~20 operations per byte, so the time is
// bytes over 3.35 TB/s.  What takes most of it is the endpoint gathers:
// random 12-byte rows, each at least one 32-byte sector, in DRAM pages that
// are not reused.
// Design (one thread per entry; 2 or 4 consecutive entries per thread ran
// slower, as did 128-thread blocks):
// * the live entries of a group are a prefix with mask 1 (the plan pads
//   each group's tail; ring_groups checks both), and the kernel takes each
//   group's live count: an entry past it is written as zero with nothing
//   read (the empty slot 0 is a store pass), and a live entry reads cs, cr
//   and cw; no mask is read;
// * both endpoint rows are gathered whatever the entry (a ghost sender
//   reads row 0 of its shard, and its result is replaced by zero), so no
//   branch stands between an entry's group loads and its gathers;
// * the group arrays and the output, each touched once, go through the
//   cache-streaming path (ld.cs, st.cs), so that they displace less of the
//   gathered rows from the 50 MB L2;
// * grid y is the shard, so a thread finds its group without a division.
// Each entry's arithmetic is the parent's one-thread-per-entry expression
// (its factor mask, 1 on a live entry, dropped), so no bit changes.  No
// atomics: the sum per sender runs after, in a fixed order.

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
ring_slot_kernel(int ec, int blk, int b_max, const int* __restrict__ live,
                 const int* __restrict__ cs, const int* __restrict__ cr,
                 const float* __restrict__ cw,
                 const float* __restrict__ block,
                 const float* __restrict__ x,
                 const float* __restrict__ deg_p1, FaParams p,
                 float* __restrict__ out) {
  const int shard = blockIdx.y;
  const int e = blockIdx.x * BLOCK + threadIdx.x;
  if (e >= ec) return;
  const size_t g = static_cast<size_t>(shard) * ec + e;
  float* o = out + g * D;
  if (e >= __ldg(live + shard)) {
#pragma unroll
    for (int k = 0; k < D; ++k) __stcs(o + k, 0.f);
    return;
  }
  const int s = __ldcs(cs + g);
  const int r = __ldcs(cr + g);
  const float a = p.use_weights ? __ldcs(cw + g) : 1.f;
  const bool on = s < blk;
  const size_t row = static_cast<size_t>(shard) * blk + (on ? s : 0);
  const float* xs = x + row * D;
  const float* xr =
      block + (static_cast<size_t>(shard) * b_max + (on ? r : 0)) * D;
  float vs[D], vr[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    vr[k] = __ldg(xr + k);
    vs[k] = __ldg(xs + k);
  }
  const float dg = p.nohubs ? __ldg(deg_p1 + row) : 1.f;
  float diff[D];
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    diff[k] = vr[k] - vs[k];
    d2 += diff[k] * diff[k];
  }
  const float dist = fmaxf(sqrtf(d2), p.eps);
  float fa = p.linlog ? log1pf(dist) : dist;
  if (p.delta == 1.f) {
    fa = fa * a;
  } else if (p.delta != 0.f) {
    const float sign = static_cast<float>((a > 0.f) - (a < 0.f));
    fa = sign * powf(fabsf(a), p.delta) * fa;
  }
  if (p.nohubs) fa = fa / dg;
  const float coef = p.attract * fa / dist;
#pragma unroll
  for (int k = 0; k < D; ++k) __stcs(o + k, on ? diff[k] * coef : 0.f);
}

template <int D>
void launch(int ndev, int ec, int blk, int b_max, const int* live,
            const int* cs, const int* cr, const float* cw, const float* block,
            const float* x, const float* deg_p1, const FaParams& p,
            float* out, cudaStream_t stream) {
  const dim3 grid((ec + BLOCK - 1) / BLOCK, ndev);
  ring_slot_kernel<D><<<grid, BLOCK, 0, stream>>>(
      ec, blk, b_max, live, cs, cr, cw, block, x, deg_p1, p, out);
}

}  // namespace

// One ring slot: ``ndev`` groups of ``ec`` entries (shard-major);
// ``live`` the [ndev] live counts of the groups (the entries before a
// group's count have mask 1, those past it are padding: zeros, not read);
// ``block`` the slot's [ndev, b_max, d] boundary rows; ``x`` the stacked
// [ndev * blk, d] coordinates; ``deg_p1`` [ndev * blk].  Returns
// cudaGetLastError() after the launch.  The caller guarantees ndev > 0,
// ec > 0, ndev * ec < 2^31, 1 <= d <= 4, every count in [0, ec] and every
// live cr < b_max.
extern "C" int ge_ring_attraction(int ndev, int ec, int d, int blk,
                                  int b_max, const void* live, const void* cs,
                                  const void* cr, const void* cw,
                                  const void* block,
                                  const void* x, const void* deg_p1,
                                  float attract, float eps, float delta,
                                  int linlog, int nohubs, int use_weights,
                                  void* out, void* stream) {
  const int* lv = static_cast<const int*>(live);
  const int* csi = static_cast<const int*>(cs);
  const int* cri = static_cast<const int*>(cr);
  const float* cwf = static_cast<const float*>(cw);
  const float* bf = static_cast<const float*>(block);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(deg_p1);
  float* of = static_cast<float*>(out);
  const FaParams p{attract, eps, delta, linlog, nohubs, use_weights};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(ndev, ec, blk, b_max, lv, csi, cri, cwf, bf, xf, df, p, of, s); break;
    case 2: launch<2>(ndev, ec, blk, b_max, lv, csi, cri, cwf, bf, xf, df, p, of, s); break;
    case 3: launch<3>(ndev, ec, blk, b_max, lv, csi, cri, cwf, bf, xf, df, p, of, s); break;
    case 4: launch<4>(ndev, ec, blk, b_max, lv, csi, cri, cwf, bf, xf, df, p, of, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Marks the entry point that takes the groups' live counts.
extern "C" int ge_ring_live_counts() { return 1; }
