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
// launch covers every exact bucket of a level.
//
// Bound on this card: the pair arithmetic.  A member pair costs ~30
// instructions (the diff-form d^2, an IEEE sqrt and an IEEE divide, which
// keep each slot's sum exactly the float32 one its order gives) against
// ~28 bytes per slot moved once, so issue, not memory, limits it wherever
// aggregates hold more than a few members.  A slot's partners are summed
// in order by one thread, so the time follows the warp's partner loops:
// the design keeps every lane of a warp on a member row of (nearly) the
// same partner count.
//
// Design.  Members come first in each aggregate and ghosts after
// (multilevel_tiled.py's layout), so a ghost partner (w_j = 0) would add
// fmaf(+0, diff, acc), which leaves acc as it is, and a ghost row would
// write repel * 0 * acc, a zero: the kernel runs members against members
// only, in ascending partner order with the self pair kept as a zero
// term, and writes 0 to ghost rows.  Every slot's sum is then bitwise the
// one a kernel over all S slots of the aggregate gives.
// The work is cut into warp tasks, one int4 row each of a table built on
// the host (multilevel_tiled.py:_task_table); column 1 holds the class:
// * rows, S <= 32 (x: position in ``aggs``, y: S, z: first row of that
//   aggregate, w: rows, <= 32): 32 member rows, one per lane, of
//   consecutive aggregates of ``aggs`` (int2: first slot, member count),
//   which lists each small class's aggregates of two or more members by
//   member count, largest first, so a warp's lanes loop (nearly) alike.
//   The warp stages its rows and the rest of the two aggregates it cuts
//   into its slice of shared memory, then each lane reads its partners
//   there.
// * zeros, S <= 32 (x: first slot, y: -S, z: slots, w: a 32-bit mask):
//   writes 0 to the masked slots of 32 (ghosts, one-member aggregates).
// * S >= 64 (x: the aggregate's first slot, y: S, z: first row, w: the
//   member count c): a warp takes 32 rows of one aggregate, one per lane,
//   and stages the c partners 32 at a time (one coalesced load per lane),
//   each read by every lane as a broadcast; rows past c write 0.
// No block barrier anywhere (__syncwarp between a warp's stages).  A
// resident grid walks the table, warp w taking rows w, w + W, ...; the
// host orders the table by partner count, largest first, so the longest
// tasks start first.  The result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int WARP_SLOTS = 32;   // rows (or slots) of a task
constexpr int STAGE = 96;        // staged partners: 31 before, 32, 33 after
constexpr int AHEAD = 32;        // stage index of a rows task's first row
constexpr unsigned FULL = 0xffffffffu;

// acc += the term of partner (pj, wj) for a slot at xi, the self pair a
// zero term: the diff-form d^2, IEEE sqrt and divide
template <int D>
__device__ __forceinline__ void pair_term(const float (&xi)[D],
                                          const float (&pj)[D], float wj,
                                          bool self, float eps,
                                          float (&acc)[D]) {
  float diff[D];
  float d2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    diff[k] = xi[k] - pj[k];
    d2 = fmaf(diff[k], diff[k], d2);
  }
  const float dist = fmaxf(sqrtf(d2), eps);
  const float W = self ? 0.f : wj / (dist * dist * dist);
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = fmaf(W, diff[k], acc[k]);
}

// a warp's staging slice: D coordinate rows and the weights, STAGE each
template <int D>
struct Stage {
  float (*s)[STAGE];   // [D + 1][STAGE]

  __device__ __forceinline__ void put(int at, const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      int slot) const {
    const float* xs = x + static_cast<size_t>(slot) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) s[k][at] = __ldg(xs + k);
    s[D][at] = __ldg(w + slot);
  }

  __device__ __forceinline__ void get(int at, float (&p)[D],
                                      float& wj) const {
#pragma unroll
    for (int k = 0; k < D; ++k) p[k] = s[k][at];
    wj = s[D][at];
  }
};

template <int D>
__device__ __forceinline__ void write_slot(float* __restrict__ out, int slot,
                                           float sc, const float (&acc)[D],
                                           bool member) {
  float* os = out + static_cast<size_t>(slot) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) os[k] = member ? sc * acc[k] : 0.f;
}

// S <= 32, rows: lane l takes packed row l of the task; the aggregates it
// cuts are aggs[p], aggs[p + 1], ..., the first from row r0
template <int D>
__device__ void rows_task(int4 m, const int2* __restrict__ aggs, int n_aggs,
                          const float* __restrict__ x,
                          const float* __restrict__ w,
                          float* __restrict__ out, float repel, float eps,
                          const Stage<D>& st) {
  const int lane = threadIdx.x & 31;
  const int p = m.x, r0 = m.z, nrows = m.w;
  // lane k holds aggregate p + k: its rows in this task start at row
  // ``start`` (an inclusive scan of the rows each one has here)
  int2 ag = make_int2(0, 0);
  if (p + lane < n_aggs) ag = __ldg(aggs + p + lane);
  const int first = lane == 0 ? r0 : 0;
  const int avail = max(ag.y - first, 0);
  int incl = avail;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  const int start = incl - avail;
  const bool cut = avail > 0 && start < nrows;
  const unsigned starts = __reduce_or_sync(FULL, cut ? 1u << start : 0u);
  // this lane's aggregate k, its first slot, count and first row here
  const int k = __popc(starts & ((2u << lane) - 1u)) - 1;
  const int a0 = __shfl_sync(FULL, ag.x, k);
  const int c = __shfl_sync(FULL, ag.y, k);
  const int k_start = __shfl_sync(FULL, start, k);
  const int r = lane - k_start + (k == 0 ? r0 : 0);
  const int base = AHEAD + k_start - (k == 0 ? r0 : 0);  // member 0's index
  // the last aggregate cut, and its members past the task's rows
  const int last = __popc(starts) - 1;
  const int l_a0 = __shfl_sync(FULL, ag.x, last);
  const int l_c = __shfl_sync(FULL, ag.y, last);
  const int l_start = __shfl_sync(FULL, start, last);
  const int l_next = (last == 0 ? r0 : 0) + nrows - l_start;
  const int a0_first = __shfl_sync(FULL, ag.x, 0);
  const bool row = lane < nrows;
  __syncwarp();
  if (row) st.put(AHEAD + lane, x, w, a0 + r);
  if (lane < r0) st.put(AHEAD - r0 + lane, x, w, a0_first + lane);
  if (lane < l_c - l_next) st.put(AHEAD + nrows + lane, x, w,
                                  l_a0 + l_next + lane);
  __syncwarp();
  if (row) {
    float xi[D], pj[D], acc[D];
    float wi, wj;
    st.get(AHEAD + lane, xi, wi);
#pragma unroll
    for (int q = 0; q < D; ++q) acc[q] = 0.f;
    for (int j = 0; j < c; ++j) {
      st.get(base + j, pj, wj);
      pair_term<D>(xi, pj, wj, j == r, eps, acc);
    }
    write_slot<D>(out, a0 + r, repel * wi, acc, true);
  }
}

// S <= 32, zeros: the masked slots of the 32 from m.x
template <int D>
__device__ void zeros_task(int4 m, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (lane < m.z && (static_cast<unsigned>(m.w) >> lane & 1u)) {
    const float acc[D] = {};
    write_slot<D>(out, m.x + lane, 0.f, acc, false);
  }
}

// S >= 64: rows m.z + lane of the aggregate at m.x, its m.w members first;
// partners staged 32 at a time
template <int D>
__device__ void large_task(int4 m, const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, float repel, float eps,
                           const Stage<D>& st) {
  const int lane = threadIdx.x & 31;
  const int row = m.z + lane;
  const int c = m.w;
  const bool live = row < m.y;
  const bool member = row < c;
  const int slot = m.x + row;
  float xi[D], pj[D], acc[D];
  float wi = 0.f, wj;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xi[k] = 0.f;
    acc[k] = 0.f;
  }
  if (member) {
    const float* xs = x + static_cast<size_t>(slot) * D;
#pragma unroll
    for (int k = 0; k < D; ++k) xi[k] = __ldg(xs + k);
    wi = __ldg(w + slot);
  }
  // rows past the members only write zeros; a task with no member row
  // stages nothing
  for (int j0 = 0; j0 < c && m.z < c; j0 += 32) {
    const int n = min(32, c - j0);
    __syncwarp();
    if (lane < n) st.put(lane, x, w, m.x + j0 + lane);
    __syncwarp();
    if (member) {
      for (int jj = 0; jj < n; ++jj) {
        st.get(jj, pj, wj);
        pair_term<D>(xi, pj, wj, j0 + jj == row, eps, acc);
      }
    }
  }
  if (live) write_slot<D>(out, slot, repel * wi, acc, member);
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
bucket_repulsion_kernel(int num_tasks, const int4* __restrict__ tasks,
                        const int2* __restrict__ aggs, int n_aggs,
                        const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        float repel, float eps) {
  __shared__ float stage[WARPS][D + 1][STAGE];
  const int warp = threadIdx.x >> 5;
  const Stage<D> st{stage[warp]};
  for (int t = blockIdx.x * WARPS + warp; t < num_tasks;
       t += gridDim.x * WARPS) {
    const int4 m = __ldg(tasks + t);
    if (m.y < 0)
      zeros_task<D>(m, out);
    else if (m.y <= WARP_SLOTS)
      rows_task<D>(m, aggs, n_aggs, x, w, out, repel, eps, st);
    else
      large_task<D>(m, x, w, out, repel, eps, st);
  }
}

template <int D>
void launch(int num_tasks, const int4* tasks, const int2* aggs, int n_aggs,
            const float* x, const float* w, float* out, float repel,
            float eps, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bucket_repulsion_kernel<D>, BLOCK, 0);
  const int needed = (num_tasks + WARPS - 1) / WARPS;
  const int grid = max(1, min(needed, sms * max(per_sm, 1)));
  bucket_repulsion_kernel<D><<<grid, BLOCK, 0, stream>>>(
      num_tasks, tasks, aggs, n_aggs, x, w, out, repel, eps);
}

}  // namespace

// Rows (slots) of a task; the host's table is cut in these steps.
extern "C" int ge_bucket_tile() { return WARP_SLOTS; }

// One launch over the ``num_tasks`` rows of ``tasks`` (int4, see the
// design note) with the ``n_aggs`` aggregates of ``aggs`` (int2; may be
// null when n_aggs == 0).  x/out: [n_slots, d] float32, w: [n_slots]
// float32.  Returns cudaGetLastError() after the launch.  The caller
// guarantees num_tasks > 0, 1 <= d <= 4, every S a power of two >= 8,
// 16-byte aligned tasks and 8-byte aligned aggs.
extern "C" int ge_bucket_repulsion(int num_tasks, int d, const void* tasks,
                                   const void* aggs, int n_aggs,
                                   const void* x, const void* w, void* out,
                                   float repel, float eps, void* stream) {
  const int4* tk = static_cast<const int4*>(tasks);
  const int2* ag = static_cast<const int2*>(aggs);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(num_tasks, tk, ag, n_aggs, xf, wf, of, repel, eps, s); break;
    case 2: launch<2>(num_tasks, tk, ag, n_aggs, xf, wf, of, repel, eps, s); break;
    case 3: launch<3>(num_tasks, tk, ag, n_aggs, xf, wf, of, repel, eps, s); break;
    case 4: launch<4>(num_tasks, tk, ag, n_aggs, xf, wf, of, repel, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
