// Kernel A: row-owned CSR SpMV over [n, d] float32 coordinates, d <= 4.
//
//   y[i, :] = sum_{e in row i} w_e * x[col_e, :]      (w_e = 1 in unit mode)
//
// Replaces the windowed Pallas SpMV of the JAX package,
// graph_embed_tpu/ops/pallas/edge_spmm.py:spmv_windowed (:1387), in its two
// on-path forms: _spmv_kernel_v12pk (:1247, unit weights) and
// _spmv_kernel_v8 (:1280, weights truncated toward zero to bf16 by the
// packer, :581).  The TPU kernels gather and scatter through one-hot MXU
// matmuls over (sender block, receiver window) slabs; on Hopper the same
// y = A x is a row-sorted CSR walk.  The host prep truncates weighted rows
// exactly as the packer does (ops/edge_spmm.py:truncate_bf16), so the row
// sums deg_w match the reference's tiled_row_sums.
//
// Bound on this card: bytes.  Per stored entry the kernel must read a
// 4-byte column index, a 4-byte weight (none in unit mode) and the d*4
// bytes of the gathered row of x; each row's output is written once.  What
// holds it above that bound is the gather: each entry's row of x is a
// random 12-byte read (d = 3), which moves at least one 32-byte sector
// from L2 and often two, and a thread-per-row walk that reads col[e], then
// x[col[e]], one dependent pair at a time keeps one gather in flight per
// thread and lets one warp walk a power-law hub of ~4e4 entries alone.
//
// Design:
// * A tile block owns TILE_ROWS consecutive rows, one thread each.  A row
//   of at most LONG_ROW entries is summed by its thread in CSR order
//   (acc += x in unit mode, fmaf(w, x, acc) weighted), SHORT_BATCH column
//   indices and then SHORT_BATCH gathers in flight before each batch's
//   adds.
// * A row of LONG_ROW + 1 .. HUB_ROW entries is summed by its warp, the
//   warp's such rows one after another: lane l adds entries l, l + 32, ...
//   of the row in order, LANE_BATCH gathers in flight per lane, then a fixed
//   xor butterfly adds the 32 partial sums.
// * A row of more than HUB_ROW entries (a hub) gets a block of its own,
//   from the CSR's ``hub_rows`` list built with it; hub blocks come first in
//   the grid, so the longest work starts first.  All its threads gather
//   CHUNK entries at a time (cut at offsets from the row's start, PER_THREAD
//   gathers in flight per thread) into the block's slice of a staging
//   buffer in global memory, which stays in L1/L2, and its first warp adds
//   them under the lane rule and butterfly above.  The buffer is global, not
//   shared, so tile blocks keep the whole L1 for their gathers.
// These are the rules of a thread-per-row walk with warp-shared long rows,
// so a row's sum is bitwise that walk's, and it depends on the row's own
// entries alone: not on where the row starts in the CSR, nor on its tile.
// No atomics; the result is deterministic.
//
// Two more modes of kernel A share the walk:
//
// * bf16x: replaces _spmv_kernel_v12pk(bf16_x=True) (:1247; gather :1187,
//   layout pack_gather_layout_bf16 :1167), the reference's opt-in
//   x_precision='bf16'.  x arrives as ceil(d/2) 32-bit words per row
//   (ops/edge_spmm.py:pack_x_bf16, rounded to nearest even on the host
//   side): coordinate 2p in the high half, 2p+1 in the low half.  Each
//   entry gathers those words (one 8-byte load at d = 3, 4),
//   hi = bits & 0xffff0000 and lo = bits << 16 as float32, summed in
//   float32 in CSR order; the reference's single scatter plane
//   (:1057-1080) likewise sums exact bf16 products in float32.  Unit
//   weights only.
// * null: the unit mode's launch and loads (indptr, col, gathered x) with
//   the sum discarded behind a run-time zero mask, so every load stays;
//   writes zeros.  Replaces the diagnostic _spmv_kernel_vnull (:992); its
//   time is kernel A's memory-stream floor.
//
// The weighted mode also serves the reference's 'wide' packing
// (_spmv_kernel_vw, :1335): exact float32 weights, counted apart by the
// wrapper.
//
// Kernel E (same file): linlog attraction over the same row-sorted CSR,
//
//   F[i, :] = sum_{e in row i} attract * c_e * log1p(d_e) / d_e * diff_e,
//   diff_e = x[col_e, :] - x[i, :],  d_e = max(|diff_e|, eps),
//
// with c_e the folded float32 weight (not truncated).  Replaces
// graph_embed_tpu/ops/pallas/edge_spmm.py:attraction_tiled (:240), body
// _attraction_kernel (:203), which gathers both endpoints of each
// (sender block, receiver block) tile through one-hot matmuls at HIGHEST
// precision and scatters the contributions back the same way.  Bound:
// bytes as for kernel A's weighted mode (plus x[i] once per row); per
// entry one sqrt, one log1p and one IEEE divide besides.  E walks the CSR
// as kernel A does, in functions of its own (linlog_*), so that kernel A's
// code stays as it was: tile blocks of TILE_ROWS rows, a thread per row of
// at most LONG_ROW entries with SHORT_BATCH gathers in flight, a warp per
// longer row under the lane rule with LANE_BATCH per lane, a block per hub
// row (the CSR's ``hub_rows``), hub blocks first.  x[i] is the row's own
// state: read by the row's thread, shuffled to its warp, read by every
// thread of a hub block.  A hub block's threads compute the factors of
// each term of a CHUNK (the d components of diff and coef, each by the
// expression of the other paths) and stage them, and warp 0 adds
// diff * coef with one FMA per component under the lane rule: the same
// rounding as the warp walk, whose acc += diff * coef is an FMA.  So a
// row's sum depends on its own entries alone, whatever its class, and is
// bitwise the sum of a thread-per-row walk with warp-shared long rows.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int LONG_ROW = 32;
constexpr unsigned FULL = 0xffffffffu;

// kernel A's walk
constexpr int TILE_ROWS = BLOCK;          // rows per tile block
constexpr int SHORT_BATCH = 4;            // a thread's gathers in flight
constexpr int LANE_BATCH = 2;             // a lane's gathers in flight
constexpr int CHUNK = 2048;               // a hub's entries staged per pass
constexpr int PER_THREAD = CHUNK / BLOCK;
constexpr int HUB_ROW = CHUNK;            // longer rows: a block each
static_assert(CHUNK % BLOCK == 0, "every thread stages PER_THREAD entries");

// Kernel A's sources of an entry: the gathered row of x and, in the
// weighted mode, the weight.  ``out`` is applied to each sum as it is
// written (the null mode's mask).
template <int D, bool WEIGHTED>
struct F32Rows {
  static constexpr bool kWeighted = WEIGHTED;
  const float* x;
  const float* w;
  int mask;

  __device__ __forceinline__ void gather(int c, float (&v)[D]) const {
    const float* xj = x + static_cast<size_t>(c) * D;
    if constexpr (D == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(xj));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[D - 1] = q.w;
    } else if constexpr (D == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(xj));
      v[0] = q.x;
      v[D - 1] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = __ldg(xj + k);
    }
  }

  __device__ __forceinline__ float weight(int e) const {
    return WEIGHTED ? __ldg(w + e) : 1.f;
  }

  __device__ __forceinline__ float out(float v) const {
    return __int_as_float(__float_as_int(v) & mask);
  }
};

// the bf16x mode's source: ceil(D/2) bf16-pair words per row of x
template <int D>
struct Bf16Rows {
  static constexpr bool kWeighted = false;
  static constexpr int D2 = (D + 1) / 2;
  const unsigned* xp;

  __device__ __forceinline__ void gather(int c, float (&v)[D]) const {
    const unsigned* wj = xp + static_cast<size_t>(c) * D2;
    unsigned words[D2];
    if constexpr (D2 == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(wj));
      words[0] = q.x;
      words[D2 - 1] = q.y;
    } else {
      words[0] = __ldg(wj);
    }
#pragma unroll
    for (int p = 0; p < D2; ++p) {
      v[2 * p] = __uint_as_float(words[p] & 0xffff0000u);
      if (2 * p + 1 < D) v[2 * p + 1] = __uint_as_float(words[p] << 16);
    }
  }

  __device__ __forceinline__ float weight(int) const { return 1.f; }
  __device__ __forceinline__ float out(float v) const { return v; }
};

// acc += w * v as the thread-per-row walk adds one entry
template <int D, bool WEIGHTED>
__device__ __forceinline__ void add_entry(float w, const float (&v)[D],
                                          float (&acc)[D]) {
  if (WEIGHTED) {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = fmaf(w, v[k], acc[k]);
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] += v[k];
  }
}

// acc += the entries first, first + step, ... < end, in that order, with
// up to BATCH column indices (and weights), then BATCH gathers, in flight
// before each batch's adds
template <int D, int BATCH, class Src>
__device__ __forceinline__ void walk(int first, int end, int step,
                                     const int* __restrict__ col,
                                     const Src& src, float (&acc)[D]) {
  for (int e = first; e < end; e += BATCH * step) {
    int c[BATCH];
    float w[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int ej = e + j * step;
      c[j] = ej < end ? __ldg(col + ej) : -1;
      w[j] = Src::kWeighted && ej < end ? src.weight(ej) : 0.f;
    }
    float v[BATCH][D];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (c[j] >= 0) src.gather(c[j], v[j]);
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (c[j] >= 0) add_entry<D, Src::kWeighted>(w[j], v[j], acc);
  }
}

// the fixed xor butterfly over a warp's 32 partial sums; every lane ends
// with the same sum (each step adds a pair of equal operands commuted)
template <int D>
__device__ __forceinline__ void butterfly(float (&part)[D]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < D; ++k) part[k] += __shfl_xor_sync(FULL, part[k], off);
  }
}

template <int D, class Src>
__device__ __forceinline__ void write_row(float* __restrict__ out, int row,
                                          const Src& src,
                                          const float (&acc)[D]) {
  float* oi = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) oi[k] = src.out(acc[k]);
}

// one hub row: all threads stage CHUNK entries at a time (cut at offsets
// from the row's start) into the block's slice of ``stage`` in global
// memory, which stays in L1/L2, and warp 0 adds them under the lane rule
template <int D, class Src>
__device__ void hub_block(int row, const int* __restrict__ indptr,
                          const int* __restrict__ col, const Src& src,
                          float* __restrict__ stage,
                          float* __restrict__ out) {
  const int lo = indptr[row], hi = indptr[row + 1];
  const int lane = threadIdx.x & 31;
  float part[D];
#pragma unroll
  for (int k = 0; k < D; ++k) part[k] = 0.f;
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, hi);
    int c[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int e = c0 + threadIdx.x + j * BLOCK;
      c[j] = e < c1 ? __ldg(col + e) : -1;
    }
    float v[PER_THREAD][D];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (c[j] >= 0) src.gather(c[j], v[j]);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (c[j] < 0) continue;
      float* sj = stage + (threadIdx.x + j * BLOCK) * D;
#pragma unroll
      for (int k = 0; k < D; ++k) sj[k] = v[j][k];
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int e = c0 + lane; e < c1; e += 32) {
        float x[D];
#pragma unroll
        for (int k = 0; k < D; ++k) x[k] = stage[(e - c0) * D + k];
        add_entry<D, Src::kWeighted>(src.weight(e), x, part);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    butterfly<D>(part);
    if (lane == 0) write_row<D, Src>(out, row, src, part);
  }
}

// rows [r0, r0 + TILE_ROWS) but the hubs: a row of at most LONG_ROW entries
// by its own thread, each longer one by the row's warp, in turn
template <int D, class Src>
__device__ void tile_block(int r0, int n_rows, const int* __restrict__ indptr,
                           const int* __restrict__ col, const Src& src,
                           float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + static_cast<int>(threadIdx.x);
  const bool active = row < n_rows;
  const int lo = active ? indptr[row] : 0;
  const int hi = active ? indptr[row + 1] : 0;
  if (hi - lo <= LONG_ROW) {
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.f;
    walk<D, SHORT_BATCH>(lo, hi, 1, col, src, acc);
    if (active) write_row<D, Src>(out, row, src, acc);
  }
  unsigned pending = __ballot_sync(FULL, hi - lo > LONG_ROW
                                             && hi - lo <= HUB_ROW);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    const int rlo = __shfl_sync(FULL, lo, owner);
    const int rhi = __shfl_sync(FULL, hi, owner);
    float part[D];
#pragma unroll
    for (int k = 0; k < D; ++k) part[k] = 0.f;
    walk<D, LANE_BATCH>(rlo + lane, rhi, 32, col, src, part);
    butterfly<D>(part);
    if (lane == 0) write_row<D, Src>(out, row - lane + owner, src, part);
  }
}

template <int D, class Src>
__global__ void __launch_bounds__(BLOCK)
spmv_kernel(int n_rows, const int* __restrict__ indptr,
            const int* __restrict__ col, Src src,
            const int* __restrict__ hub_rows, int n_hubs,
            float* __restrict__ stage, float* __restrict__ out) {
  const int b = static_cast<int>(blockIdx.x);
  if (b < n_hubs)
    hub_block<D, Src>(hub_rows[b], indptr, col, src,
                      stage + static_cast<size_t>(b) * CHUNK * D, out);
  else
    tile_block<D, Src>((b - n_hubs) * TILE_ROWS, n_rows, indptr, col, src,
                       out);
}

template <int D, class Src>
void launch_spmv(int n_rows, const int* indptr, const int* col,
                 const Src& src, const int* hub_rows, int n_hubs,
                 float* stage, float* out, cudaStream_t stream) {
  const int grid = n_hubs + (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  spmv_kernel<D, Src><<<grid, BLOCK, 0, stream>>>(
      n_rows, indptr, col, src, hub_rows, n_hubs, stage, out);
}

template <int D>
void launch(int n_rows, const int* indptr, const int* col, const float* w,
            const float* x, const int* hubs, int n_hubs, float* stage,
            float* y, cudaStream_t stream) {
  if (w == nullptr) {
    launch_spmv<D>(n_rows, indptr, col, F32Rows<D, false>{x, w, -1}, hubs,
                   n_hubs, stage, y, stream);
  } else {
    launch_spmv<D>(n_rows, indptr, col, F32Rows<D, true>{x, w, -1}, hubs,
                   n_hubs, stage, y, stream);
  }
}


// ---------------------------------------------------------------------------
// Kernel E on kernel A's walk

// kernel E's source of entries: the term attract * c_e * log1p(d)/d *
// (x[col_e] - x[i]) of each, x[i] the row's state; ``gather`` as kernel
// A's (kept apart so that kernel A's code compiles as it did), ``stage``
// and ``add_staged`` the term in two halves through a hub pass (kStage
// floats per entry)
template <int D>
struct LinlogRows {
  static constexpr int kStage = D + 1;      // diff, then coef
  const float* x;
  const float* w;
  float attract;
  float eps;

  __device__ __forceinline__ void gather(int c, float (&v)[D]) const {
    const float* xj = x + static_cast<size_t>(c) * D;
    if constexpr (D == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(xj));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[D - 1] = q.w;
    } else if constexpr (D == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(xj));
      v[0] = q.x;
      v[D - 1] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = __ldg(xj + k);
    }
  }

  __device__ __forceinline__ float weight(int e) const { return __ldg(w + e); }

  __device__ __forceinline__ void row_state(int row, float (&xi)[D]) const {
    gather(row, xi);
  }

  // the term's factors: diff = v - xi and its coefficient
  __device__ __forceinline__ float factors(float c, const float (&v)[D],
                                           const float (&xi)[D],
                                           float (&diff)[D]) const {
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      diff[k] = v[k] - xi[k];
      d2 += diff[k] * diff[k];
    }
    const float dist = fmaxf(sqrtf(d2), eps);
    return attract * c * log1pf(dist) / dist;
  }

  __device__ __forceinline__ void add(float c, const float (&v)[D],
                                      const float (&xi)[D],
                                      float (&acc)[D]) const {
    float diff[D];
    const float coef = factors(c, v, xi, diff);
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = fmaf(diff[k], coef, acc[k]);
  }

  __device__ __forceinline__ void stage(int e, const float (&v)[D],
                                        const float (&xi)[D],
                                        float* s) const {
    float diff[D];
    s[D] = factors(weight(e), v, xi, diff);
#pragma unroll
    for (int k = 0; k < D; ++k) s[k] = diff[k];
  }

  __device__ __forceinline__ void add_staged(int, const float* s,
                                             float (&acc)[D]) const {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = fmaf(s[k], s[D], acc[k]);
  }

  __device__ __forceinline__ float out(float v) const { return v; }
};

// acc += the terms of entries first, first + step, ... < end of the row at
// xi, in that order, with up to BATCH column indices and weights, then
// BATCH gathers, in flight before each batch's adds (kernel A's walk)
template <int D, int BATCH, class Src>
__device__ __forceinline__ void linlog_walk(int first, int end, int step,
                                            const int* __restrict__ col,
                                            const Src& src,
                                            const float (&xi)[D],
                                            float (&acc)[D]) {
  for (int e = first; e < end; e += BATCH * step) {
    int c[BATCH];
    float w[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int ej = e + j * step;
      c[j] = ej < end ? __ldg(col + ej) : -1;
      w[j] = ej < end ? src.weight(ej) : 0.f;
    }
    float v[BATCH][D];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (c[j] >= 0) src.gather(c[j], v[j]);
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (c[j] >= 0) src.add(w[j], v[j], xi, acc);
  }
}

// one hub row (kernel A's hub_block): all threads compute the factors of
// CHUNK terms at a time and stage them in the block's slice of ``stage``;
// warp 0 adds diff * coef under the lane rule
template <int D, class Src>
__device__ void linlog_hub_block(int row, const int* __restrict__ indptr,
                                 const int* __restrict__ col, const Src& src,
                                 float* __restrict__ stage,
                                 float* __restrict__ out) {
  const int lo = indptr[row], hi = indptr[row + 1];
  const int lane = threadIdx.x & 31;
  float xi[D], part[D];
#pragma unroll
  for (int k = 0; k < D; ++k) part[k] = 0.f;
  src.row_state(row, xi);
  for (int c0 = lo; c0 < hi; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, hi);
    int c[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int e = c0 + threadIdx.x + j * BLOCK;
      c[j] = e < c1 ? __ldg(col + e) : -1;
    }
    float v[PER_THREAD][D];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j)
      if (c[j] >= 0) src.gather(c[j], v[j]);
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      if (c[j] < 0) continue;
      const int at = threadIdx.x + j * BLOCK;
      src.stage(c0 + at, v[j], xi, stage + at * Src::kStage);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int e = c0 + lane; e < c1; e += 32)
        src.add_staged(e, stage + (e - c0) * Src::kStage, part);
    }
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    butterfly<D>(part);
    if (lane == 0) write_row<D, Src>(out, row, src, part);
  }
}

// rows [r0, r0 + TILE_ROWS) but the hubs (kernel A's tile_block): x[i] read
// by the row's thread, shuffled to its warp for a warp row
template <int D, class Src>
__device__ void linlog_tile_block(int r0, int n_rows,
                                  const int* __restrict__ indptr,
                                  const int* __restrict__ col, const Src& src,
                                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + static_cast<int>(threadIdx.x);
  const bool active = row < n_rows;
  const int lo = active ? indptr[row] : 0;
  const int hi = active ? indptr[row + 1] : 0;
  float xi[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xi[k] = 0.f;
  if (active) src.row_state(row, xi);
  if (hi - lo <= LONG_ROW) {
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.f;
    linlog_walk<D, SHORT_BATCH>(lo, hi, 1, col, src, xi, acc);
    if (active) write_row<D, Src>(out, row, src, acc);
  }
  unsigned pending = __ballot_sync(FULL, hi - lo > LONG_ROW
                                             && hi - lo <= HUB_ROW);
  while (pending) {
    const int owner = __ffs(pending) - 1;
    pending &= pending - 1;
    const int rlo = __shfl_sync(FULL, lo, owner);
    const int rhi = __shfl_sync(FULL, hi, owner);
    float rx[D], part[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      rx[k] = __shfl_sync(FULL, xi[k], owner);
      part[k] = 0.f;
    }
    linlog_walk<D, LANE_BATCH>(rlo + lane, rhi, 32, col, src, rx, part);
    butterfly<D>(part);
    if (lane == 0) write_row<D, Src>(out, row - lane + owner, src, part);
  }
}

template <int D>
__global__ void __launch_bounds__(BLOCK)
linlog_kernel(int n_rows, const int* __restrict__ indptr,
              const int* __restrict__ col, LinlogRows<D> src,
              const int* __restrict__ hub_rows, int n_hubs,
              float* __restrict__ stage, float* __restrict__ out) {
  const int b = static_cast<int>(blockIdx.x);
  if (b < n_hubs)
    linlog_hub_block<D>(hub_rows[b], indptr, col, src,
                        stage + static_cast<size_t>(b) * CHUNK * (D + 1),
                        out);
  else
    linlog_tile_block<D>((b - n_hubs) * TILE_ROWS, n_rows, indptr, col, src,
                         out);
}

template <int D>
void launch_linlog(int n_rows, const int* indptr, const int* col,
                   const float* w, const float* x, float attract, float eps,
                   const int* hubs, int n_hubs, float* stage, float* out,
                   cudaStream_t stream) {
  const int grid = n_hubs + (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  linlog_kernel<D><<<grid, BLOCK, 0, stream>>>(
      n_rows, indptr, col, LinlogRows<D>{x, w, attract, eps}, hubs, n_hubs,
      stage, out);
}

template <int D>
void launch_bf16x(int n_rows, const int* indptr, const int* col,
                  const unsigned* xp, const int* hubs, int n_hubs,
                  float* stage, float* y, cudaStream_t stream) {
  launch_spmv<D>(n_rows, indptr, col, Bf16Rows<D>{xp}, hubs, n_hubs, stage,
                 y, stream);
}

template <int D>
void launch_null(int n_rows, const int* indptr, const int* col,
                 const float* x, const int* hubs, int n_hubs, float* stage,
                 float* y, cudaStream_t stream) {
  launch_spmv<D>(n_rows, indptr, col, F32Rows<D, false>{x, nullptr, 0}, hubs,
                 n_hubs, stage, y, stream);
}

}  // namespace

// Rows of more than this many entries are hubs: the caller lists them in
// ``hub_rows`` (ops/edge_spmm.py:HUB_ROW must agree).
extern "C" int ge_spmv_hub_row() { return HUB_ROW; }

// Returns cudaGetLastError() after the launch (0 on success).  ``w`` may be
// null (unit mode).  ``hub_rows`` lists, ascending, the n_hubs rows of more
// than HUB_ROW entries (may be null when n_hubs == 0).  The caller
// guarantees n_rows > 0 and 1 <= d <= 4.
extern "C" int ge_edge_spmm(int n_rows, int d, const void* indptr,
                            const void* col, const void* w, const void* x,
                            void* y, const void* hub_rows, int n_hubs,
                            void* stage, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const float* wf = static_cast<const float*>(w);
  const float* xf = static_cast<const float*>(x);
  const int* hr = static_cast<const int*>(hub_rows);
  float* st = static_cast<float*>(stage);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(n_rows, ip, c, wf, xf, hr, n_hubs, st, yf, s); break;
    case 2: launch<2>(n_rows, ip, c, wf, xf, hr, n_hubs, st, yf, s); break;
    case 3: launch<3>(n_rows, ip, c, wf, xf, hr, n_hubs, st, yf, s); break;
    case 4: launch<4>(n_rows, ip, c, wf, xf, hr, n_hubs, st, yf, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel A's bf16x mode: ``xp`` holds ceil(d/2) bf16-pair words per row.
// Returns cudaGetLastError() after the launch.  The caller guarantees
// n_rows > 0, 1 <= d <= 4 and the hub list of ge_edge_spmm.
extern "C" int ge_edge_spmm_bf16x(int n_rows, int d, const void* indptr,
                                  const void* col, const void* xp, void* y,
                                  const void* hub_rows, int n_hubs,
                                  void* stage, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const unsigned* xw = static_cast<const unsigned*>(xp);
  const int* hr = static_cast<const int*>(hub_rows);
  float* st = static_cast<float*>(stage);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_bf16x<1>(n_rows, ip, c, xw, hr, n_hubs, st, yf, s); break;
    case 2: launch_bf16x<2>(n_rows, ip, c, xw, hr, n_hubs, st, yf, s); break;
    case 3: launch_bf16x<3>(n_rows, ip, c, xw, hr, n_hubs, st, yf, s); break;
    case 4: launch_bf16x<4>(n_rows, ip, c, xw, hr, n_hubs, st, yf, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel A's stream-only mode: the unit mode's loads, zeros written.
// Returns cudaGetLastError() after the launch.  The caller guarantees
// n_rows > 0, 1 <= d <= 4 and the hub list of ge_edge_spmm.
extern "C" int ge_edge_spmm_null(int n_rows, int d, const void* indptr,
                                 const void* col, const void* x, void* y,
                                 const void* hub_rows, int n_hubs,
                                 void* stage, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const float* xf = static_cast<const float*>(x);
  const int* hr = static_cast<const int*>(hub_rows);
  float* st = static_cast<float*>(stage);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_null<1>(n_rows, ip, c, xf, hr, n_hubs, st, yf, s); break;
    case 2: launch_null<2>(n_rows, ip, c, xf, hr, n_hubs, st, yf, s); break;
    case 3: launch_null<3>(n_rows, ip, c, xf, hr, n_hubs, st, yf, s); break;
    case 4: launch_null<4>(n_rows, ip, c, xf, hr, n_hubs, st, yf, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel E takes kernel A's hub list and stages d + 1 floats per entry of
// a hub pass (ops/edge_spmm.py sizes ``stage`` by this).
extern "C" int ge_linlog_stage_floats(int d) { return d + 1; }

// Kernel E.  Returns cudaGetLastError() after the launch.  The caller
// guarantees n_rows > 0, 1 <= d <= 4, a CSR with weights whose rows are
// the first n_rows rows of x (x holds at least n_rows rows), the hub list
// of ge_edge_spmm, and ``stage`` of n_hubs * CHUNK * (d + 1) floats.
extern "C" int ge_edge_linlog(int n_rows, int d, const void* indptr,
                              const void* col, const void* w, const void* x,
                              void* out, float attract, float eps,
                              const void* hub_rows, int n_hubs, void* stage,
                              void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const float* wf = static_cast<const float*>(w);
  const float* xf = static_cast<const float*>(x);
  const int* hr = static_cast<const int*>(hub_rows);
  float* st = static_cast<float*>(stage);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_linlog<1>(n_rows, ip, c, wf, xf, attract, eps, hr, n_hubs, st, of, s); break;
    case 2: launch_linlog<2>(n_rows, ip, c, wf, xf, attract, eps, hr, n_hubs, st, of, s); break;
    case 3: launch_linlog<3>(n_rows, ip, c, wf, xf, attract, eps, hr, n_hubs, st, of, s); break;
    case 4: launch_linlog<4>(n_rows, ip, c, wf, xf, attract, eps, hr, n_hubs, st, of, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
