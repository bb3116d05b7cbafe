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
// y = A x is a plain row-sorted CSR walk.  The host prep truncates weighted
// rows exactly as the packer does (ops/edge_spmm.py:truncate_bf16), so the
// row sums deg_w match the reference's tiled_row_sums.
//
// Bound on this card: bytes.  Per stored entry the kernel reads a 4-byte
// column index, a 4-byte weight (none in unit mode) and d*4 bytes of the
// gathered row of x; each row's output is written once.  Design: one
// thread owns one row and accumulates in float32 in CSR order, so there are
// no atomics and the result is bitwise deterministic run to run.  Rows of
// the refinement's slot space hold a handful of intra-aggregate entries,
// so neighbouring threads walk neighbouring stretches of col/w and the
// gathered x rows of one aggregate sit in one or two cache lines.  A row of
// more than LONG_ROW entries (the hubs of a power-law graph, up to ~4e4
// entries in rmat(20, 8)) would hold its warp for its whole length, one
// dependent gather after another; such rows are taken by the whole warp
// instead, one after another in lane order: lane l adds entries l, l + 32,
// ... in order, then a fixed xor-butterfly adds the 32 partial sums.  The
// order is fixed by the CSR alone, so the result stays deterministic.
// Later work: split the longest rows across warps, vectorised float4 state.
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
// precision and scatters the contributions back the same way.  Here rows
// are walked as in kernel A, with x[i] kept in registers.  Bound: bytes as
// for kernel A plus one sqrt, one log1p and one divide per entry.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int LONG_ROW = 32;
constexpr unsigned FULL = 0xffffffffu;

// kernel A's term: w_e * x[col_e] (w_e = 1 in unit mode)
template <int D, bool UNIT>
struct SpmvTerm {
  static constexpr bool kRowState = false;
  const int* col;
  const float* w;
  const float* x;

  __device__ __forceinline__ void add(const float (&)[D], int e,
                                      float (&acc)[D]) const {
    const float* xj = x + static_cast<size_t>(__ldg(col + e)) * D;
    if (UNIT) {
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] += __ldg(xj + k);
    } else {
      const float we = __ldg(w + e);
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = fmaf(we, __ldg(xj + k), acc[k]);
    }
  }
};

// kernel E's term: attract * c_e * log1p(d)/d * (x[col_e] - x[i])
template <int D>
struct LinlogTerm {
  static constexpr bool kRowState = true;
  const int* col;
  const float* w;
  const float* x;
  float attract;
  float eps;

  __device__ __forceinline__ void add(const float (&xi)[D], int e,
                                      float (&acc)[D]) const {
    const float* xj = x + static_cast<size_t>(__ldg(col + e)) * D;
    float diff[D];
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      diff[k] = __ldg(xj + k) - xi[k];
      d2 += diff[k] * diff[k];
    }
    const float dist = fmaxf(sqrtf(d2), eps);
    const float coef = attract * __ldg(w + e) * log1pf(dist) / dist;
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] += diff[k] * coef;
  }
};

// out[i] = sum of term over row i's entries.  Every lane of a warp runs to
// the end (no early exit): the long rows are shared through warp shuffles.
template <int D, class Term>
__global__ void __launch_bounds__(BLOCK)
row_sum_kernel(int n_rows, const int* __restrict__ indptr,
               const float* __restrict__ x, Term term,
               float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = row < n_rows;
  const int lo = active ? indptr[row] : 0;
  const int hi = active ? indptr[row + 1] : 0;
  const bool is_long = hi - lo > LONG_ROW;
  float xi[D], acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xi[k] = Term::kRowState && active ? x[static_cast<size_t>(row) * D + k]
                                      : 0.f;
    acc[k] = 0.f;
  }
  if (!is_long) {
    for (int e = lo; e < hi; ++e) term.add(xi, e, acc);
  }
  unsigned pending = __ballot_sync(FULL, is_long);
  while (pending) {
    const int src = __ffs(pending) - 1;
    pending &= pending - 1;
    const int rlo = __shfl_sync(FULL, lo, src);
    const int rhi = __shfl_sync(FULL, hi, src);
    float rx[D], part[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      rx[k] = __shfl_sync(FULL, xi[k], src);
      part[k] = 0.f;
    }
#pragma unroll 4
    for (int e = rlo + lane; e < rhi; e += 32) term.add(rx, e, part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < D; ++k)
        part[k] += __shfl_xor_sync(FULL, part[k], off);
    }
    if (lane == src) {
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] = part[k];
    }
  }
  if (!active) return;
  float* oi = out + static_cast<size_t>(row) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) oi[k] = acc[k];
}

template <int D, class Term>
void launch_rows(int n_rows, const int* indptr, const float* x,
                 const Term& term, float* out, cudaStream_t stream) {
  const int grid = (n_rows + BLOCK - 1) / BLOCK;
  row_sum_kernel<D, Term><<<grid, BLOCK, 0, stream>>>(n_rows, indptr, x,
                                                      term, out);
}

template <int D>
void launch(int n_rows, const int* indptr, const int* col, const float* w,
            const float* x, float* y, cudaStream_t stream) {
  if (w == nullptr) {
    launch_rows<D>(n_rows, indptr, x, SpmvTerm<D, true>{col, w, x}, y,
                   stream);
  } else {
    launch_rows<D>(n_rows, indptr, x, SpmvTerm<D, false>{col, w, x}, y,
                   stream);
  }
}

template <int D>
void launch_linlog(int n_rows, const int* indptr, const int* col,
                   const float* w, const float* x, float* out, float attract,
                   float eps, cudaStream_t stream) {
  launch_rows<D>(n_rows, indptr, x, LinlogTerm<D>{col, w, x, attract, eps},
                 out, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  ``w`` may be
// null (unit mode).  The caller guarantees n_rows > 0 and 1 <= d <= 4.
extern "C" int ge_edge_spmm(int n_rows, int d, const void* indptr,
                            const void* col, const void* w, const void* x,
                            void* y, void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const float* wf = static_cast<const float*>(w);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch<1>(n_rows, ip, c, wf, xf, yf, s); break;
    case 2: launch<2>(n_rows, ip, c, wf, xf, yf, s); break;
    case 3: launch<3>(n_rows, ip, c, wf, xf, yf, s); break;
    case 4: launch<4>(n_rows, ip, c, wf, xf, yf, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel E.  Returns cudaGetLastError() after the launch.  The caller
// guarantees n_rows > 0, 1 <= d <= 4 and a square CSR with weights.
extern "C" int ge_edge_linlog(int n_rows, int d, const void* indptr,
                              const void* col, const void* w, const void* x,
                              void* out, float attract, float eps,
                              void* stream) {
  const int* ip = static_cast<const int*>(indptr);
  const int* c = static_cast<const int*>(col);
  const float* wf = static_cast<const float*>(w);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: launch_linlog<1>(n_rows, ip, c, wf, xf, of, attract, eps, s); break;
    case 2: launch_linlog<2>(n_rows, ip, c, wf, xf, of, attract, eps, s); break;
    case 3: launch_linlog<3>(n_rows, ip, c, wf, xf, of, attract, eps, s); break;
    case 4: launch_linlog<4>(n_rows, ip, c, wf, xf, of, attract, eps, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
