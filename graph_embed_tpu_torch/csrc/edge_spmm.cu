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
// gathered x rows of one aggregate sit in one or two cache lines.
// Later work: a warp per row for long rows, vectorised float4 state.

#include <cuda_runtime.h>

namespace {

template <int D, bool UNIT>
__global__ void __launch_bounds__(256)
edge_spmm_kernel(int n_rows, const int* __restrict__ indptr,
                 const int* __restrict__ col, const float* __restrict__ w,
                 const float* __restrict__ x, float* __restrict__ y) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int lo = indptr[row];
  const int hi = indptr[row + 1];
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.f;
  for (int e = lo; e < hi; ++e) {
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
  float* yi = y + static_cast<size_t>(row) * D;
#pragma unroll
  for (int k = 0; k < D; ++k) yi[k] = acc[k];
}

template <int D>
void launch(int n_rows, const int* indptr, const int* col, const float* w,
            const float* x, float* y, cudaStream_t stream) {
  const int block = 256;
  const int grid = (n_rows + block - 1) / block;
  if (w == nullptr) {
    edge_spmm_kernel<D, true><<<grid, block, 0, stream>>>(n_rows, indptr, col,
                                                          w, x, y);
  } else {
    edge_spmm_kernel<D, false><<<grid, block, 0, stream>>>(n_rows, indptr,
                                                           col, w, x, y);
  }
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

extern "C" const char* ge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
