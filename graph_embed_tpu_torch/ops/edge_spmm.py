"""Attraction over a row-sorted CSR: kernel A (the SpMV) and kernel E
(linlog attraction), both in ``csrc/edge_spmm.cu``.

Counterpart of graph_embed_tpu/ops/pallas/edge_spmm.py.  The TPU packs
edges into (sender block, receiver window) slabs of one-hot matmuls over a
transposed [8, n_pad] coordinate state; here ``y = A x`` is a CSR walk over
row-major [n, d] coordinates.  What stays from the reference is the host
prep that fixes the arithmetic: weighted rows carry weights truncated
toward zero to bf16 (the packer's ``wbits & -65536``, edge_spmm.py:581) and
row sums are taken from those same weights (tiled_row_sums, :1581-1600).

Kernel E is the linlog attraction of edge_spmm.py:attraction_tiled
(:240, body ``_attraction_kernel`` :203): per stored entry the distance,
``attract * c_e * log1p(d)/d * (x_col - x_row)``, summed per row with the
folded float32 weights as ``build_edge_tiles`` keeps them (not truncated).

``spmv`` and ``linlog`` launch their kernels on a CUDA tensor and run the
plain PyTorch versions on a CPU tensor; there is no fallback between the
two.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cuda


@dataclasses.dataclass(frozen=True)
class EdgeCSR:
    """Row-sorted CSR of an [n_rows, n_cols] matrix on one device.

    indptr: [n_rows+1] int32; col: [nnz] int32; w: [nnz] float32, or None
    when every stored weight is exactly 1 (kernel A's unit mode)."""

    indptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor | None
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def device(self) -> torch.device:
        return self.col.device


def truncate_bf16(w) -> np.ndarray:
    """float32 weights truncated toward zero to bf16 precision (the low 16
    bits cleared), exactly as the reference packer stores them.  Rounding
    to nearest (``tensor.to(torch.bfloat16)``) would disagree with it."""
    wb = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
    return (wb.view(np.int32) & np.int32(-65536)).view(np.float32)


def build_csr(rows, cols, w, n_rows: int, n_cols: int | None = None, *,
              device="cpu") -> tuple[EdgeCSR, torch.Tensor]:
    """Host CSR build from a COO; returns (csr, row sums).

    ``w=None`` builds the unit-weight CSR.  Entries keep their input order
    within a row (a stable sort by row), which fixes the kernel's summation
    order.  The row sums are float64 sums of the float32 weights cast to
    float32, as ``tiled_row_sums`` computes them."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    n_cols = n_rows if n_cols is None else n_cols
    if rows.size >= 1 << 31 or max(n_rows, n_cols) >= 1 << 31:
        raise ValueError("kernel A indexes with int32")
    if rows.size and np.any(rows[1:] < rows[:-1]):
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
        if w is not None:
            w = np.asarray(w)[order]
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(counts)
    if w is None:
        wt = None
        deg = counts.astype(np.float32)
    else:
        w32 = np.ascontiguousarray(np.asarray(w, dtype=np.float32))
        wt = torch.from_numpy(w32).to(device)
        deg = np.bincount(rows, weights=w32.astype(np.float64),
                          minlength=n_rows).astype(np.float32)
    csr = EdgeCSR(indptr=torch.from_numpy(indptr).to(device),
                  col=torch.from_numpy(cols.astype(np.int32)).to(device),
                  w=wt, n_rows=int(n_rows), n_cols=int(n_cols))
    return csr, torch.from_numpy(deg).to(device)


def _rows(csr: EdgeCSR) -> torch.Tensor:
    """[nnz] row id of every stored entry."""
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.device), counts)


def spmv_plain(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Plain PyTorch version of kernel A: y[i] = sum_e w_e x[col_e]."""
    rows = _rows(csr)
    vals = x[csr.col.long()]
    if csr.w is not None:
        vals = vals * csr.w[:, None]
    y = torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals)


def spmv_cuda(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """Kernel A on the card: y = A x for float32 [n_cols, d <= 4] x."""
    _check_coords(x, csr, "kernel A")
    y = torch.empty((csr.n_rows, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    if csr.n_rows == 0:
        return y
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_edge_spmm(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(),
            csr.col.data_ptr(), None if csr.w is None else csr.w.data_ptr(),
            x.data_ptr(), y.data_ptr(), cuda.stream_of(x))
    cuda.check(rc, "edge_spmm")
    cuda.LAUNCHES["edge_spmm[unit]" if csr.w is None
                  else "edge_spmm[weighted]"] += 1
    return y


def spmv(x: torch.Tensor, csr: EdgeCSR) -> torch.Tensor:
    """y = A x: kernel A for a CUDA tensor, the plain version for a CPU
    tensor."""
    if x.is_cuda:
        return spmv_cuda(x, csr)
    if x.device.type != "cpu":
        raise ValueError(f"spmv runs on CUDA or the CPU, not {x.device}")
    return spmv_plain(x, csr)


def attraction_spmv(x: torch.Tensor, csr: EdgeCSR, deg_w: torch.Tensor, *,
                    attract: float = 1.0) -> torch.Tensor:
    """Plain-FA attraction through the SpMV (edge_spmm.py:1603-1611):
    F_att = attract * (A x - x * deg_w)."""
    return attract * (spmv(x, csr) - x * deg_w[:, None])


def _check_coords(x: torch.Tensor, csr: EdgeCSR, name: str) -> None:
    if not x.is_cuda or csr.device != x.device:
        raise ValueError(f"{name} needs x and the CSR on one CUDA device")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous float32 coordinates")
    if x.dim() != 2 or x.shape[0] != csr.n_cols or not 1 <= x.shape[1] <= 4:
        raise ValueError(f"{name} takes [{csr.n_cols}, d<=4] coordinates, "
                         f"got {tuple(x.shape)}")


def linlog_plain(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
                 eps: float, absolute: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel E: F[i] = sum_e attract * c_e *
    log1p(d_e)/d_e * (x[col_e] - x[i]), d_e = max(|x[col_e] - x[i]|, eps).
    ``absolute`` sums the terms' magnitudes instead: the scale of each
    element's float32 rounding, against which kernel E is held."""
    if csr.w is None:
        raise ValueError("linlog attraction needs the folded weights")
    rows = _rows(csr)
    diff = x[csr.col.long()] - x[rows]
    dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=1)), min=eps)
    per_edge = diff * (attract * csr.w * torch.log1p(dist) / dist)[:, None]
    if absolute:
        per_edge = per_edge.abs()
    out = torch.zeros((csr.n_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, rows, per_edge)


def linlog_cuda(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
                eps: float) -> torch.Tensor:
    """Kernel E on the card: linlog attraction for float32 [n, d <= 4]
    coordinates over a square CSR with float32 weights."""
    _check_coords(x, csr, "kernel E")
    if csr.w is None or csr.n_rows != csr.n_cols:
        raise ValueError("kernel E takes a square CSR with weights")
    out = torch.empty_like(x)
    if csr.n_rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_edge_linlog(
            csr.n_rows, x.shape[1], csr.indptr.data_ptr(), csr.col.data_ptr(),
            csr.w.data_ptr(), x.data_ptr(), out.data_ptr(), float(attract),
            float(eps), cuda.stream_of(x))
    cuda.check(rc, "edge_linlog")
    cuda.LAUNCHES["edge_linlog"] += 1
    return out


def linlog(x: torch.Tensor, csr: EdgeCSR, *, attract: float,
           eps: float) -> torch.Tensor:
    """Linlog attraction: kernel E for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.is_cuda:
        return linlog_cuda(x, csr, attract=attract, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"linlog runs on CUDA or the CPU, not {x.device}")
    return linlog_plain(x, csr, attract=attract, eps=eps)
