"""Sparse-matrix algebra surface: the linalgcpp operations the reference
consumes (``Transpose``, embed.cpp:605; ``Mult``, examples/embed.cpp:97;
``ScaleRows``/``ScaleCols``, embedder.cpp:176-177) and a mat-vec.

Counterpart of graph_embed_tpu/graph/algebra.py.  The rebuilds run on the
host and land on the input graph's device; ``matvec`` runs on the graph's
device through kernel A's exact mode (its plain version on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import edge_spmm as ES
from .csr import Graph, from_edges


def transpose(g: Graph) -> Graph:
    """A^T (swaps the COO axes)."""
    s, r, w = g.to_coo_numpy()
    return from_edges(r, s, w, n=g.n, dtype=g.dtype, device=g.device)


def matmul(a: Graph, b: Graph) -> Graph:
    """General sparse-sparse product A @ B (host, scipy CSR; the
    aggregation triple product has its own path, ops.spgemm)."""
    import scipy.sparse as sp

    sa, ra, wa = a.to_coo_numpy()
    sb, rb, wb = b.to_coo_numpy()
    A = sp.csr_matrix((wa, (sa, ra)), shape=(a.n, a.n))
    B = sp.csr_matrix((wb, (sb, rb)), shape=(b.n, b.n))
    C = (A @ B).tocoo()
    return from_edges(C.row, C.col, C.data, n=a.n, dtype=a.dtype,
                      device=a.device)


def scale_rows(g: Graph, v) -> Graph:
    """diag(v) @ A (linalgcpp ScaleRows)."""
    s, r, w = g.to_coo_numpy()
    v = np.asarray(v)
    return from_edges(s, r, w * v[s], n=g.n, dtype=g.dtype, device=g.device)


def scale_cols(g: Graph, v) -> Graph:
    """A @ diag(v) (linalgcpp ScaleCols)."""
    s, r, w = g.to_coo_numpy()
    v = np.asarray(v)
    return from_edges(s, r, w * v[r], n=g.n, dtype=g.dtype, device=g.device)


def matvec(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """y = A x for [n] or [n, d] x on the graph's device: kernel A's exact
    mode (the graph's float32 weights as stored) on the card, four columns
    per launch; its plain version on the CPU."""
    csr = ES.EdgeCSR(indptr=g.indptr.to(torch.int32),
                     col=g.receivers.to(torch.int32), w=g.weights,
                     n_rows=g.n, n_cols=g.n, exact=True)
    x = x.to(g.device)
    xs = x[:, None] if x.dim() == 1 else x
    y = torch.cat([ES.spmv(xs[:, c:c + 4].contiguous(), csr)
                   for c in range(0, xs.shape[1], 4)], dim=1)
    return y[:, 0] if x.dim() == 1 else y
