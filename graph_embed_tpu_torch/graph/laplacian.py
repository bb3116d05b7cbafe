"""Adjacency <-> Laplacian converters and the identity (src/matrixutils.cpp:
``identity`` :16, ``toLaplacian`` :31, ``fromLaplacian`` :72).

Counterpart of graph_embed_tpu/graph/laplacian.py: a COO relabel and
rebuild on the host; the result lands on the input graph's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import Graph, from_edges


def identity(n: int, *, dtype=torch.float32, device="cpu") -> Graph:
    """n x n identity (src/matrixutils.cpp:16)."""
    idx = np.arange(n, dtype=np.int64)
    return from_edges(idx, idx, np.ones(n), n=n, dtype=dtype, device=device)


def to_laplacian(g: Graph) -> Graph:
    """L = D - A with D_ii the full row sum of A incl. its diagonal and the
    off-diagonals negated (src/matrixutils.cpp:31-69)."""
    s, r, w = g.to_coo_numpy()
    rowsum = np.zeros(g.n, dtype=w.dtype)
    np.add.at(rowsum, s, w)
    idx = np.arange(g.n, dtype=np.int64)
    off = s != r
    ss = np.concatenate([s[off], idx])
    rr = np.concatenate([r[off], idx])
    ww = np.concatenate([-w[off], rowsum])
    return from_edges(ss, rr, ww, n=g.n, dtype=g.dtype, device=g.device)


def from_laplacian(lap: Graph) -> Graph:
    """Drop the diagonal and negate the off-diagonals
    (src/matrixutils.cpp:72-99)."""
    s, r, w = lap.to_coo_numpy()
    off = s != r
    return from_edges(s[off], r[off], -w[off], n=lap.n, dtype=lap.dtype,
                      device=lap.device)
