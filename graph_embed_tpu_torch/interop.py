"""Carry state across from the JAX package as numpy arrays.

Every function takes plain numpy arrays (what ``Graph.to_coo_numpy()``,
``Partition.vertex_to_agg_numpy()`` and ``np.asarray`` give on the JAX
side) and returns the port's objects, so both packages can compute on the
same graph, hierarchy and state.  Nothing here imports JAX.

The reference's tiled step keeps its state transposed and padded,
``[D_PAD, n_pad]`` with zeros beyond ``[:d, :n]``; the port's is row-major
``[n, d]``.  ``from_transposed`` and ``to_transposed`` carry it across.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph.csr import Graph, from_canonical_coo
from .partition.interpolation import Partition


def graph(s, r, w, n: int, *, dtype=torch.float32, device="cpu") -> Graph:
    """A graph from a canonical COO (sorted by (s, r), deduplicated)."""
    return from_canonical_coo(np.asarray(s), np.asarray(r), np.asarray(w),
                              int(n), dtype=dtype, device=device)


def partition(vertex_to_agg, num_aggs: int, *, device="cpu") -> Partition:
    return Partition.from_numpy(np.asarray(vertex_to_agg), int(num_aggs),
                                device=device)


def hierarchy(graph_coos, assignments, *, dtype=torch.float32,
              device="cpu") -> tuple[list[Graph], list[Partition]]:
    """([A_0 ... A_k], [P_0 ... P_{k-1}]) from ``graph_coos`` = [(s, r, w,
    n), ...] and ``assignments`` = [(vertex_to_agg, num_aggs), ...]."""
    graphs = [graph(*coo, dtype=dtype, device=device) for coo in graph_coos]
    parts = [partition(v2a, m, device=device) for v2a, m in assignments]
    return graphs, parts


def tensor(a, *, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Coordinates, radii or any other array as a tensor on ``device``."""
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


D_PAD = 8  # the reference's coordinate sublane pad (edge_spmm.py D_PAD)


def from_transposed(xT, n: int, d: int) -> np.ndarray:
    """[n, d] float32 rows from a transposed [D_PAD, n_pad] state."""
    return np.ascontiguousarray(np.asarray(xT)[:d, :n].T, dtype=np.float32)


def to_transposed(x, n_pad: int) -> np.ndarray:
    """The transposed [D_PAD, n_pad] float32 state of [n, d] rows, zero
    beyond them."""
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    if d > D_PAD or n > n_pad:
        raise ValueError(f"[{n}, {d}] does not fit [{D_PAD}, {n_pad}]")
    xT = np.zeros((D_PAD, n_pad), np.float32)
    xT[:d, :n] = x.T
    return xT
