"""Carry state across from the JAX package as numpy arrays.

Every function takes plain numpy arrays (what ``Graph.to_coo_numpy()``,
``Partition.vertex_to_agg_numpy()`` and ``np.asarray`` give on the JAX
side) and returns the port's objects, so both packages can compute on the
same graph, hierarchy and state.  Nothing here imports JAX.
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
