"""Vertex reorderings for SpMV locality (host numpy and scipy).

Counterpart of graph_embed_tpu/graph/reorder.py:
* ``rcm_order``: reverse Cuthill-McKee, the bandwidth reducer for meshes
  and road networks;
* ``partition_order``: vertices sorted by their composed aggregate ids of
  the multilevel hierarchy (coarsest key first), which makes a
  community-bearing adjacency block-diagonal-dominant;
* ``apply_order``: relabel a graph by a permutation.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges


def rcm_order(g: Graph) -> np.ndarray:
    """perm[new_id] = old_id via reverse Cuthill-McKee."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s, r, w = g.to_coo_numpy()
    m = sp.csr_matrix((np.ones_like(w), (s, r)), shape=(g.n, g.n))
    return np.asarray(reverse_cuthill_mckee(m, symmetric_mode=True))


def partition_order(g: Graph, coarsening_factor: float = 0.1, *,
                    levels=None) -> np.ndarray:
    """perm[new_id] = old_id ordering vertices by the composed aggregate
    ids of the hierarchy (coarsest first key, finest last, then the id).

    ``levels`` reuses an existing hierarchy (list of Partition, fine to
    coarse) instead of partitioning ``g`` again."""
    from ..partition.interpolation import compose

    if levels is None:
        from ..partition.hierarchy import partition_hierarchy

        levels = partition_hierarchy(g, coarsening_factor).levels
    keys = []
    for upto in range(len(levels), 0, -1):
        keys.append(compose(levels, upto).vertex_to_agg_numpy())
    keys.append(np.arange(g.n))
    return np.lexsort(tuple(reversed(keys)))


def apply_order(g: Graph, perm: np.ndarray) -> tuple[Graph, np.ndarray]:
    """Relabel ``g`` so new vertex i is old perm[i], on ``g``'s device.
    Returns (reordered graph, inverse permutation old -> new)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    s, r, w = g.to_coo_numpy()
    return from_edges(inv[s], inv[r], w, n=g.n, dtype=g.dtype,
                      device=g.device), inv
