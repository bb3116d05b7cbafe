"""Connected components and degree-outlier filtering: the embedder
pipeline's ``largestComponent`` (examples/embedder.cpp:35-93) and
``removeLargest`` (:95-114).

Counterpart of graph_embed_tpu/graph/components.py.  The reference's DFS
becomes min-label propagation with pointer jumping on the graph's device;
the JAX ``while_loop`` becomes a host loop on a changed flag.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import Graph, submatrix


def component_labels(g: Graph) -> np.ndarray:
    """[n] int32 component id per vertex: the smallest vertex id in its
    component.  Each round takes the minimum label over a vertex's stored
    entries (both directions are stored), an order-free
    ``scatter_reduce('amin')``, then jumps pointers twice."""
    labels = torch.arange(g.n, dtype=torch.int32, device=g.device)
    if g.num_edges == 0:
        return labels.cpu().numpy()
    while True:
        new = labels.scatter_reduce(0, g.senders, labels[g.receivers],
                                    "amin", include_self=True)
        new = new[new.long()]
        new = new[new.long()]
        if not bool((new != labels).any()):
            return new.cpu().numpy()
        labels = new


def largest_component(g: Graph) -> tuple[Graph, np.ndarray]:
    """Induced subgraph on the largest connected component
    (examples/embedder.cpp:35-93): (subgraph, kept vertex ids)."""
    labels = component_labels(g)
    ids, counts = np.unique(labels, return_counts=True)
    best = ids[np.argmax(counts)]
    vertices = np.nonzero(labels == best)[0]
    return submatrix(g, vertices), vertices


def remove_largest(g: Graph, threshold: float = 0.01
                   ) -> tuple[Graph, np.ndarray]:
    """Drop vertices whose stored-entry count is >= threshold * the
    largest (examples/embedder.cpp:95-114)."""
    counts = np.diff(g.indptr.cpu().numpy())
    mx = counts.max() if counts.size else 0
    vertices = np.nonzero(counts < threshold * mx)[0]
    return submatrix(g, vertices), vertices
