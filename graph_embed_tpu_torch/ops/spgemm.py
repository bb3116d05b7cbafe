"""Galerkin triple product A_c = P^T A P as relabel + sort + duplicate sum
(the SpGEMMs of examples/embed.cpp:95-98, embedder.cpp:213-216).

Counterpart of graph_embed_tpu/ops/spgemm.py.  P is an aggregation matrix,
so (A_c)_{ab} is the sum of w_ij over the entries with agg(i) = a and
agg(j) = b: every entry is relabelled through the vertex -> aggregate map
and duplicates summed.  ``coarsen_graph`` does it on the host and keeps
the host COO; ``coarsen_graph_device`` keeps it on the graph's device:
one stable sort on the int64 key ``a*(m+1)+b`` and a duplicate sum that
adds each run in its input order (``ops.segment.sequential_sum``, kernel A
on the card), the coarse indptr a ``searchsorted``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import csr
from . import segment


def coarsen_graph(g: csr.Graph, vertex_to_agg, num_aggs: int) -> csr.Graph:
    """A_c = P^T A P on the host, from ``g``'s host COO; the result keeps
    its host COO and lands on ``g``'s device."""
    s, r, w = g.to_coo_numpy()
    v2a = np.asarray(vertex_to_agg)
    return csr.from_edges(v2a[s], v2a[r], w, n=int(num_aggs),
                          dtype=g.dtype, device=g.device)


def sum_duplicates(s, r, w, n: int):
    """The COO (s, r, w) with ids below ``n`` sorted by (s, r) and each
    run of duplicates summed in its input order: one stable sort on the
    int64 key s*(n+1)+r (the order of the JAX package's two stable
    passes), then ``ops.segment.sequential_sum`` over the runs."""
    key, order = torch.sort(s * (n + 1) + r, stable=True)
    heads = torch.ones_like(key, dtype=torch.bool)
    heads[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(heads).flatten()
    indptr = torch.cat([starts, starts.new_tensor([key.shape[0]])])
    ws = segment.sequential_sum(w[order], indptr)
    return s[order][starts], r[order][starts], ws


def coarsen_coo_device(senders, receivers, weights, vertex_to_agg,
                       num_aggs: int):
    """(senders, receivers, weights) of P^T A P on their device, sorted by
    (sender, receiver), duplicates summed in input order, zero-weight
    entries dropped."""
    v2a = vertex_to_agg.to(senders.device, torch.int64)
    live = weights != 0
    return sum_duplicates(v2a[senders[live]], v2a[receivers[live]],
                          weights[live], num_aggs)


def coarsen_graph_device(g: csr.Graph, vertex_to_agg,
                         num_aggs: int) -> csr.Graph:
    """A_c = P^T A P on ``g``'s device; the result has no host COO."""
    m = int(num_aggs)
    ns, nr, nw = coarsen_coo_device(g.senders, g.receivers, g.weights,
                                    torch.as_tensor(vertex_to_agg), m)
    indptr = torch.searchsorted(ns, torch.arange(m + 1, device=ns.device))
    return csr.Graph(indptr=indptr, senders=ns, receivers=nr, weights=nw,
                     n=m, num_edges=int(ns.shape[0]))
