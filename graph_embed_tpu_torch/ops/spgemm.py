"""Galerkin triple product A_c = P^T A P as relabel + sort + duplicate sum
(the SpGEMMs of examples/embed.cpp:95-98, embedder.cpp:213-216).

Counterpart of graph_embed_tpu/ops/spgemm.py.  P is an aggregation matrix,
so (A_c)_{ab} is the sum of w_ij over the entries with agg(i) = a and
agg(j) = b: every entry is relabelled through the vertex -> aggregate map
and duplicates summed.  ``coarsen_graph`` does it on the host and keeps
the host COO, summing in float64; ``coarsen_graph_device`` keeps it on the
graph's device: one stable sort on the int64 key ``a*(m+1)+b``, every run
of duplicates summed by one kernel A launch (``run_sums``), the coarse
indptr a ``searchsorted``.  ``sum_duplicates`` is the device coarsener's
duplicate sum, each run added in its input order
(``ops.segment.sequential_sum``), as the native coarsener rounds.
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


def _runs(s, r, n: int):
    """(order, firsts, indptr) of the COO (s, r) with ids below ``n``: one
    stable sort on the int64 key s*(n+1)+r (the order of the JAX package's
    two stable passes), ``order[firsts]`` the first entry of each run of
    equal keys, ``indptr`` the runs' bounds in sorted order."""
    key, order = torch.sort(s * (n + 1) + r, stable=True)
    heads = torch.ones_like(key, dtype=torch.bool)
    heads[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(heads).flatten()
    indptr = torch.cat([starts, starts.new_tensor([key.shape[0]])])
    return order, order[starts], indptr


def sum_duplicates(s, r, w, n: int):
    """The COO (s, r, w) with ids below ``n`` sorted by (s, r) and each
    run of duplicates summed in its input order (``_runs``, then
    ``ops.segment.sequential_sum``)."""
    order, firsts, indptr = _runs(s, r, n)
    return s[firsts], r[firsts], segment.sequential_sum(w[order], indptr)


#: a float32 sum whose every partial sum is an integer of at most this
#: magnitude is exact
_F32_INTEGERS = 1 << 24
#: kernel A sums up to four columns at once
_COLUMNS = 4


def _digit_base(total: float, longest: int) -> int | None:
    """The least k with which integer weights of absolute sum ``total``,
    in runs of at most ``longest``, split into ``_COLUMNS`` base-2^k
    digits (the low ones in [0, 2^k), the top one the rest) keep every
    partial sum of every column within ``_F32_INTEGERS``; None if no k
    does, or if the sum leaves the float64 integers."""
    if total >= 2.0 ** 53:
        return None
    for k in range(25):
        top = total / 2.0 ** (k * (_COLUMNS - 1)) + longest
        if top <= _F32_INTEGERS:
            return k if ((1 << k) - 1) * longest <= _F32_INTEGERS else None
    return None


def run_sums(w: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """[S] sums of the runs ``w[indptr[i]:indptr[i+1]]`` in ``w``'s dtype,
    by one kernel A launch over the runs (``ops.segment.segment_sum``;
    its plain version on the CPU).

    Integer weights (unit weights, and every Galerkin level above them)
    are summed exactly: split into base-2^k digits, one column of kernel
    A's float32 input each (one column where k = 0), with k chosen
    (``_digit_base``) so that no column's partial sum leaves the float32
    integers in any order; the columns' sums are combined in float64 and
    rounded once, which is the host's float64 sum rounded once, bit for
    bit.  Other weights, or integers too large to split, are summed in
    ``w``'s dtype in kernel A's fixed order (a run of up to 32 in its
    input order)."""
    csr = segment.sorted_csr(indptr, int(w.shape[0]))
    k = None
    if w.numel() and bool((w == torch.round(w)).all()):
        total = float(w.abs().sum(dtype=torch.float64))
        k = _digit_base(total, int((indptr[1:] - indptr[:-1]).max()))
    if k is None:
        return segment.segment_sum(w, csr)
    w64, digits = w.to(torch.float64), []
    base = float(1 << k)
    for _ in range(_COLUMNS - 1 if k else 0):
        q = torch.floor(w64 / base)
        digits.append(w64 - q * base)
        w64 = q
    digits.append(w64)
    y = segment.segment_sum(torch.stack(digits, 1).float(), csr)
    scale = torch.tensor([base ** j for j in range(len(digits))],
                         dtype=torch.float64, device=y.device)
    return (y.double() * scale).sum(1).to(w.dtype)


def coarsen_coo_device(senders, receivers, weights, vertex_to_agg,
                       num_aggs: int):
    """(senders, receivers, weights) of P^T A P on their device, sorted by
    (sender, receiver), duplicates summed by ``run_sums``, zero-weight
    entries dropped."""
    v2a = vertex_to_agg.to(senders.device, torch.int64)
    live = weights != 0
    s, r = v2a[senders[live]], v2a[receivers[live]]
    order, firsts, indptr = _runs(s, r, num_aggs)
    return s[firsts], r[firsts], run_sums(weights[live][order], indptr)


def coarsen_graph_device(g: csr.Graph, vertex_to_agg,
                         num_aggs: int) -> csr.Graph:
    """A_c = P^T A P on ``g``'s device; the result has no host COO."""
    m = int(num_aggs)
    ns, nr, nw = coarsen_coo_device(g.senders, g.receivers, g.weights,
                                    torch.as_tensor(vertex_to_agg), m)
    indptr = torch.searchsorted(ns, torch.arange(m + 1, device=ns.device))
    return csr.Graph(indptr=indptr, senders=ns, receivers=nr, weights=nw,
                     n=m, num_edges=int(ns.shape[0]))
