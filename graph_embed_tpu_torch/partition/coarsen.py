"""The device coarsener: parallel mutual-best DeltaQ matching on the
graph's device.

Counterpart of graph_embed_tpu/partition/coarsen.py (partitionTest's
mutual-best rule, src/partitioner.cpp:252, in rounds of the hierarchy's
do-loop, :1696-1838).  Per round, per edge the gain
eta = 2 (w/T - alpha_i alpha_j) (:1715); per vertex the best partner by
(eta, pair hash, -id); mutual pairs commit: union, alpha and size merge,
endpoint relabel, duplicate sum.  The JAX module is plain XLA at a fixed
padded capacity; here the state holds exactly its live edges, so its
capacity classes and their repacking have no counterpart.

The device coarsener must give the hierarchy the native one gives
(native/csrc/coarsen.cpp), whose decisions are exact comparisons of
float32 gains.  So every float is computed as the native code computes
it:
* T is its pairwise sum (``_pairwise_sum``, coarsen.cpp:57-66);
* the weight jitter factor is formed in float64, then rounded (:110);
* alpha, the duplicate sums and every merge fold add in the native
  order: a row's entries in order, a merge target's own alpha first and
  then its contributors by ascending id (:437), each segment summed as a
  sequential loop would (``ops.segment.sequential_sum``, kernel A on the
  card, never atomics);
* eta is separate torch operations (no fused multiply-add).
The per-vertex maxima and minima (``ops.segment.segment_max`` and
``segment_min``, ``scatter_reduce``) are order-free.  The running Q is kept in float64, like the native one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import segment
from ..ops.spgemm import sum_duplicates

NEG_INF = float("-inf")
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CoarsenState:
    """es/er/ew: [E] live contracted edges, both directions stored, no
    self loops, sorted by (sender, receiver); alpha: [n] row sums over T;
    live: [n] bool, still a representative; label: [n] union-find parent;
    Q: float64 0-d running modularity; size: [n] members per
    representative (the max_agg_size cap)."""

    es: torch.Tensor
    er: torch.Tensor
    ew: torch.Tensor
    alpha: torch.Tensor
    live: torch.Tensor
    label: torch.Tensor
    Q: torch.Tensor
    size: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.alpha.shape[0])


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """The native coarsener's pairwise sum (coarsen.cpp:57-66) in
    ``x``'s dtype, bitwise: halve ``n`` into n//2 and n - n//2 until a
    block has at most 8 values, add each block in order from zero, then
    add the halves back up the tree.  The tree's shape depends on ``n``
    alone and is built on the host."""
    lo, ln = np.zeros(1, np.int64), np.array([x.shape[0]], np.int64)
    depths = []
    while True:
        leaf = ln <= 8
        depths.append((lo, ln, leaf))
        inner = ~leaf
        if not inner.any():
            break
        h = ln[inner] // 2
        lo = np.stack([lo[inner], lo[inner] + h], 1).ravel()
        ln = np.stack([h, ln[inner] - h], 1).ravel()
    dev = x.device
    xz = torch.cat([x, x.new_zeros(1)])
    below = None
    for lo, ln, leaf in reversed(depths):
        val = x.new_empty(lo.shape[0])
        if leaf.any():
            off = np.arange(8)
            idx = np.where(off < ln[leaf][:, None], lo[leaf][:, None] + off,
                           x.shape[0])
            blocks = xz[torch.from_numpy(idx).to(dev)]
            acc = x.new_zeros(blocks.shape[0])
            for j in range(8):
                acc = acc + blocks[:, j]
            val[torch.from_numpy(np.nonzero(leaf)[0]).to(dev)] = acc
        if not leaf.all():
            val[torch.from_numpy(np.nonzero(~leaf)[0]).to(dev)] = (
                below[0::2] + below[1::2])
        below = val
    return below[0]


def _jitter_factor(s, r, weight_jitter: float, dtype) -> torch.Tensor:
    """(1 + jitter * u) per entry, u in [-1, 1) from a symmetric hash of
    the endpoint pair (run-tests.cpp:162-181, made reproducible), formed in
    float64 and rounded to ``dtype`` as coarsen.cpp:110 does."""
    lo = torch.minimum(s, r)
    hi = torch.maximum(s, r)
    h = ((lo * 2654435761) & _U32) ^ ((hi * 40503 + 0x9E3779B9) & _U32)
    u = (h >> 8).to(torch.float32) / float(1 << 24) * 2.0 - 1.0
    return (1.0 + weight_jitter * u.to(torch.float64)).to(dtype)


def init_state(g: Graph, *, weight_jitter: float = 0.0
               ) -> tuple[CoarsenState, torch.Tensor]:
    """The initial state of a symmetric graph, and T (coarsen.cpp:101-136;
    partitioner.cpp:1565-1605): alpha_i the full row sum incl. the
    diagonal over T, Q_0 = d_sum/T - sum alpha_i^2, the edge list without
    self loops and zero weights."""
    n = g.n
    w = g.weights
    if weight_jitter > 0.0:
        w = w * _jitter_factor(g.senders, g.receivers, weight_jitter,
                               w.dtype)
    T = _pairwise_sum(w)
    alpha = segment.sequential_sum(w, g.indptr) / T
    is_self = g.senders == g.receivers
    d_sum = torch.where(is_self, w, torch.zeros_like(w)).double().sum()
    keep = ~is_self & (w != 0)
    a64 = alpha.double()
    Q0 = d_sum / T.double() - torch.sum(a64 * a64)
    dev = g.device
    state = CoarsenState(
        es=g.senders[keep], er=g.receivers[keep], ew=w[keep], alpha=alpha,
        live=torch.ones(n, dtype=torch.bool, device=dev),
        label=torch.arange(n, device=dev), Q=Q0,
        size=torch.ones(n, dtype=torch.int64, device=dev))
    return state, T


def _dedup_edges(es, er, ew, n: int):
    """Drop self loops and zero weights, then sum duplicate (s, r) edges,
    each run in its input order (coarsen.cpp:286; the key's one stable
    sort gives the order of the reference's two passes, :128-129)."""
    keep = (ew != 0) & (es != er)
    return sum_duplicates(es[keep], er[keep], ew[keep], n)


def _edge_hash(es, er, salt: int) -> torch.Tensor:
    """Symmetric per-undirected-edge priority in [0, 2^31) (coarsen.py:
    146-161): the uint32 arithmetic in int64, masked to 32 bits after each
    multiply and add.  Symmetry lets both endpoints rank tied edges
    alike, so the locally best edge is picked from both sides."""
    lo = torch.minimum(es, er)
    hi = torch.maximum(es, er)
    h = ((lo * 2654435761) & _U32) ^ ((hi * 40503 + 0x9E3779B9) & _U32)
    h = h ^ ((int(salt) & _U32) * 0x85EBCA6B & _U32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _U32
    h = h ^ (h >> 15)
    return h >> 1


def _best_partner(st: CoarsenState, notouch, T, salt: int, cap: int,
                  positive_merging: bool, tie_break: str):
    """Per-vertex best merge partner by (eta, pair hash, -id)
    (coarsen.cpp:333-369): (partner [n], -1 for none; eta at it).
    ``cap`` > 0 excludes pairs whose merged member count would exceed
    it."""
    n = st.n
    es, er, ew = st.es, st.er, st.ew
    valid = (ew != 0) & ~notouch[es] & ~notouch[er]
    if cap > 0:
        valid = valid & (st.size[es] + st.size[er] <= cap)
    quot = ew / T
    prod = st.alpha[es] * st.alpha[er]
    eta = 2.0 * (quot - prod)
    eta = torch.where(valid, eta, torch.full_like(eta, NEG_INF))
    m = segment.segment_max(eta, es, n)
    is_best = (eta == m[es]) & (eta > NEG_INF)
    if tie_break == "hash":
        h = torch.where(is_best, _edge_hash(es, er, salt),
                        torch.full_like(es, -1))
        is_best = is_best & (h == segment.segment_max(h, es, n)[es])
    cand = torch.where(is_best, er, torch.full_like(er, n))
    best = segment.segment_min(cand, es, n)
    has = (m > NEG_INF) & (best < n) & st.live & ~notouch
    if positive_merging:
        has = has & (m > 0.0)
    return torch.where(has, best, torch.full_like(best, -1)), m


def _match_pass(st: CoarsenState, notouch, T, salt: int, cap: int,
                positive_merging: bool, tie_break: str):
    """One matching pass: best partners, mutual pairs commit with the
    smaller id as representative.  Returns (match_to [n]: the
    representative of a removed vertex, -1 elsewhere; the pass's gain,
    float64; notouch updated)."""
    n = st.n
    partner, m = _best_partner(st, notouch, T, salt, cap, positive_merging,
                               tie_break)
    has = partner >= 0
    iarr = torch.arange(n, device=partner.device)
    mutual = has & (partner[partner.clamp(min=0)] == iarr)
    match_to = torch.where(mutual & (partner < iarr), partner,
                           torch.full_like(partner, -1))
    is_rep = mutual & (partner > iarr)
    gain = torch.where(is_rep, m, torch.zeros_like(m)).double().sum()
    return match_to, gain, notouch | mutual


def coarsen_round(st: CoarsenState, T, salt: int = 0, max_agg_size: int = 0,
                  *, matching_iterations: int = 2,
                  positive_merging: bool = True, tie_break: str = "hash"):
    """One coarsening round (partitioner.cpp:1696; coarsen.cpp:412-430):
    ``matching_iterations`` passes, the pass salt ``salt *
    matching_iterations + it``.  Returns (state, merged, live edges), the
    counts as device scalars."""
    notouch = ~st.live
    match_to = torch.full((st.n,), -1, dtype=torch.int64,
                          device=st.alpha.device)
    gain = torch.zeros((), dtype=torch.float64, device=st.alpha.device)
    for it in range(matching_iterations):
        mt, g, notouch = _match_pass(
            st, notouch, T, salt * matching_iterations + it, max_agg_size,
            positive_merging, tie_break)
        match_to = torch.where(mt >= 0, mt, match_to)
        gain = gain + g
    return _commit(st, match_to, gain)


def _commit(st: CoarsenState, match_to, gain):
    """Apply merges (match_to[j] = its representative, or -1): union,
    alpha and size merge, one-hop endpoint relabel, dedup (coarsen.cpp:
    434-454).  A merge target is never itself removed, so one relabel
    suffices.  Each target's alpha is its own followed by its contributors'
    in ascending id, added in that order."""
    n = st.n
    removed = match_to >= 0
    rids = torch.nonzero(removed).flatten()
    tgt = match_to[rids]
    tgt_s, order = torch.sort(tgt, stable=True)
    uniq, counts = torch.unique_consecutive(tgt_s, return_counts=True)
    indptr = torch.zeros(uniq.shape[0] + 1, dtype=torch.int64,
                         device=tgt.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    alpha = st.alpha.clone()
    alpha[uniq] = segment.sequential_sum(st.alpha[rids[order]], indptr,
                                         init=st.alpha[uniq])
    size = st.size.index_add(0, tgt, st.size[rids])
    map_v = torch.where(removed, match_to,
                        torch.arange(n, device=match_to.device))
    es, er, ew = _dedup_edges(map_v[st.es], map_v[st.er], st.ew, n)
    new = CoarsenState(es=es, er=er, ew=ew, alpha=alpha,
                       live=st.live & ~removed,
                       label=torch.where(removed, match_to, st.label),
                       Q=st.Q + gain, size=size)
    return new, rids.shape[0], ew.shape[0]


def absorb_round(st: CoarsenState, T, salt: int = 0, max_agg_size: int = 0,
                 *, positive_merging: bool = True, tie_break: str = "hash"):
    """Star absorption (coarsen.py:294-327; coarsen.cpp:392-410): every
    vertex with a best partner merges into it unless it receives a merge
    itself, so a star contracts in one round.  The running Q adds the
    pre-round gains (approximate under multi-absorb, as in both
    references)."""
    n = st.n
    partner, m = _best_partner(st, ~st.live, T, salt, max_agg_size,
                               positive_merging, tie_break)
    has = partner >= 0
    receives = torch.zeros(n + 1, dtype=torch.bool, device=partner.device)
    receives[torch.where(has, partner, torch.full_like(partner, n))] = True
    removed = has & ~receives[:n]
    match_to = torch.where(removed, partner, torch.full_like(partner, -1))
    gain = torch.where(removed, m, torch.zeros_like(m)).double().sum()
    return _commit(st, match_to, gain)


def merge_leaves_round(st: CoarsenState, T, positive: bool):
    """One mergeLeaves sweep (partitioner.cpp:1642-1689; coarsen.cpp:
    458-487): every vertex with exactly one incident edge merges into its
    neighbour; of two leaves joined to each other the smaller id stays.
    Returns (state, merged)."""
    n = st.n
    nz = st.ew != 0
    deg = torch.zeros(n, dtype=torch.int64, device=st.es.device
                      ).index_add(0, st.es, nz.long())
    nbr = segment.segment_max(
        torch.where(nz, st.er, torch.full_like(st.er, -1)), st.es, n)
    wt = segment.segment_max(
        torch.where(nz, st.ew, torch.full_like(st.ew, NEG_INF)), st.es, n)
    nb = nbr.clamp(min=0)
    gain = 2.0 * (wt / T - st.alpha * st.alpha[nb])
    ok = st.live & (deg == 1) & (nbr >= 0)
    if positive:
        ok = ok & (gain > 0)
    iarr = torch.arange(n, device=nbr.device)
    removed = ok & ~(ok & ok[nb] & (iarr < nbr))
    match_to = torch.where(removed, nbr, torch.full_like(nbr, -1))
    total = torch.where(removed, gain, torch.zeros_like(gain)).double().sum()
    new, merged, _ = _commit(st, match_to, total)
    return new, merged


def resolve_labels(label: torch.Tensor) -> torch.Tensor:
    """Full path compression: label[v] <- root(v) by pointer jumping to a
    fixed point."""
    while True:
        new = label[label]
        if torch.equal(new, label):
            return new
        label = new


def dense_ranks(live: torch.Tensor) -> torch.Tensor:
    """Dense ids of live vertices: rank[v] = #live vertices with id < v."""
    return torch.cumsum(live.long(), 0) - 1
