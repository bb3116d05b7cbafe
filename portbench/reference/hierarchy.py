"""Plain reference of the multilevel hierarchy and its Galerkin chain
(NumPy on the host; imports nothing of the program).

The coarsener is the reference's mutual-best modularity matching
(src/partitioner.cpp:1550-1893, partitionTest's rule at :252) as the
port's native and device coarseners both run it, so its decisions are
exact comparisons of float32 gains and every float is formed as they form
it: T a pairwise sum (blocks of at most 8 added from zero, halves added
up the tree), alpha_i = row sum / T, eta = 2 (w/T - alpha_i alpha_j) in
separate float32 operations, merges and duplicate sums added in a fixed
order (``np.add.at`` applies its updates one by one, in order).  Per
round, ``matching_iterations`` passes: every vertex picks its best
partner by (eta, a symmetric pair hash, -id), mutual pairs merge into the
smaller id; a round that merges under ``absorb_below`` of the live count
is followed by a star-absorb round; a snapshot is taken whenever the live
count crosses the coarsening factor; once positive merges stall, the
gain floor is dropped until ``force_coarsen_to``.  The Galerkin chain is
A_{l+1} = P^T A_l P, summed exactly in float64.
"""

from __future__ import annotations

import numpy as np

U32 = 0xFFFFFFFF
NEG_INF = np.float32(-np.inf)
DEFAULTS = dict(matching_iterations=2, positive_merging=True,
                absorb_below=0.05, force_coarsen_to=64,
                stall_stop_threshold=1.0)


def pairwise_sum(x: np.ndarray) -> np.float32:
    """The native coarsener's pairwise sum of float32 ``x``, bitwise."""
    lo, ln = np.zeros(1, np.int64), np.array([x.size], np.int64)
    depths = []
    while True:
        leaf = ln <= 8
        depths.append((lo, ln, leaf))
        if leaf.all():
            break
        inner = ~leaf
        h = ln[inner] // 2
        lo = np.stack([lo[inner], lo[inner] + h], 1).ravel()
        ln = np.stack([h, ln[inner] - h], 1).ravel()
    xz = np.concatenate([x.astype(np.float32), np.zeros(1, np.float32)])
    below = None
    for lo, ln, leaf in reversed(depths):
        val = np.empty(lo.size, np.float32)
        if leaf.any():
            off = np.arange(8)
            idx = np.where(off < ln[leaf][:, None], lo[leaf][:, None] + off,
                           x.size)
            blocks = xz[idx]
            acc = np.zeros(blocks.shape[0], np.float32)
            for j in range(8):
                acc = acc + blocks[:, j]
            val[leaf] = acc
        if not leaf.all():
            val[~leaf] = below[0::2] + below[1::2]
        below = val
    return below[0]


def _heads(sorted_ids: np.ndarray) -> np.ndarray:
    return np.flatnonzero(np.concatenate(
        [[True], sorted_ids[1:] != sorted_ids[:-1]]))


def _seg(ufunc, vals, ids_sorted, n: int, empty):
    """Per-segment reduction over values grouped by sorted ``ids``."""
    out = np.full(n, empty, dtype=vals.dtype)
    if ids_sorted.size:
        first = _heads(ids_sorted)
        out[ids_sorted[first]] = ufunc.reduceat(vals, first)
    return out


def sum_duplicates(s, r, w, n: int):
    """(s, r, w) sorted by (s, r), each run of equal pairs summed in its
    input order."""
    if s.size == 0:
        return s, r, w
    order = np.argsort(s * (n + 1) + r, kind="stable")
    s, r, w = s[order], r[order], w[order]
    key = s * (n + 1) + r
    heads = _heads(key)
    seg = np.cumsum(np.concatenate([[False], key[1:] != key[:-1]]))
    out = np.zeros(heads.size, w.dtype)
    np.add.at(out, seg, w)
    return s[heads], r[heads], out


def edge_hash(es, er, salt: int) -> np.ndarray:
    lo, hi = np.minimum(es, er), np.maximum(es, er)
    h = ((lo * 2654435761) & U32) ^ ((hi * 40503 + 0x9E3779B9) & U32)
    h = h ^ ((int(salt) & U32) * 0x85EBCA6B & U32)
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & U32
    h = h ^ (h >> 15)
    return h >> 1


class State:
    def __init__(self, es, er, ew, alpha, n):
        self.es, self.er, self.ew, self.alpha = es, er, ew, alpha
        self.live = np.ones(n, bool)
        self.label = np.arange(n)
        self.n = n


def best_partner(st: State, notouch, T, salt: int, positive: bool):
    n, es, er, ew = st.n, st.es, st.er, st.ew
    valid = (ew != 0) & ~notouch[es] & ~notouch[er]
    quot = ew / T
    prod = st.alpha[es] * st.alpha[er]
    eta = np.float32(2.0) * (quot - prod)
    eta = np.where(valid, eta, NEG_INF)
    m = _seg(np.maximum, eta, es, n, NEG_INF)
    is_best = (eta == m[es]) & (eta > NEG_INF)
    h = np.where(is_best, edge_hash(es, er, salt), -1)
    hmax = _seg(np.maximum, h, es, n, np.iinfo(np.int64).min)
    is_best = is_best & (h == hmax[es])
    cand = np.where(is_best, er, n)
    best = _seg(np.minimum, cand, es, n, np.iinfo(np.int64).max)
    has = (m > NEG_INF) & (best < n) & st.live & ~notouch
    if positive:
        has = has & (m > 0.0)
    return np.where(has, best, -1)


def commit(st: State, match_to) -> int:
    removed = match_to >= 0
    rids = np.flatnonzero(removed)
    tgt = match_to[rids]
    order = np.argsort(tgt, kind="stable")
    np.add.at(st.alpha, tgt[order], st.alpha[rids[order]])
    map_v = np.where(removed, match_to, np.arange(st.n))
    s, r, w = map_v[st.es], map_v[st.er], st.ew
    keep = (w != 0) & (s != r)
    st.es, st.er, st.ew = sum_duplicates(s[keep], r[keep], w[keep], st.n)
    st.live &= ~removed
    st.label = np.where(removed, match_to, st.label)
    return int(rids.size)


def coarsen_round(st: State, T, salt: int, iterations: int,
                  positive: bool) -> int:
    notouch = ~st.live
    match_to = np.full(st.n, -1)
    ids = np.arange(st.n)
    for it in range(iterations):
        partner = best_partner(st, notouch, T, salt * iterations + it,
                               positive)
        has = partner >= 0
        mutual = has & (partner[np.maximum(partner, 0)] == ids)
        match_to = np.where(mutual & (partner < ids), partner, match_to)
        notouch = notouch | mutual
    return commit(st, match_to)


def absorb_round(st: State, T, salt: int, positive: bool) -> int:
    partner = best_partner(st, ~st.live, T, salt, positive)
    has = partner >= 0
    receives = np.zeros(st.n + 1, bool)
    receives[np.where(has, partner, st.n)] = True
    removed = has & ~receives[:st.n]
    return commit(st, np.where(removed, partner, -1))


def snapshot(st: State, prev_reps):
    label = st.label
    while True:
        new = label[label]
        if np.array_equal(new, label):
            break
        label = new
    st.label = label
    assign = (np.cumsum(st.live) - 1)[label[prev_reps]]
    return assign, np.flatnonzero(st.live)


def hierarchy(senders, receivers, weights, n: int,
              coarsening_factor: float, **params) -> list[np.ndarray]:
    """[v2a_0, v2a_1, ...]: level l's vertex -> level l+1 aggregate, as
    int64 arrays, from a symmetric COO sorted by (sender, receiver)."""
    p = {**DEFAULTS, **params}
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    w = np.asarray(weights, np.float32)
    T = pairwise_sum(w)
    alpha = np.zeros(n, np.float32)
    np.add.at(alpha, s, w)
    alpha = alpha / T
    keep = (s != r) & (w != 0)
    st = State(s[keep], r[keep], w[keep], alpha, n)
    levels, sizes = [], [n]
    prev = np.arange(n)
    m = n_level = n
    rnd = 0
    positive = p["positive_merging"]
    it = p["matching_iterations"]
    while True:
        merged = coarsen_round(st, T, rnd, it, positive)
        rnd += 1
        m_prev, m = m, m - merged
        if (p["absorb_below"] > 0 and merged < p["absorb_below"] * m_prev
                and m > 1):
            m -= absorb_round(st, T, rnd * it, positive)
            rnd += 1
        if m / n_level <= coarsening_factor:
            assign, prev = snapshot(st, prev)
            levels.append(assign)
            sizes.append(m)
            n_level = m
        if m_prev == 0 or m / max(m_prev, 1) >= p["stall_stop_threshold"]:
            if positive and p["force_coarsen_to"] > 0 and \
                    m > p["force_coarsen_to"] and m > 1:
                positive = False
                continue
            break
        if m <= 1:
            break
    if not levels or m < sizes[-1]:
        assign, prev = snapshot(st, prev)
        levels.append(assign)
    return levels


def galerkin(senders, receivers, weights, v2a, m: int):
    """P^T A P as a COO sorted by (sender, receiver), float64 sums."""
    s = np.asarray(v2a)[senders]
    r = np.asarray(v2a)[receivers]
    key, inv = np.unique(s * m + r, return_inverse=True)
    w = np.bincount(inv.ravel(), weights=np.asarray(weights, np.float64))
    return key // m, key % m, w
