"""One-sided greedy coarsening: partitionBase / partitionBase2 semantics
(src/partitioner.cpp:436-694 Base, :696-966 Base2), the pure-Python
version.

Counterpart of graph_embed_tpu/partition/greedy.py, whose doc gives the
algorithm.  Per round every live vertex takes its best-gain neighbour; a
sequential commit over the ``used`` array merges (i, j) when neither was
touched and eta_i >= eta_j, so the algorithm is inherently sequential and
runs on the host.  This is the oracle beside the native C++ backend
(native/csrc/greedy.cpp), with the same float32 arithmetic; 'base2' drops
the i < j commit gate and scans neighbours in sorted order.
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import Graph
from .interpolation import Partition


def _coo_sorted_rows(g: Graph):
    """(s, r, w) sorted by (row, col) -- the CSR traversal order of the
    reference (linalgcpp stores sorted indices)."""
    s, r, w = g.to_coo_numpy()
    order = np.lexsort((r, s))
    return s[order], r[order], w[order]


def greedy_partition_py(g: Graph, stall_stop_threshold: float = 1.0,
                        variant: str = "base"):
    """Pure-Python one-sided greedy (the oracle; use partition_base for the
    native fast path).  Returns (Partition, Q float)."""
    if variant not in ("base", "base2"):
        raise ValueError(f"unknown greedy variant {variant!r}")
    n = g.n
    s, r, w = _coo_sorted_rows(g)
    f32 = np.float32
    a = [dict() for _ in range(n)]
    alpha = np.zeros(n, f32)
    T = f32(0.0)
    d_sum = f32(0.0)
    # row-major sorted accumulation matches the reference's CSR loops
    for i, j, wij in zip(s, r, w):
        wf = f32(wij)
        if i != j:
            a[i][int(j)] = wf
        else:
            d_sum = f32(d_sum + wf)
        alpha[i] = f32(alpha[i] + wf)
        T = f32(T + wf)
    alpha = (alpha / T).astype(f32)
    Q = f32(d_sum / T)
    for i in range(n):
        Q = f32(Q - alpha[i] * alpha[i])

    NEG_INF = f32(-np.inf)
    max_eta = np.full(n, NEG_INF, f32)
    max_ind = np.full(n, -1, np.int64)
    notouch = np.zeros(n, bool)
    used = list(range(n))
    pointer = list(range(n))
    ids = list(range(n))
    M = n
    while True:
        # match-find: every live vertex rescans its (sorted) neighbors
        for i in used:
            best = NEG_INF
            best_j = -1
            ai = alpha[i]
            for j in sorted(a[i]):
                eta = f32(f32(2.0) * f32(f32(a[i][j] / T) - f32(ai * alpha[j])))
                if eta > best:
                    best = eta
                    best_j = j
            max_eta[i] = best
            max_ind[i] = best_j
        # sequential commit in used order (the order-dependent part);
        # DeltaQ accumulates max_eta of the SCANNED endpoint (:572,:589)
        merged = []
        dq_round = f32(0.0)
        for x in range(len(used)):
            i = used[x]
            if notouch[i]:
                continue
            j = int(max_ind[i])
            if j == -1 or notouch[j]:
                continue
            if not (max_eta[i] >= max_eta[j]):
                continue
            if max_eta[i] <= 0:
                continue
            if variant == "base" and not (i < j):
                continue
            if len(a[i]) < len(a[j]):
                i_p, j_p = j, i
            else:
                i_p, j_p = i, j
            merged.append((i_p, j_p))
            notouch[i] = True
            notouch[j] = True
            dq_round = f32(dq_round + max_eta[i])
        # contraction: fold j' into i' (partitioner.cpp:596-616)
        for i_p, j_p in merged:
            for k in sorted(a[j_p]):
                a_jk = a[j_p][k]
                del a[k][j_p]
                if k == i_p:
                    alpha[i_p] = f32(alpha[i_p] + alpha[j_p])
                else:
                    a[i_p][k] = f32(a[i_p].get(k, f32(0.0)) + a_jk)
                    a[k][i_p] = f32(a[k].get(i_p, f32(0.0)) + a_jk)
            a[j_p] = {}
        # Q update + swap-erase compaction + union-find link (:630-652)
        Q = f32(Q + dq_round)
        for i_p, j_p in merged:
            idx = pointer[j_p]
            klast = used[-1]
            used[idx], used[-1] = used[-1], used[idx]
            used.pop()
            pointer[klast] = idx
            ids[j_p] = i_p
            notouch[i_p] = False
        M_prev, M = M, M - len(merged)
        if M / M_prev >= stall_stop_threshold:
            break

    # union-find flatten with path compression (:670-680)
    idarr = np.asarray(ids, np.int64)

    def find(i):
        root = i
        while idarr[root] != root:
            root = idarr[root]
        while idarr[i] != root:
            nxt = idarr[i]
            idarr[i] = root
            i = nxt
        return root

    assign = np.empty(n, np.int32)
    for v in range(n):
        assign[v] = pointer[find(v)]
    return Partition.from_numpy(assign, M, device=g.device), float(Q)
