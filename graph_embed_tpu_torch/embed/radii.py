"""Aggregate ball radii: the ball-growing / first-collision sweep
(src/embed.cpp:616-678 top level over all pairs, :680-756 inner levels over
coarse-graph edges within one grandparent), and the renormalization of
children into their parent balls (:757-777).

Counterpart of graph_embed_tpu/embed/radii.py.  The sweeps run on the
host in the native C++ heap (native/sweep.cpp), which is bit-identical to
the reference's Python heap (radii.py:84-150, ``_sweep_host``): pop the
alive pair of least (tau, pair index); unassigned endpoints get tau;
alive pairs touching a newly assigned vertex move to 2 tau - tau_popped.
``radii_inner(backend="bucketed")`` runs the reference's device sweep
instead, in plain torch on the centres' device (``_sweep_batched``), with
the same radii bit for bit.  The centres are pulled to the host ([m, d],
small); the radii go back to the centres' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import Graph
from ..native import sweep_lib
from ..partition.interpolation import Partition


# candidate lists of at least this many pairs sweep on the host in the
# bucketed backend: the device sweep is P steps of a full argmin, P^2 work
# per row (radii.py:80-84)
HOST_SWEEP_P = 8192


def _sweep_batched(tau0, pi, pj, valid, num_local: int) -> torch.Tensor:
    """Independent first-collision sweeps, one per row (radii.py:33-76):
    tau0 [B, P] initial times, pi/pj [B, P] local ids in [0, num_local),
    valid [B, P].  Each of the P steps pops every row's alive pair of
    least time (``torch.argmin``: the first of equal times, the
    reference's pair-index tie-break); unassigned endpoints get its time,
    and alive pairs touching a newly assigned vertex move to 2 tau -
    tau_popped.  Returns r [B, num_local] (0 = unassigned), in plain torch
    on the inputs' device."""
    B, P = tau0.shape
    dev, dt = tau0.device, tau0.dtype
    big = torch.tensor(torch.finfo(dt).max, dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    r = torch.zeros((B, num_local), dtype=dt, device=dev)
    assigned = torch.zeros((B, num_local), dtype=torch.bool, device=dev)
    alive = valid.clone()
    tau = torch.where(valid, tau0, big)
    for _ in range(P):
        masked = torch.where(alive, tau, big)
        idx = torch.argmin(masked, dim=1)
        has = masked[rows, idx] < big
        i, j = pi[rows, idx], pj[rows, idx]
        tpop = tau[rows, idx]
        ai, aj = assigned[rows, i], assigned[rows, j]
        new_i, new_j = has & ~ai, has & ~aj
        r[rows, i] = torch.where(new_i, tpop, r[rows, i])
        r[rows, j] = torch.where(new_j, tpop, r[rows, j])
        assigned[rows, i] = ai | new_i
        assigned[rows, j] = aj | new_j
        alive[rows, idx] = False
        touched = ((new_i[:, None] & ((pi == i[:, None]) | (pj == i[:, None])))
                   | (new_j[:, None]
                      & ((pi == j[:, None]) | (pj == j[:, None]))))
        tau = torch.where(touched & alive, 2.0 * tau - tpop[:, None], tau)
    return r


def _sweep_one(tau0, pi, pj, valid, num_local: int) -> torch.Tensor:
    """One candidate list ([P] tensors) through ``_sweep_batched``."""
    return _sweep_batched(tau0[None], pi[None], pj[None], valid[None],
                          num_local)[0]


def _sweep_host(tau0, pi, pj, num_local: int) -> np.ndarray:
    """The Python heap sweep, semantics of ``_sweep_one`` (radii.py:
    87-134): pop the alive pair of least (tau, pair index); unassigned
    endpoints get tau; alive pairs touching a newly assigned vertex move
    to 2 tau - tau_popped, re-pushed with their new time (stale heap
    entries are skipped)."""
    import heapq

    P = tau0.shape[0]
    tau0, pi, pj = np.asarray(tau0), np.asarray(pi), np.asarray(pj)
    r = np.zeros(num_local, tau0.dtype)
    assigned = np.zeros(num_local, dtype=bool)
    alive = np.ones(P, dtype=bool)
    cur = tau0.copy()
    cnt = (np.bincount(pi, minlength=num_local)
           + np.bincount(pj, minlength=num_local))
    starts = np.concatenate([[0], np.cumsum(cnt)])
    v_all = np.concatenate([pi, pj])
    k_all = np.concatenate([np.arange(P, dtype=np.int64)] * 2)
    inc = k_all[np.argsort(v_all, kind="stable")]
    heap = [(float(tau0[k]), k) for k in range(P)]
    heapq.heapify(heap)
    while heap:
        t, k = heapq.heappop(heap)
        if not alive[k] or t != float(cur[k]):
            continue
        alive[k] = False
        newly = []
        for v in (int(pi[k]), int(pj[k])):
            if not assigned[v]:
                r[v] = cur[k]
                assigned[v] = True
                newly.append(v)
        if not newly:
            continue
        touched = np.unique(np.concatenate(
            [inc[starts[v]: starts[v + 1]] for v in newly]))
        tpop = cur[k]
        for kk in touched:
            if alive[kk]:
                cur[kk] = tau0.dtype.type(2.0) * cur[kk] - tpop
                heapq.heappush(heap, (float(cur[kk]), int(kk)))
    return r


def _sweep(tau0, pi, pj, num_local: int) -> np.ndarray:
    """The host sweep: native ``sweep.cpp`` (bit-identical to
    ``_sweep_host``) when it builds, else the Python heap."""
    if sweep_lib.available():
        return sweep_lib.sweep_run(tau0, pi, pj, num_local)
    return _sweep_host(tau0, pi, pj, num_local)


def _half_nn_radius(coords: np.ndarray, *, block: int = 2048) -> np.ndarray:
    """Half the distance to the nearest other centre: the radius of an
    aggregate no sweep candidate touches (disconnected components), which
    keeps the balls disjoint (radii.py:152-172)."""
    m = coords.shape[0]
    if m <= 1:
        return np.ones(m, coords.dtype)
    out = np.empty(m, coords.dtype)
    sq = (coords * coords).sum(-1)
    for b0 in range(0, m, block):
        blk = coords[b0: b0 + block]
        d2 = sq[b0: b0 + block, None] + sq[None, :] - 2.0 * blk @ coords.T
        np.fill_diagonal(d2[:, b0: b0 + block], np.inf)
        out[b0: b0 + block] = np.sqrt(np.maximum(d2.min(axis=1), 0.0)) / 2.0
    return out


def radii_top_level(coords_A: torch.Tensor, *, max_all_pairs: int = 512,
                    coarse_edges=None) -> torch.Tensor:
    """Radii among all coarsest aggregates (embed.cpp:616-678): all pairs
    up to ``max_all_pairs`` aggregates, coarse-graph edges above that."""
    cA = coords_A.detach().cpu().numpy()
    m = cA.shape[0]
    if m <= 1:
        return torch.ones(m, dtype=coords_A.dtype, device=coords_A.device)
    if m <= max_all_pairs or coarse_edges is None:
        pi, pj = np.triu_indices(m, k=1)
    else:
        s, r = (np.asarray(a) for a in coarse_edges)
        keep = s < r
        pi, pj = s[keep], r[keep]
    pi = pi.astype(np.int32)
    pj = pj.astype(np.int32)
    if pi.size == 0:
        r_A = _half_nn_radius(cA)
    else:
        dv = cA[pi] - cA[pj]
        tau0 = (np.sqrt((dv * dv).sum(-1)) / 2.0).astype(cA.dtype)
        r_A = sweep_lib.sweep_run(tau0, pi, pj, m)
        untouched = np.ones(m, dtype=bool)
        untouched[pi] = False
        untouched[pj] = False
        if untouched.any():
            r_A[untouched] = _half_nn_radius(cA)[untouched]
    return torch.from_numpy(r_A).to(coords_A.device)


def radii_inner(coords_A: torch.Tensor, r_Ac: torch.Tensor,
                coarse_graph: Graph, grandparent: Partition,
                backend: str = "auto") -> torch.Tensor:
    """Inner-level radii (embed.cpp:680-756): per grandparent aggregate,
    the candidates are coarse-graph edges (a < j) inside it.  Singletons
    inherit the parent radius (:707-711); children no candidate touches
    get half the distance to their nearest sibling.

    ``backend``: "auto" sweeps every grandparent in one batched native
    call (when the toolchain builds, else as "bucketed"); "bucketed"
    sweeps the grandparents in power-of-two pair-count classes on the
    centres' device (``_sweep_batched``), and the classes of at least
    ``HOST_SWEEP_P`` pairs one by one on the host (``_sweep``).  The two
    give the same radii bit for bit (radii.py:225-345)."""
    if backend not in ("auto", "bucketed"):
        raise ValueError(f"unknown radii backend {backend!r}; expected "
                         "'auto' or 'bucketed'")
    dd = coords_A.detach().cpu().numpy()
    m = dd.shape[0]
    gp = grandparent.vertex_to_agg_numpy()
    mc = grandparent.num_aggs
    s, r, _ = coarse_graph.to_coo_numpy()
    keep = (s < r) & (gp[s] == gp[r])
    es, er = s[keep], r[keep]
    b_of_pair = gp[es]

    order_v = np.argsort(gp, kind="stable")
    counts_v = np.bincount(gp, minlength=mc)
    starts_v = np.concatenate([[0], np.cumsum(counts_v)])
    local_of = np.zeros(m, dtype=np.int64)
    local_of[order_v] = np.arange(m) - starts_v[gp[order_v]]

    r_A = np.zeros(m, dtype=dd.dtype)
    counts_p = np.bincount(b_of_pair, minlength=mc)
    order_p = np.argsort(b_of_pair, kind="stable")
    starts_p = np.concatenate([[0], np.cumsum(counts_p)])
    if es.size and backend == "auto" and sweep_lib.available():
        # pairs sorted by grandparent: a pair's index within its row is
        # the bucketed path's, so the tie-breaks agree
        dv = dd[es[order_p]] - dd[er[order_p]]
        tau0 = (np.sqrt((dv * dv).sum(-1)) / 2.0).astype(dd.dtype)
        r_A[order_v] = sweep_lib.sweep_batch(
            tau0, local_of[es[order_p]], local_of[er[order_p]], starts_p,
            starts_v)
    elif es.size:
        _bucketed(r_A, dd, es, er, gp, local_of, counts_v, order_v,
                  starts_v, counts_p, order_p, starts_p, coords_A.device)
    return _radii_inner_epilogue(r_A, r_Ac, dd, gp, counts_v, order_v,
                                 starts_v, coords_A.device)


def _bucketed(r_A, dd, es, er, gp, local_of, counts_v, order_v, starts_v,
              counts_p, order_p, starts_p, device) -> None:
    """The bucketed sweep into ``r_A`` (radii.py:287-342): grandparents in
    power-of-two pair-count classes, each class one ``_sweep_batched``
    call on ``device`` padded to its class; classes of at least
    ``HOST_SWEEP_P`` pairs on the host, one grandparent at a time."""
    mc = counts_v.shape[0]
    sb = gp[es][order_p]
    pos_p = np.arange(es.size) - starts_p[sb]
    epi, epj = es[order_p], er[order_p]
    pcls = np.zeros(mc, dtype=np.int64)
    haspair = counts_p > 0
    pcls[haspair] = 1 << np.ceil(np.log2(counts_p[haspair])).astype(np.int64)
    for P in np.unique(pcls[haspair]):
        rows = np.nonzero(pcls == P)[0]
        P = int(P)
        if P >= HOST_SWEEP_P:
            # hub grandparents: the device sweep costs P^2 per row
            for b in rows:
                pk = order_p[starts_p[b]: starts_p[b + 1]]
                dv = dd[es[pk]] - dd[er[pk]]
                tau0 = np.sqrt((dv * dv).sum(-1)) / 2.0
                r_loc = _sweep(tau0, local_of[es[pk]], local_of[er[pk]],
                               int(counts_v[b]))
                kids = order_v[starts_v[b]: starts_v[b + 1]]
                r_A[kids] = r_loc[local_of[kids]]
            continue
        mb = rows.size
        rank = np.full(mc, -1, dtype=np.int64)
        rank[rows] = np.arange(mb)
        sel = rank[sb] >= 0
        rsel, psel = rank[sb[sel]], pos_p[sel]
        Sb = int(counts_v[rows].max())
        Sb = 1 << (Sb - 1).bit_length() if Sb > 1 else 1
        pair_i = np.zeros((mb, P), dtype=np.int64)
        pair_j = np.zeros((mb, P), dtype=np.int64)
        pvalid = np.zeros((mb, P), dtype=bool)
        pair_i[rsel, psel] = local_of[epi[sel]]
        pair_j[rsel, psel] = local_of[epj[sel]]
        pvalid[rsel, psel] = True
        dvec = np.zeros((mb, P, dd.shape[1]), dtype=dd.dtype)
        dvec[rsel, psel] = dd[epi[sel]] - dd[epj[sel]]
        tau0 = np.sqrt((dvec * dvec).sum(-1)) / 2.0
        r_loc = _sweep_batched(
            *(torch.from_numpy(a).to(device)
              for a in (tau0, pair_i, pair_j, pvalid)), Sb).cpu().numpy()
        vsel = rank[gp] >= 0
        r_A[vsel] = r_loc[rank[gp[vsel]], local_of[vsel]]


def _radii_inner_epilogue(r_A, r_Ac, dd, gp, counts_v, order_v, starts_v,
                          device) -> torch.Tensor:
    """Singletons inherit the parent radius (embed.cpp:707-711); children
    no candidate touched get half the distance to their nearest sibling
    (radii.py:348-368); the radii go to ``device``."""
    singles = counts_v == 1
    if singles.any():
        r_A[order_v[starts_v[:-1][singles]]] = (
            torch.as_tensor(r_Ac).detach().cpu().numpy()[singles])
    untouched = r_A == 0.0
    if untouched.any():
        for b in np.unique(gp[untouched]):
            kids = order_v[starts_v[b]: starts_v[b + 1]]
            if kids.size <= 1:
                continue
            sub = dd[kids]
            d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
            np.fill_diagonal(d2, np.inf)
            nn = np.sqrt(np.maximum(d2.min(axis=1), 0.0)) / 2.0
            need = r_A[kids] == 0.0
            r_A[kids[need]] = nn[need]
    return torch.from_numpy(r_A).to(device)


def renormalize_into_parents(coords_A, r_A, coords_Ac, r_Ac,
                             grandparent: Partition, *, eps: float = 1e-6):
    """Scale children into the parent ball (embed.cpp:757-777):
    alpha_b = max_a (|c_b - c_a| + r_a) over children a of b, clamped at
    eps; c_a <- c_b + (r_b/alpha_b)(c_a - c_b); r_a <- (r_b/alpha_b) r_a."""
    gp = grandparent.vertex_to_agg
    cb = coords_Ac[gp]
    dist = torch.sqrt(torch.sum((coords_A - cb) ** 2, dim=-1))
    alpha = torch.full((grandparent.num_aggs,), float("-inf"),
                       dtype=dist.dtype, device=dist.device)
    alpha = alpha.scatter_reduce(0, gp, dist + r_A, reduce="amax")
    alpha = torch.clamp(alpha, min=eps)
    scale = (r_Ac / alpha)[gp]
    return cb + scale[:, None] * (coords_A - cb), scale * r_A
