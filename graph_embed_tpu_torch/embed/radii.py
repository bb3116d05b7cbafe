"""Aggregate ball radii: the ball-growing / first-collision sweep
(src/embed.cpp:616-678 top level over all pairs, :680-756 inner levels over
coarse-graph edges within one grandparent), and the renormalization of
children into their parent balls (:757-777).

Counterpart of graph_embed_tpu/embed/radii.py.  Every sweep runs on the
host in the native C++ heap (native/sweep.cpp), which is bit-identical to
the reference's Python heap (radii.py:84-150): pop the alive pair of least
(tau, pair index); unassigned endpoints get tau; alive pairs touching a
newly assigned vertex move to 2 tau - tau_popped.  The centres are pulled
to the host ([m, d], small); the radii go back to the centres' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import Graph
from ..native import sweep_lib
from ..partition.interpolation import Partition


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
                coarse_graph: Graph, grandparent: Partition) -> torch.Tensor:
    """Inner-level radii (embed.cpp:680-756): per grandparent aggregate,
    the candidates are coarse-graph edges (a < j) inside it; every
    grandparent sweeps in one batched native call.  Singletons inherit the
    parent radius (:707-711); children no candidate touches get half the
    distance to their nearest sibling."""
    dd = coords_A.detach().cpu().numpy()
    m = dd.shape[0]
    gp = grandparent.vertex_to_agg_numpy()
    mc = grandparent.num_aggs
    s, r, _ = coarse_graph.to_coo_numpy()
    keep = (s < r) & (gp[s] == gp[r])
    es, er = s[keep], r[keep]

    order_v = np.argsort(gp, kind="stable")
    counts_v = np.bincount(gp, minlength=mc)
    starts_v = np.concatenate([[0], np.cumsum(counts_v)])
    local_of = np.zeros(m, dtype=np.int64)
    local_of[order_v] = np.arange(m) - starts_v[gp[order_v]]

    r_A = np.zeros(m, dtype=dd.dtype)
    if es.size:
        b_of_pair = gp[es]
        order_p = np.argsort(b_of_pair, kind="stable")
        starts_p = np.concatenate(
            [[0], np.cumsum(np.bincount(b_of_pair, minlength=mc))])
        dv = dd[es[order_p]] - dd[er[order_p]]
        tau0 = (np.sqrt((dv * dv).sum(-1)) / 2.0).astype(dd.dtype)
        r_A[order_v] = sweep_lib.sweep_batch(
            tau0, local_of[es[order_p]], local_of[er[order_p]], starts_p,
            starts_v)

    singles = counts_v == 1
    if singles.any():
        r_A[order_v[starts_v[:-1][singles]]] = (
            r_Ac.detach().cpu().numpy()[singles])
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
    return torch.from_numpy(r_A).to(coords_A.device)


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
