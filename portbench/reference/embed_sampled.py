"""Plain reference of one level's slot-space refinement where aggregates of
a large size class take the sampled within-aggregate repulsion (PyTorch
in float64 where it can; imports nothing of the program and no JAX).

Size classes are ``embed.slot_rows``'s: max(8, the next power of two of
the member count).  An aggregate whose class reaches ``threshold``
(0: none) feels, in place of the exact member-against-member sum, the
per-aggregate negative-sampling estimator (the JAX package's
multilevel_tiled.py:496-536; the exact sum in expectation):

    rep_i = repel (deg_i + 1) (cnt_a / K)
            sum_k (deg_j + 1) (x_i - x_j) / max(|x_i - x_j|, eps)^3

over K partners, partner k of aggregate a being its member idx[a, k] =
floor(u[a, k] cnt_a) (members in increasing vertex id; the product taken
in float32, as the program documents its partners, and held below
cnt_a), and the term of a partner that is i itself left out.

The uniforms u come from the level's generator in the program's
documented order: the start's [slots, d] rows first (``embed.slot_rows``;
each member starts at its slot's row), then in every iteration one [m_c,
K] float32 draw per sampled class, the smallest class first, its
aggregates in id order.  A ``torch.Generator`` on the program's device
seeded with the program's level seed gives the program's numbers.

Aggregates never act on one another in a refinement: each feels its own
members, its own intra-aggregate edges, a fixed pull toward the parent
centres across its cut edges, and gravity.  So the aggregates below the
threshold are refined by ``embed.refine``'s exact pairs on their own, a
group of them at a time (each cut edge leaving a group ends at one
stand-in vertex per aggregate outside it, which only gives the pull its
parent centre), and the sampled aggregates by the same iteration with
the estimator in place of the pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import embed as E

F64 = torch.float64
# members whose partners are evaluated at once
ROW_BLOCK = 1 << 14
# ordered member pairs of the exact aggregates refined at once
PAIR_BLOCK = 1 << 27


def size_classes(counts: np.ndarray) -> np.ndarray:
    """Each aggregate's size class: max(8, next power of two)."""
    return np.maximum(8, 1 << np.ceil(np.log2(np.maximum(counts, 1)))
                      .astype(np.int64))


def partners(u: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[A, K] member ranks of the partners drawn by the float32 uniforms
    ``u`` [A, K] for aggregates of ``counts`` [A] members."""
    cnt = counts.to(torch.float32)
    return torch.minimum((u * cnt[:, None]).long(),
                         torch.clamp(counts - 1, min=0)[:, None])


def sampled_repulsion(x, dp1, agg, rank, first, counts, u, repel: float,
                      eps: float) -> torch.Tensor:
    """[N, d] estimator of the repulsion on N members (in ``x``'s dtype):
    member i is of aggregate ``agg[i]`` (a row of ``u`` [A, K], ``first``
    [A], ``counts`` [A]) and has rank ``rank[i]`` among its members, which
    are the rows first[a] .. first[a] + counts[a] - 1 of ``x`` [N, d] and
    ``dp1`` [N] (deg + 1)."""
    K = u.shape[1]
    idx = partners(u, counts)
    out = torch.empty_like(x)
    for b0 in range(0, x.shape[0], ROW_BLOCK):
        a = agg[b0: b0 + ROW_BLOCK]
        ib = idx[a]                                   # [B, K]
        pj = first[a][:, None] + ib
        diff = x[b0: b0 + ROW_BLOCK, None, :] - x[pj]  # [B, K, d]
        dist = torch.clamp(E._norm(diff), min=eps)
        wk = (dp1[pj] / (dist * dist * dist)).masked_fill(
            ib == rank[b0: b0 + ROW_BLOCK, None], 0.0)
        scale = counts[a].to(x.dtype) / K
        out[b0: b0 + ROW_BLOCK] = (repel * dp1[b0: b0 + ROW_BLOCK] * scale)[
            :, None] * torch.einsum("bkd,bk->bd", diff, wk)
    return out


def _with_stand_ins(s, r, w, v2a, members: np.ndarray):
    """The entries sent by ``members`` (vertex ids) relabelled for a
    refinement of their aggregates alone: a member is its position in
    ``members``, any other vertex the stand-in of its aggregate (rows
    after the members, one per aggregate outside).  Returns (s, r, w,
    v2a of members and stand-ins)."""
    n = v2a.size
    local = np.full(n, -1, np.int64)
    local[members] = np.arange(members.size)
    keep = local[s] >= 0
    s, r, w = s[keep], r[keep], np.asarray(w)[keep]
    out_aggs, stand_in = np.unique(v2a[r[local[r] < 0]],
                                   return_inverse=True)
    rl = local[r]
    rl[rl < 0] = members.size + stand_in
    return (local[s], rl, w,
            np.concatenate([v2a[members], out_aggs]).astype(np.int64))


def refine(s, r, w, v2a: np.ndarray, c_parent, r_parent, seed: int,
           dim: int, fa: dict, iterations: int, *, threshold: int,
           samples: int, device, dtype=F64) -> torch.Tensor:
    """One level's refinement (see the module's doc) of the graph (s, r,
    w) under the partition ``v2a`` into the parent balls (``c_parent``,
    ``r_parent``), from the level's generator seed ``seed``; returns [n,
    dim] coordinates in ``dtype`` on ``device``."""
    dev = torch.device(device)
    s, r, v2a = (np.asarray(a, np.int64) for a in (s, r, v2a))
    m, n = int(np.asarray(r_parent).shape[0]), v2a.size
    counts = np.bincount(v2a, minlength=m)
    S = size_classes(counts)
    sampled = (S >= threshold) if threshold > 0 else np.zeros(m, bool)
    rows, n_rows = E.slot_rows(v2a, m)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    x0 = (torch.rand((n_rows, dim), generator=gen, dtype=torch.float32,
                     device=dev) * 2.0 - 1.0)[torch.from_numpy(rows).to(dev)]
    classes = [np.flatnonzero(sampled & (S == c))
               for c in np.unique(S[sampled])]
    draws = [[torch.rand((aggs.size, samples), generator=gen,
                         dtype=torch.float32, device=dev)
              for aggs in classes] for _ in range(iterations)]
    out = torch.empty((n, dim), dtype=dtype, device=dev)
    # the exact aggregates in groups of at most PAIR_BLOCK member pairs
    exact = np.flatnonzero(~sampled & (counts > 0))
    group = np.full(m, -1, np.int64)
    group[exact] = np.cumsum(counts[exact] * (counts[exact] - 1)) \
        // PAIR_BLOCK
    for gid in np.unique(group[exact]):
        mine = np.flatnonzero(group[v2a] == gid)
        es, er, ew, ev = _with_stand_ins(s, r, w, v2a, mine)
        start = torch.zeros((ev.size, dim), dtype=torch.float32, device=dev)
        start[: mine.size] = x0[torch.from_numpy(mine).to(dev)]
        out[torch.from_numpy(mine).to(dev)] = E.refine(
            es, er, ew, ev, c_parent, r_parent, start, fa, iterations,
            dtype=dtype)[: mine.size]
    hub = np.flatnonzero(sampled[v2a])
    if hub.size:
        out[torch.from_numpy(hub).to(dev)] = _refine_sampled(
            s, r, w, v2a, hub, classes, draws, c_parent, r_parent,
            x0[torch.from_numpy(hub).to(dev)], fa, dtype)
    return out


def _refine_sampled(s, r, w, v2a, hub, classes, draws, c_parent, r_parent,
                    x0, fa: dict, dtype) -> torch.Tensor:
    """``embed.refine``'s iteration and epilogue over the members ``hub``
    of the sampled aggregates, with the estimator as their repulsion."""
    dev = x0.device
    eps = fa["epsilon"]
    t = (lambda a, dt=torch.int64: torch.as_tensor(a).to(dev, dt))
    n = v2a.size
    local = np.full(n, -1, np.int64)
    local[hub] = np.arange(hub.size)
    keep = local[s] >= 0
    s, r, w = s[keep], r[keep], np.asarray(w, np.float64)[keep]
    same = v2a[s] == v2a[r]
    nh, d = x0.shape
    deg = torch.zeros(nh, dtype=F64, device=dev).index_add_(
        0, t(local[s[same]]), t(w[same], F64)).to(dtype)
    intra = same & (s != r)
    wi = t(E._truncate_bf16(w[intra]), F64).to(dtype)
    si, ri = t(local[s[intra]]), t(local[r[intra]])
    deg_w = torch.zeros(nh, dtype=dtype, device=dev).index_add_(0, si, wi)
    cp = t(c_parent, F64)
    cut = ~same
    dc = cp[t(v2a[r[cut]])] - cp[t(v2a[s[cut]])]
    dist = torch.clamp(E._norm(dc), min=eps)
    pull = torch.zeros((nh, d), dtype=F64, device=dev).index_add_(
        0, t(local[s[cut]]), dc * (fa["pull"] / dist)[:, None]).to(dtype)
    # the members by (aggregate in draw order, vertex id); each member's
    # row among the drawn aggregates and its rank in its aggregate
    aggs = np.concatenate(classes)
    row_of = np.full(int(v2a.max()) + 1, -1, np.int64)
    row_of[aggs] = np.arange(aggs.size)
    order = np.lexsort((hub, row_of[v2a[hub]]))
    cnt = np.bincount(v2a, minlength=row_of.size)[aggs]
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    agg_o = row_of[v2a[hub[order]]]
    rank = np.arange(hub.size) - first[agg_o]
    perm = t(order)
    dp1 = (deg + 1.0)[perm]
    x = x0.to(dtype)[perm]
    pull, deg_w = pull[perm], deg_w[perm]
    back = torch.empty_like(perm)
    back[perm] = torch.arange(nh, device=dev)
    si, ri = back[si], back[ri]
    agg_t, rank_t, first_t, cnt_t = t(agg_o), t(rank), t(first), t(cnt)
    f_prev = torch.zeros_like(x)
    for us in draws:
        rep = sampled_repulsion(x, dp1, agg_t, rank_t, first_t, cnt_t,
                                torch.cat(us), fa["repel"], eps)
        att = torch.zeros_like(x).index_add_(0, si, wi[:, None] * x[ri])
        att = fa["attract"] * (att - x * deg_w[:, None])
        mag = torch.clamp(E._norm(x), min=eps)
        grav = -(x / mag[:, None]) * (fa["gravity"] * dp1)[:, None]
        f = rep + att + pull / mag[:, None] + grav
        x = E._speed_update(x, f, f_prev, fa, swing_eps=eps)
        f_prev = f
    A = aggs.size
    mean = torch.zeros((A, d), dtype=dtype, device=dev).index_add_(
        0, agg_t, x) / cnt_t[:, None].to(dtype)
    centered = x - mean[agg_t]
    mx = torch.full((A,), -np.inf, dtype=dtype, device=dev).scatter_reduce(
        0, agg_t, E._norm(centered), reduce="amax")
    mx = torch.clamp(mx, min=eps)
    ids = t(aggs)
    rp = t(r_parent, F64).to(dtype)[ids]
    placed = cp.to(dtype)[ids][agg_t] + (rp / mx)[agg_t][:, None] * centered
    return placed[back]
