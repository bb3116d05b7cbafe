"""Plain reference of the multilevel embed's stages after the hierarchy
(PyTorch in float64 where it can, NumPy for the sweeps; imports nothing
of the program).  Each stage runs from the inputs the program's stage
had (its predecessor's outputs, as the program reported them) on the
Galerkin chain worked out by ``hierarchy.galerkin``:

* ``base_case``: flat ForceAtlas2 with exact repulsion on the coarsest
  graph (forceatlas.hpp:146-269), from the program's documented start
  (U(-1, 1)^dim from a ``torch.Generator`` on the device seeded with the
  level's seed, ``level_seeds``);
* ``radii_top`` / ``radii_inner``: the first-collision sweep
  (embed.cpp:616-756) over all pairs of the coarsest aggregates, or over
  the coarse edges inside each grandparent; pop the alive pair of least
  (tau, pair index), unassigned endpoints get tau, alive pairs touching a
  newly assigned vertex move to 2 tau - tau_popped; all in float32, as
  the program's sweep is specified; singletons inherit the parent radius,
  untouched children get half the distance to their nearest sibling;
* ``renormalize``: children scaled into their parent balls
  (embed.cpp:757-777);
* ``refine``: forceAtlasMultilevel (forceatlas.hpp:314-574), 100
  iterations from the program's documented start (each aggregate's
  members at the rows of U(-1, 1)^dim, drawn for its slot layout, that
  the layout gives them: size classes max(8, next power of two), smallest
  class first, ids ascending, members in vertex order), with exact
  within-aggregate repulsion, intra-aggregate attraction on the folded
  weights truncated to bf16 as the port's packer stores them, the cut-edge
  pull, gravity, the eps-clamped swing, then the epilogue that places
  each aggregate in its parent ball.

``dtype`` runs a stage in a lower precision (the control).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

F64 = torch.float64


def level_seeds(seed: int, k: int) -> dict:
    """Per-level generator seeds of an embed of k + 1 levels, as the
    program derives them up front from its seed."""
    states = np.random.SeedSequence(int(seed)).generate_state(k + 1,
                                                              np.uint32)
    return {l: int(states[k - l]) for l in range(k + 1)}


def uniform_start(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((rows, dim), generator=gen, dtype=torch.float32,
                      device=device) * 2.0 - 1.0


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def base_case(s, r, w, n: int, x0, iterations: int, fa: dict, *,
              dtype=F64) -> torch.Tensor:
    """``iterations`` flat ForceAtlas steps from ``x0`` [n, d] on the
    dense weighted adjacency of (s, r, w); returns [n, d] in ``dtype``."""
    dev = x0.device
    A = torch.zeros((n, n), dtype=F64, device=dev)
    A.index_put_((torch.as_tensor(s, device=dev),
                  torch.as_tensor(r, device=dev)),
                 torch.as_tensor(w, dtype=F64, device=dev), accumulate=True)
    deg = A.sum(dim=1).to(dtype)
    A = A.to(dtype)
    dp1 = deg + 1.0
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    x = x0.to(dtype)
    f_prev = torch.zeros_like(x)
    eps, repel = fa["epsilon"], fa["repel"]
    for _ in range(iterations):
        diff = x[:, None, :] - x[None, :, :]
        dist = torch.clamp(_norm(diff), min=eps)
        wr = (dp1[None, :] / (dist * dist * dist)).masked_fill(eye, 0.0)
        rep = (repel * dp1)[:, None] * torch.einsum("ijk,ij->ik", diff, wr)
        att = fa["attract"] * (A @ x - deg[:, None] * x)
        mag = torch.clamp(_norm(x), min=1e-30)
        grav = -(x / mag[:, None]) * (fa["gravity"] * dp1)[:, None]
        f = rep + att + grav
        x = _speed_update(x, f, f_prev, fa, swing_eps=None)
        f_prev = f
    return x


def _speed_update(x, f, f_prev, fa: dict, swing_eps):
    swing = _norm(f - f_prev)
    if swing_eps is not None:
        swing = torch.clamp(swing, min=swing_eps)
    tol = fa["tolerate"]
    speed = fa["ks"] * tol / (1.0 + tol * torch.sqrt(swing))
    total = _norm(f)
    bound = torch.where(total > 0, fa["ksmax"] / torch.clamp(total,
                                                             min=1e-30),
                        torch.full_like(total, float("inf")))
    return x + f * torch.minimum(speed, bound)[:, None]


def sweep(tau0: np.ndarray, pi: np.ndarray, pj: np.ndarray,
          m: int) -> np.ndarray:
    """First-collision radii of ``m`` vertices over pairs (pi, pj) with
    initial times ``tau0`` (float32 arithmetic throughout)."""
    tau = tau0.astype(np.float32).copy()
    r = np.zeros(m, np.float32)
    assigned = np.zeros(m, bool)
    alive = np.ones(tau.size, bool)
    inc = [[] for _ in range(m)]
    for k, (a, b) in enumerate(zip(pi.tolist(), pj.tolist())):
        inc[a].append(k)
        inc[b].append(k)
    heap = [(float(t), k) for k, t in enumerate(tau.tolist())]
    heapq.heapify(heap)
    two = np.float32(2.0)
    while heap:
        t, k = heapq.heappop(heap)
        if not alive[k] or t != float(tau[k]):
            continue
        alive[k] = False
        newly = [v for v in (int(pi[k]), int(pj[k])) if not assigned[v]]
        for v in newly:
            r[v] = tau[k]
            assigned[v] = True
        tpop = tau[k]
        for kk in sorted({kk for v in newly for kk in inc[v]}):
            if alive[kk]:
                tau[kk] = two * tau[kk] - tpop
                heapq.heappush(heap, (float(tau[kk]), kk))
    return r


def _tau(c: np.ndarray, pi, pj) -> np.ndarray:
    dv = c[pi] - c[pj]
    return (np.sqrt((dv * dv).sum(-1)) / np.float32(2.0)).astype(np.float32)


def _half_nn(c: np.ndarray) -> np.ndarray:
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return (np.sqrt(np.maximum(d2.min(axis=1), 0.0)) / 2.0).astype(
        np.float32)


def radii_top(coords: np.ndarray) -> np.ndarray:
    """Radii of the coarsest aggregates (float32 [m, d] centres), over
    all pairs."""
    m = coords.shape[0]
    if m <= 1:
        return np.ones(m, np.float32)
    pi, pj = np.triu_indices(m, k=1)
    return sweep(_tau(coords, pi, pj), pi, pj, m)


def radii_inner(coords: np.ndarray, r_parent: np.ndarray, s, r,
                gp: np.ndarray) -> np.ndarray:
    """Radii of a level's aggregates (float32 [m, d] centres) over the
    coarse edges (s, r) (sorted by (s, r)) inside each grandparent
    ``gp`` [m]."""
    m = coords.shape[0]
    keep = (s < r) & (gp[s] == gp[r])
    es, er = s[keep], r[keep]
    out = np.zeros(m, np.float32)
    order_p = np.argsort(gp[es], kind="stable")
    order_v = np.argsort(gp, kind="stable")
    counts_v = np.bincount(gp, minlength=r_parent.size)
    starts_v = np.concatenate([[0], np.cumsum(counts_v)])
    pair_b = gp[es][order_p]
    starts_p = np.searchsorted(pair_b, np.arange(r_parent.size + 1))
    local = np.zeros(m, np.int64)
    local[order_v] = np.arange(m) - starts_v[gp[order_v]]
    for b in np.flatnonzero(starts_p[1:] > starts_p[:-1]):
        pk = order_p[starts_p[b]:starts_p[b + 1]]
        kids = order_v[starts_v[b]:starts_v[b + 1]]
        rl = sweep(_tau(coords, es[pk], er[pk]), local[es[pk]],
                   local[er[pk]], kids.size)
        out[kids] = rl[local[kids]]
    singles = counts_v == 1
    out[order_v[starts_v[:-1][singles]]] = r_parent[singles]
    for b in np.unique(gp[out == 0.0]):
        kids = order_v[starts_v[b]:starts_v[b + 1]]
        if kids.size > 1:
            need = out[kids] == 0.0
            out[kids[need]] = _half_nn(coords[kids])[need]
    return out


def renormalize(c, r, c_parent, r_parent, gp, eps: float = 1e-6):
    """Children (c [m, d], r [m]) scaled into their parents' balls
    (c_parent, r_parent) over the grandparent map ``gp``; float64."""
    c, r, cp, rp = (torch.as_tensor(a, dtype=F64) for a in
                    (c, r, c_parent, r_parent))
    gp = torch.as_tensor(gp)
    cb = cp[gp]
    dist = _norm(c - cb)
    alpha = torch.full((rp.shape[0],), -np.inf, dtype=F64).scatter_reduce(
        0, gp, dist + r, reduce="amax")
    scale = (rp / torch.clamp(alpha, min=eps))[gp]
    return cb + scale[:, None] * (c - cb), scale * r


def slot_rows(v2a: np.ndarray, m: int) -> tuple[np.ndarray, int]:
    """(each vertex's row of the refinement's start, the rows drawn)."""
    counts = np.bincount(v2a, minlength=m)
    S = np.maximum(8, 1 << np.ceil(np.log2(np.maximum(counts, 1)))
                   .astype(np.int64))
    order = np.lexsort((np.arange(m), S))
    start = np.zeros(m, np.int64)
    start[order] = np.concatenate([[0], np.cumsum(S[order])[:-1]])
    order_v = np.argsort(v2a, kind="stable")
    vstart = np.concatenate([[0], np.cumsum(counts)])
    rows = np.zeros(v2a.size, np.int64)
    rows[order_v] = (start[v2a[order_v]] + np.arange(v2a.size)
                     - vstart[v2a[order_v]])
    return rows, int(S.sum())


def _truncate_bf16(w: np.ndarray) -> np.ndarray:
    bits = np.asarray(w, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def refine(s, r, w, v2a: np.ndarray, c_parent, r_parent, x0, fa: dict,
           iterations: int, *, dtype=F64) -> torch.Tensor:
    """One level's refinement (see the module's doc): ``x0`` [n, d] the
    members' start, ``c_parent``/``r_parent`` the parent balls; returns
    [n, d] coordinates in ``dtype`` on x0's device."""
    dev = x0.device
    n, d = x0.shape
    m = int(r_parent.shape[0])
    eps = fa["epsilon"]
    t = (lambda a, dt=torch.int64: torch.as_tensor(a).to(dev, dt))
    s, r, v = t(s), t(r), t(v2a)
    w = np.asarray(w, np.float64)
    same = v[s] == v[r]
    deg = torch.zeros(n, dtype=F64, device=dev).index_add_(
        0, s[same], t(w, F64)[same]).to(dtype)
    intra = same & (s != r)
    wi = t(_truncate_bf16(w), F64)[intra].to(dtype)
    si, ri = s[intra], r[intra]
    deg_w = torch.zeros(n, dtype=dtype, device=dev).index_add_(0, si, wi)
    cp = t(c_parent, F64)
    cut = ~same
    dc = cp[v[r[cut]]] - cp[v[s[cut]]]
    dist = torch.clamp(_norm(dc), min=eps)
    pull = torch.zeros((n, d), dtype=F64, device=dev).index_add_(
        0, s[cut], dc * (fa["pull"] / dist)[:, None]).to(dtype)
    order = torch.argsort(v, stable=True)
    counts = torch.bincount(v, minlength=m)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - first[v[order]]
    # every ordered pair (i, j), i != j, of one aggregate
    cnt_i = counts[v[order]]
    pi = torch.repeat_interleave(order, cnt_i)
    base = torch.repeat_interleave(first[v[order]], cnt_i)
    off = torch.arange(int(cnt_i.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(cnt_i, 0) - cnt_i, cnt_i)
    pj = order[base + off]
    keep = pi != pj
    pi, pj = pi[keep], pj[keep]
    del pos, base, off
    dp1 = deg + 1.0
    x = x0.to(dtype)
    f_prev = torch.zeros_like(x)
    for _ in range(iterations):
        diff = x[pi] - x[pj]
        dd = torch.clamp(_norm(diff), min=eps)
        rep = torch.zeros_like(x).index_add_(
            0, pi, diff * (dp1[pj] / (dd * dd * dd))[:, None])
        rep = fa["repel"] * dp1[:, None] * rep
        att = torch.zeros_like(x).index_add_(0, si, wi[:, None] * x[ri])
        att = fa["attract"] * (att - x * deg_w[:, None])
        mag = torch.clamp(_norm(x), min=eps)
        grav = -(x / mag[:, None]) * (fa["gravity"] * dp1)[:, None]
        f = rep + att + pull / mag[:, None] + grav
        x = _speed_update(x, f, f_prev, fa, swing_eps=eps)
        f_prev = f
    mean = torch.zeros((m, d), dtype=dtype, device=dev).index_add_(0, v, x)
    mean = mean / torch.clamp(counts, min=1)[:, None].to(dtype)
    centered = x - mean[v]
    norm = _norm(centered)
    mx = torch.full((m,), -np.inf, dtype=dtype, device=dev).scatter_reduce(
        0, v, norm, reduce="amax")
    mx = torch.clamp(mx, min=eps)
    rp = t(r_parent, F64).to(dtype)
    return cp.to(dtype)[v] + (rp / mx)[v][:, None] * centered
