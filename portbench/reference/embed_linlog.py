"""Plain reference of the LinLog multilevel embed's base case and
refinement (PyTorch in float64, NumPy for the host tables; imports
nothing of the program).  The radii, the first-collision sweep, the
renormalization, the level seeds and the start are ``embed.py``'s, by
import; the hierarchy and its Galerkin chain are ``hierarchy.py``'s.

* ``base_case``: flat ForceAtlas2 in LinLog mode (forceatlas.hpp:146-269,
  :169-203) on the dense weighted adjacency of the coarsest graph, from
  the program's documented start: repulsion (deg_i + 1)(deg_j + 1) repel
  (x_i - x_j) / d^3 over every pair, attraction w_ij log(1 + d) (x_j -
  x_i) / d over the stored entries (self loops included, where x_j - x_i
  is 0), gravity -(x_i / |x_i|) gravity (deg_i + 1), the adaptive speed
  with the global swing and traction pinned to 1 (:228, :242);
* ``radii_top``: the first-collision radii of the coarsest aggregates,
  over the coarsest graph's edges above ``ALL_PAIRS_UP_TO`` of them;
* ``refine``: forceAtlasMultilevel in LinLog mode (forceatlas.hpp:314-574)
  from the portable route's documented start, U(-1, 1)^dim from a
  generator seeded with the level's seed with row i for vertex i: exact
  repulsion over every ordered pair of members of one aggregate, LinLog
  attraction over the stored entries inside an aggregate (s != r) on the
  folded weights (the level's weights, as use_weights and delta 1 fold
  them), the cut-edge pull, gravity, the eps-clamped swing, then the
  epilogue that places each aggregate in its parent ball.  The member
  pairs run by rows (a vertex and every member of its aggregate), in
  blocks of at most ``PAIR_BLOCK`` pairs cut between rows, so a large
  aggregate needs no [S, S] table; each row's terms are one segment's
  sum.

Departures from forceatlas.hpp, each the program's documented behaviour:
every distance is clamped below at ``epsilon`` before it divides (the
reference divides by d unclamped, so coincident vertices give NaN
there); the base case's weighted degrees count self loops, as the
Galerkin chain's row sums do; above ``ALL_PAIRS_UP_TO`` coarsest
aggregates the radii sweep the coarsest graph's edges and not every pair
(embed.cpp:616-678 sweeps every pair; the program bounds that sweep as
the JAX package does); the per-level seeds and the start are the
program's generators, not ``std::random_device``.

``dtype`` runs a stage in a lower precision (the control).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import embed as E
from portbench.reference.embed import _norm, _speed_update

F64 = torch.float64
#: the most coarsest aggregates whose radii sweep over all their pairs;
#: above it the program sweeps the coarsest graph's edges
ALL_PAIRS_UP_TO = 512
#: the most ordered member pairs one block of the refinement holds
PAIR_BLOCK = 1 << 25


def _dense(s, r, w, n: int, dev) -> torch.Tensor:
    A = torch.zeros((n, n), dtype=F64, device=dev)
    A.index_put_((torch.as_tensor(s, device=dev),
                  torch.as_tensor(r, device=dev)),
                 torch.as_tensor(w, dtype=F64, device=dev), accumulate=True)
    return A


def _base_forces(x, A, dp1, fa: dict):
    """Total force of the flat LinLog iteration at ``x`` [n, d]: dense
    [n, n] distances from the coordinates' differences, and each force
    as x_i sum_j W_ij - (W x)_i."""
    n, d = x.shape
    d2 = (x[:, 0, None] - x[None, :, 0]).square_()
    for k in range(1, d):
        d2 += (x[:, k, None] - x[None, :, k]).square_()
    dist = d2.sqrt_().clamp_(min=fa["epsilon"])
    wr = dist.pow(3).reciprocal_().mul_(dp1[None, :])
    wr.fill_diagonal_(0.0)
    rep = x * wr.sum(1)[:, None] - wr @ x
    del wr
    wa = torch.log1p(dist).div_(dist).mul_(A)
    att = wa @ x - x * wa.sum(1)[:, None]
    mag = torch.clamp(_norm(x), min=1e-30)
    grav = -(x / mag[:, None]) * (fa["gravity"] * dp1)[:, None]
    return fa["repel"] * dp1[:, None] * rep + fa["attract"] * att + grav


def base_case(s, r, w, n: int, x0, iterations: int, fa: dict, *,
              dtype=F64) -> torch.Tensor:
    """``iterations`` flat LinLog steps from ``x0`` [n, d] on the dense
    weighted adjacency of (s, r, w); returns [n, d] in ``dtype``."""
    A = _dense(s, r, w, n, x0.device)
    dp1 = (A.sum(dim=1) + 1.0).to(dtype)
    A = A.to(dtype)
    x = x0.to(dtype)
    f_prev = torch.zeros_like(x)
    for _ in range(iterations):
        f = _base_forces(x, A, dp1, fa)
        x = _speed_update(x, f, f_prev, fa, swing_eps=None)
        f_prev = f
    return x


def radii_top(coords: np.ndarray, s, r) -> np.ndarray:
    """Radii of the coarsest aggregates (float32 [m, d] centres): over
    all pairs up to ``ALL_PAIRS_UP_TO`` aggregates (``embed.radii_top``),
    over the coarsest graph's edges (s < r) above that, with the
    aggregates no edge touches at half the distance to their nearest
    neighbour."""
    m = coords.shape[0]
    if m <= ALL_PAIRS_UP_TO:
        return E.radii_top(coords)
    s, r = np.asarray(s), np.asarray(r)
    keep = s < r
    pi, pj = s[keep], r[keep]
    out = E.sweep(E._tau(coords, pi, pj), pi, pj, m)
    untouched = np.ones(m, bool)
    untouched[pi] = untouched[pj] = False
    if untouched.any():
        out[untouched] = E._half_nn(coords)[untouched]
    return out


def _pair_blocks(v: torch.Tensor, m: int, budget: int):
    """Every ordered pair (i, j) of members of one aggregate, i == j
    included, by rows: [(the rows' vertices, each row's length, the
    members j of each row in turn)] in blocks of at most ``budget``
    pairs (a row is never split)."""
    order = torch.argsort(v, stable=True)
    counts = torch.bincount(v, minlength=m)
    first = torch.cumsum(counts, 0) - counts
    per = counts[v[order]]
    ends = torch.cumsum(per, 0).cpu().numpy()
    blocks, lo = [], 0
    while lo < ends.size:
        base = ends[lo - 1] if lo else 0
        hi = max(int(np.searchsorted(ends, base + budget, side="right")),
                 lo + 1)
        rows, size = order[lo:hi], per[lo:hi]
        start = torch.repeat_interleave(torch.cumsum(size, 0) - size, size)
        off = torch.arange(start.numel(), device=v.device) - start
        cols = order[torch.repeat_interleave(first[v[rows]], size) + off]
        blocks.append((rows, size, cols))
        lo = hi
    return blocks


def _within_repulsion(x, dp1, blocks, eps: float):
    """sum over j != i in agg(i) of dp1_j (x_i - x_j) / max(d_ij, eps)^3,
    each row's terms summed as one segment (x_i - x_i is 0)."""
    rep = torch.zeros_like(x)
    for rows, size, cols in blocks:
        diff = torch.repeat_interleave(x[rows], size, dim=0) - x[cols]
        dd = torch.clamp(_norm(diff), min=eps)
        term = diff * (dp1[cols] / (dd * dd * dd))[:, None]
        rep[rows] = torch.segment_reduce(term, "sum", lengths=size, axis=0)
    return rep


def refine(s, r, w, v2a: np.ndarray, c_parent, r_parent, x0, fa: dict,
           iterations: int, *, dtype=F64,
           pair_block: int = PAIR_BLOCK) -> torch.Tensor:
    """One level's LinLog refinement (see the module's doc): ``x0``
    [n, d] the members' start (row i for vertex i), ``c_parent`` /
    ``r_parent`` the parent balls; returns [n, d] coordinates in
    ``dtype`` on x0's device."""
    dev = x0.device
    n, d = x0.shape
    m = int(r_parent.shape[0])
    eps = fa["epsilon"]

    def t(a, dt=torch.int64):
        return torch.as_tensor(a).to(dev, dt)

    s, r, v = t(s), t(r), t(v2a)
    wt = t(np.asarray(w, np.float64), F64)
    same = v[s] == v[r]
    dp1 = (torch.zeros(n, dtype=F64, device=dev).index_add_(
        0, s[same], wt[same]) + 1.0).to(dtype)
    intra = same & (s != r)
    si, ri, wi = s[intra], r[intra], wt[intra].to(dtype)
    cp = t(c_parent, F64)
    cut = ~same
    dc = cp[v[r[cut]]] - cp[v[s[cut]]]
    dist = torch.clamp(_norm(dc), min=eps)
    pull = torch.zeros((n, d), dtype=F64, device=dev).index_add_(
        0, s[cut], dc * (fa["pull"] / dist)[:, None]).to(dtype)
    del s, r, wt, same, intra, cut, dc, dist
    blocks = _pair_blocks(v, m, pair_block)
    x = x0.to(dtype)
    f_prev = torch.zeros_like(x)
    for _ in range(iterations):
        rep = fa["repel"] * dp1[:, None] * _within_repulsion(
            x, dp1, blocks, eps)
        diff = x[ri] - x[si]
        dd = torch.clamp(_norm(diff), min=eps)
        att = torch.zeros_like(x).index_add_(
            0, si, diff * (wi * torch.log1p(dd) / dd)[:, None])
        mag = torch.clamp(_norm(x), min=eps)
        grav = -(x / mag[:, None]) * (fa["gravity"] * dp1)[:, None]
        f = rep + fa["attract"] * att + pull / mag[:, None] + grav
        x = _speed_update(x, f, f_prev, fa, swing_eps=eps)
        f_prev = f
    counts = torch.bincount(v, minlength=m)
    mean = torch.zeros((m, d), dtype=dtype, device=dev).index_add_(0, v, x)
    mean = mean / torch.clamp(counts, min=1)[:, None].to(dtype)
    centered = x - mean[v]
    norm = _norm(centered)
    mx = torch.full((m,), -np.inf, dtype=dtype, device=dev).scatter_reduce(
        0, v, norm, reduce="amax")
    mx = torch.clamp(mx, min=eps)
    rp = t(r_parent, F64).to(dtype)
    return cp.to(dtype)[v] + (rp / mx)[v][:, None] * centered
