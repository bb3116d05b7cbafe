"""Stress-style coordinate-descent embedder (``embedViaMinimization``,
src/embed.cpp:341-559).

Counterpart of graph_embed_tpu/embed/minimization.py.  Cyclic coordinate
descent on
    J_i = sum_{r != i} 1/|x_i - x_r| + W_EDGE sum_{edges (i,r)} |x_i - x_r|^2
with W_EDGE = 1e6 (:410).  For each vertex, a line search along each of
the 2d axis directions by 12 bisections on dJ/dt (:415-459: the jump 0.25
halved until <= 1e-4), then the best direction and step (:490-523).

The sweep is Gauss-Seidel (each update is seen by the next vertex), so it
is a Python loop over vertices; the 2d directions and the O(n) sums run as
tensor ops inside.  It is launch-bound on the card.  The final normalize
keeps the reference's quirk of averaging over vertices 1..n-1 only
(:531-537, :546-551).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import Graph
from ..utils.device import resolve

W_EDGE = 1.0e6          # src/embed.cpp:410
EPS_TERM = 10e-12       # src/embed.cpp:349 (1e-11)
N_BISECT = 12           # 0.25 halved until <= 1e-4 (:417, :457-459)


def axis_dirs(d: int, *, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """[2d, d]: +e_0, -e_0, +e_1, -e_1, ..."""
    dirs = torch.zeros((2 * d, d), dtype=dtype, device=device)
    for k in range(d):
        dirs[2 * k, k] = 1.0
        dirs[2 * k + 1, k] = -1.0
    return dirs


def _update_vertex(coords, i: int, nbrs, dirs) -> None:
    """One vertex's line searches along every direction at once, and the
    best step written into ``coords`` in place."""
    x_i = coords[i]
    u = dirs - x_i                                        # [2d, d]
    v = x_i - coords                                      # [n, d]
    others = torch.ones(coords.shape[0], dtype=torch.bool,
                        device=coords.device)
    others[i] = False
    xr = coords[nbrs]                                     # [k, d]
    t = torch.full((dirs.shape[0],), 0.5, dtype=coords.dtype,
                   device=coords.device)
    jump = 0.25

    def along(t):
        z = t[:, None, None] * u[:, None, :] + v[None]    # [2d, n, d]
        term1 = torch.clamp(torch.sum(z * z, dim=2), min=EPS_TERM)
        za = ((1.0 - t)[:, None, None] * x_i + t[:, None, None]
              * dirs[:, None, :] - xr[None])              # [2d, k, d]
        return z, term1, za

    for _ in range(N_BISECT):
        z, term1, za = along(t)
        rep = -(term1 ** -1.5) * torch.sum(z * u[:, None, :], dim=2)
        rep = torch.where(others[None], rep, torch.zeros_like(rep))
        att = W_EDGE * 2.0 * torch.sum(za * u[:, None, :], dim=2)
        grad = torch.sum(rep, dim=1) + torch.sum(att, dim=1)
        t = torch.where(grad < 0.0, t + jump, t - jump)
        jump /= 2.0
    z, term1, za = along(t)
    contrib = torch.where(others[None], 1.0 / torch.sqrt(term1),
                          torch.zeros_like(term1))
    J = torch.sum(contrib, dim=1) + W_EDGE * torch.sum(za * za, dim=(1, 2))
    best = torch.argmin(J)
    t_best = t[best]
    coords[i] = x_i * (1.0 - t_best) + dirs[best] * t_best


def embed_via_minimization(g: Graph, dim: int, *, coords=None,
                           iterations: int = 1000, seed: int = 0,
                           device="cuda") -> torch.Tensor:
    """Flat minimization embedder on ``device`` (the card unless asked for
    the CPU); ``iterations`` sweeps (the reference overload's 1000,
    src/embed.cpp:341-345).  Starts at ``coords`` or U(-1, 1)^dim from a
    generator seeded with ``seed``.  Vertices with no neighbour but
    themselves stay put (:400-406)."""
    dev = resolve(device)
    g = g.to(dev)
    if coords is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        coords = torch.rand((g.n, dim), generator=gen, dtype=g.dtype,
                            device=dev) * 2.0 - 1.0
    else:
        coords = torch.as_tensor(coords).to(dev, g.dtype).clone()
    s, r, _ = g.to_coo_numpy()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=g.n))])
    nbrs = []
    for i in range(g.n):
        row = r[indptr[i]:indptr[i + 1]]
        row = row[row != i]
        nbrs.append(torch.from_numpy(row).to(dev) if row.size else None)
    dirs = axis_dirs(dim, dtype=g.dtype, device=dev)
    for _ in range(iterations):
        for i in range(g.n):
            if nbrs[i] is not None:
                _update_vertex(coords, i, nbrs[i], dirs)
    n = g.n
    if n > 1:
        # the reference's normalize over vertices 1..n-1; a zero max
        # (n == 2) is clamped where the reference divides by it
        coords = coords - torch.sum(coords[1:], dim=0) / (n - 1)
        max_len = torch.max(torch.sqrt(torch.sum(coords[1:] ** 2, dim=1)))
        coords = coords / torch.clamp(max_len, min=1e-30)
    return coords
