"""Synthetic graph families (numpy cores of graph_embed_tpu/graph/synth.py,
copied so the arrays are identical for the same arguments):

* ``mesh3d`` -- the mesh/roadnet family (roadNet-*, delaunay_n24);
* ``rmat`` -- the social/web power-law family (com-lj, com-youtube);
* ``community_rmat`` -- the same family with community structure, the
  com-lj proxy of the LJ-scale flat step;
* ``ring_of_cliques`` -- the modularity sanity family.

Each returns a symmetrized host ``Graph``; pass ``device`` or call
``Graph.to`` to move it.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import Graph, from_edges


def mesh3d(L: int, *, extra_frac: float = 0.0, seed: int = 0,
           dtype=torch.float32, device="cpu") -> Graph:
    """L^3 3D grid (6-neighborhood) + optional random long-range edges."""
    n = L ** 3
    idx = np.arange(n)
    x, y, z = idx % L, (idx // L) % L, idx // (L * L)
    ss, rr = [], []
    for dx, dy, dz in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        m = (x + dx < L) & (y + dy < L) & (z + dz < L)
        ss.append(idx[m])
        rr.append(idx[m] + dx + dy * L + dz * L * L)
    if extra_frac > 0.0:
        rng = np.random.default_rng(seed)
        n_extra = int(n * extra_frac)
        ss.append(rng.integers(0, n, n_extra))
        rr.append(rng.integers(0, n, n_extra))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    return from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=dtype, device=device)


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0,
         permute: bool = True, compact: bool = True, dtype=torch.float32,
         device="cpu") -> Graph:
    """R-MAT power-law graph (Graph500 defaults): n = 2^scale vertices,
    ~n*edge_factor directed draws, symmetrized and deduplicated;
    ``permute`` shuffles ids, ``compact`` drops isolated vertices."""
    n = 1 << scale
    E = n * edge_factor
    rng = np.random.default_rng(seed)
    s = np.zeros(E, dtype=np.int64)
    r = np.zeros(E, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for _ in range(scale):
        u = rng.random(E)
        sbit = u >= ab
        rbit = ((u >= a) & (u < ab)) | (u >= abc)
        s = (s << 1) | sbit
        r = (r << 1) | rbit
    if permute:
        perm = rng.permutation(n)
        s, r = perm[s], perm[r]
    keep = s != r
    s, r = s[keep], r[keep]
    if compact:
        used = np.zeros(n, dtype=bool)
        used[s] = True
        used[r] = True
        relabel = np.cumsum(used) - 1
        s, r, n = relabel[s], relabel[r], int(used.sum())
    return from_edges(s, r, None, n=n, symmetrize=True, dtype=dtype,
                      device=device)


def community_rmat(num_communities: int, scale: int, edge_factor: int = 8,
                   *, inter_frac: float = 0.05, seed: int = 0,
                   dtype=torch.float32, device="cpu") -> Graph:
    """Clustered power-law graph: ``num_communities`` (a power of two)
    independent R-MAT blocks of ``2**scale / num_communities`` vertices,
    each with its ids permuted inside the block, plus uniform random
    inter-community edges (``inter_frac`` of the intra draws).  Vertices
    come community-sorted, the order a partition order would give.  The
    numpy stream is the reference's, so one seed gives the same COO."""
    rng = np.random.default_rng(seed)
    lg = max(num_communities.bit_length() - 1, 0)
    if (1 << lg) != num_communities:
        raise ValueError("num_communities must be a power of two")
    scale_c = scale - lg
    if scale_c < 1:
        raise ValueError(f"scale {scale} too small for "
                         f"{num_communities} communities")
    m = 1 << scale_c
    ss, rr = [], []
    E_c = m * edge_factor
    ab, abc = 0.57 + 0.19, 0.57 + 0.19 + 0.19
    for c in range(num_communities):
        s = np.zeros(E_c, dtype=np.int64)
        r = np.zeros(E_c, dtype=np.int64)
        for _ in range(scale_c):
            u = rng.random(E_c)
            s = (s << 1) | (u >= ab)
            r = (r << 1) | (((u >= 0.57) & (u < ab)) | (u >= abc))
        perm = rng.permutation(m)
        ss.append(c * m + perm[s])
        rr.append(c * m + perm[r])
    n = num_communities * m
    n_inter = int(num_communities * E_c * inter_frac)
    ss.append(rng.integers(0, n, n_inter))
    rr.append(rng.integers(0, n, n_inter))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    return from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                      dtype=dtype, device=device)


def ring_of_cliques(num_cliques: int, clique_size: int, *,
                    dtype=torch.float32, device="cpu") -> Graph:
    """num_cliques K_{clique_size} cliques joined in a ring by single edges."""
    K, C = clique_size, num_cliques
    ss, rr = [], []
    i, j = np.triu_indices(K, 1)
    for c in range(C):
        base = c * K
        ss.append(base + i)
        rr.append(base + j)
        ss.append(np.array([base]))
        rr.append(np.array([((c + 1) % C) * K]))
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    return from_edges(s, r, None, n=C * K, symmetrize=True, dtype=dtype,
                      device=device)
