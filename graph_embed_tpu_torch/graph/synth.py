"""Synthetic graph families (numpy cores of graph_embed_tpu/graph/synth.py,
copied so the arrays are identical for the same arguments):

* ``mesh3d`` -- the mesh/roadnet family (roadNet-*, delaunay_n24);
* ``rmat`` -- the social/web power-law family (com-lj, com-youtube);
* ``community_rmat`` -- the same family with community structure, the
  com-lj proxy of the LJ-scale flat step;
* ``planted_partition`` -- ground-truth community graphs (email-Eu-core
  with its .cmty labels);
* ``ring_of_cliques`` -- the modularity sanity family.

Each returns a symmetrized host ``Graph``; pass ``device`` or call
``Graph.to`` to move it.  ``cached`` keeps a generated graph's canonical
COO on disk, in the package's build directory unless told otherwise.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from .csr import Graph, from_canonical_coo, from_edges

_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "synth")


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


def planted_partition(num_communities: int, size: int, *, p_in: float = 0.3,
                      p_out: float = 0.01, seed: int = 0,
                      dtype=torch.float32, device="cpu"):
    """Planted-partition (SBM) graph with ground-truth labels: (graph,
    labels[n]), the stand-in for graphs with ``.cmty`` ground truth
    (run-tests.cpp:302-349).  The numpy stream is the reference's."""
    n = num_communities * size
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(num_communities), size)
    ss, rr = [], []
    for k in range(num_communities):
        base = k * size
        m_in = rng.binomial(size * (size - 1) // 2, p_in)
        i = rng.integers(0, size, m_in)
        j = rng.integers(0, size, m_in)
        ss.append(base + i)
        rr.append(base + j)
    m_out = rng.binomial(n * (n - 1) // 2, p_out)
    i = rng.integers(0, n, m_out)
    j = rng.integers(0, n, m_out)
    keep = labels[i] != labels[j]
    ss.append(i[keep])
    rr.append(j[keep])
    s = np.concatenate(ss)
    r = np.concatenate(rr)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                   dtype=dtype, device=device)
    return g, labels


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


_FAMILIES = {"mesh3d": mesh3d, "rmat": rmat,
             "planted_partition": planted_partition,
             "community_rmat": community_rmat,
             "ring_of_cliques": ring_of_cliques}


def _cache_path(family: str, args, kwargs, cache_dir: str | None) -> str:
    """The npz file of (family, args, kwargs); ``device`` is not part of
    the key (the data do not depend on it)."""
    cache_dir = cache_dir or _CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    key = {k: v for k, v in kwargs.items() if k != "device"}
    sig = repr((args, sorted(key.items())))
    h = hashlib.sha1(sig.encode()).hexdigest()[:12]
    argtxt = "_".join(str(a) for a in args)
    return os.path.join(cache_dir, f"{family}_{argtxt}_{h}.npz")


def cached(family: str, *args, cache_dir: str | None = None, **kwargs):
    """Disk-cached synthetic generation keyed by (family, args, kwargs):
    ``cached("rmat", 22, 8, seed=1)`` equals ``rmat(22, 8, seed=1)`` (host
    COO bit-identical); a cache hit skips the generator's sort and dedup.
    planted_partition's ``(graph, labels)`` comes back as a tuple.  A
    corrupt or partial file is regenerated (published by ``os.replace``)."""
    if family not in _FAMILIES:
        raise ValueError(f"unknown synth family {family!r}; "
                         f"one of {sorted(_FAMILIES)}")
    path = _cache_path(family, args, kwargs, cache_dir)
    dtype = kwargs.get("dtype", torch.float32)
    device = kwargs.get("device", "cpu")
    if os.path.exists(path):
        try:
            z = np.load(path)
            g = from_canonical_coo(z["s"], z["r"], z["w"], int(z["n"]),
                                   dtype=dtype, device=device)
            if "labels" in z:
                return g, z["labels"]
            return g
        except Exception:
            pass
    out = _FAMILIES[family](*args, **kwargs)
    g, labels = out if isinstance(out, tuple) else (out, None)
    s, r, w = g.to_coo_numpy()
    itype = np.int32 if g.n < (1 << 31) else np.int64
    payload = {"s": s.astype(itype), "r": r.astype(itype),
               "w": np.asarray(w), "n": np.int64(g.n)}
    if labels is not None:
        payload["labels"] = np.asarray(labels)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def cached_arrays(family: str, *args, load_weights: bool = True,
                  cache_dir: str | None = None, **kwargs):
    """Like :func:`cached`, but the raw canonical COO ``(s, r, w, n)``
    without building a Graph on a hit; ``load_weights=False`` skips the
    weight member."""
    path = _cache_path(family, args, kwargs, cache_dir)
    if os.path.exists(path):
        try:
            z = np.load(path)
            w = z["w"] if load_weights else None
            return z["s"], z["r"], w, int(z["n"])
        except Exception:
            pass
    out = cached(family, *args, cache_dir=cache_dir, **kwargs)
    g = out[0] if isinstance(out, tuple) else out
    s, r, w = g.to_coo_numpy()
    return s, r, (w if load_weights else None), g.n
