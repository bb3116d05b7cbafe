"""Graph file readers and the coordinate writer (numpy parsing).

Counterpart of graph_embed_tpu/graph/io.py; the formats are documented
there:
  adjlist  one edge per line: ``i j``             (weight 1.0)
  coolist  one entry per line: ``i j w``
  table    line ``i`` lists the neighbor ids of vertex ``i`` (weight 1.0)
  csr      line 1: ``rows cols nnz``; line 2: indptr; line 3: indices;
           line 4: data
  mtx      MatrixMarket coordinate format (1-based; ``symmetric`` honored)
Readers build the graph on the host; move it with ``Graph.to(device)``.
"""

from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges

FORMATS = ("adjlist", "coolist", "table", "csr", "mtx")


def _load_rows(path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64, comments=("%", "#"), ndmin=2)


def read_adjlist(path, symmetric: bool = False, **kw) -> Graph:
    """Edge-pair list, weight 1.0 (linalgcpp ``ReadAdjList``)."""
    data = _load_rows(path)
    return from_edges(data[:, 0].astype(np.int64),
                      data[:, 1].astype(np.int64), None,
                      symmetrize=symmetric, **kw)


def read_coolist(path, symmetric: bool = False, **kw) -> Graph:
    """Weighted triple list (linalgcpp ``ReadCooList``)."""
    data = _load_rows(path)
    w = data[:, 2] if data.shape[1] >= 3 else None
    return from_edges(data[:, 0].astype(np.int64),
                      data[:, 1].astype(np.int64), w,
                      symmetrize=symmetric, **kw)


def read_table(path, **kw) -> Graph:
    """Per-row neighbor lists (linalgcpp ``ReadTable``)."""
    senders, receivers = [], []
    num_rows = 0
    with open(path) as f:
        for i, line in enumerate(f):
            num_rows = i + 1
            for tok in line.split():
                senders.append(i)
                receivers.append(int(tok))
    n = max(num_rows, (max(receivers) + 1) if receivers else 0)
    return from_edges(np.array(senders, dtype=np.int64),
                      np.array(receivers, dtype=np.int64), None, n=n, **kw)


def read_csr(path, **kw) -> Graph:
    """Explicit CSR dump (linalgcpp ``ReadCSR``-equivalent)."""
    with open(path) as f:
        rows, cols, nnz = (int(x) for x in f.readline().split())
        indptr = np.array(f.readline().split(), dtype=np.int64)
        indices = np.array(f.readline().split(), dtype=np.int64)
        data = np.array(f.readline().split(), dtype=np.float64)
    if indptr.shape[0] != rows + 1 or indices.shape[0] != nnz:
        raise ValueError(f"{path}: CSR header does not match its arrays")
    senders = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    return from_edges(senders, indices, data, n=max(rows, cols), **kw)


def read_mtx(path, **kw) -> Graph:
    """MatrixMarket coordinate format (linalgcpp ``ReadMTX``-equivalent)."""
    symmetric = False
    with open(path) as f:
        header = f.readline()
        if header.startswith("%%MatrixMarket"):
            symmetric = "symmetric" in header.lower()
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        rows, cols, _ = (int(x) for x in line.split())
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.size == 0:
        s = r = np.zeros(0, dtype=np.int64)
        w = None
    else:
        s = data[:, 0].astype(np.int64) - 1
        r = data[:, 1].astype(np.int64) - 1
        w = data[:, 2] if data.shape[1] > 2 else None
    return from_edges(s, r, w, n=max(rows, cols), symmetrize=symmetric, **kw)


_READERS = {
    "adjlist": read_adjlist,
    "coolist": read_coolist,
    "table": read_table,
    "csr": read_csr,
    "mtx": read_mtx,
}


def read_graph(path, fmt: str, symmetric: bool = False, **kw) -> Graph:
    """Format-dispatched read (examples/embed.cpp:80-91)."""
    if fmt not in _READERS:
        raise ValueError(f"format must be one of {FORMATS}, got {fmt!r}")
    if fmt in ("adjlist", "coolist"):
        return _READERS[fmt](path, symmetric=symmetric, **kw)
    return _READERS[fmt](path, **kw)


def write_coords(coords, path) -> None:
    """One space-separated coordinate row per vertex (src/export.cpp:27-39).
    ``coords`` is a tensor on any device or an array."""
    if isinstance(coords, np.ndarray):
        arr = coords
    else:
        arr = coords.detach().cpu().numpy()
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join(repr(float(v)) for v in row))
            f.write(" \n")
