"""Graph file readers and writers.

Counterpart of graph_embed_tpu/graph/io.py; the formats are documented
there:
  adjlist  one edge per line: ``i j``             (weight 1.0)
  coolist  one entry per line: ``i j w``
  table    line ``i`` lists the neighbor ids of vertex ``i`` (weight 1.0)
  csr      line 1: ``rows cols nnz``; line 2: indptr; line 3: indices;
           line 4: data
  mtx      MatrixMarket coordinate format (1-based; ``symmetric`` honored)
Readers build the graph on the host; move it with ``Graph.to(device)``.
The edge lists (adjlist, coolist) go through the native parser
(native/fastload.py, io.py:29-50 of the reference); a file it refuses is
read with ``np.loadtxt``.  ``PARSES`` counts the files each route read.
Writers: ``write_coords`` and ``write_partition`` (src/export.cpp),
``write_coolist`` (linalgcpp ``WriteCooList``) and the embedder's
multilevel partition dump.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..native import fastload
from .csr import Graph, from_edges

FORMATS = ("adjlist", "coolist", "table", "csr", "mtx")
#: files read per parser route, "native" or "loadtxt"
PARSES: collections.Counter = collections.Counter()


def _parse(path, cols: int):
    """(src, dst, w or None) of an edge list: the native parser, or numpy
    for a file it refuses."""
    try:
        out = fastload.parse_edges(path, cols)
        PARSES["native"] += 1
        return out
    except fastload.Refused:
        pass
    data = np.loadtxt(path, dtype=np.float64, comments=("%", "#"), ndmin=2)
    PARSES["loadtxt"] += 1
    w = data[:, 2] if cols >= 3 and data.shape[1] >= 3 else None
    return data[:, 0].astype(np.int64), data[:, 1].astype(np.int64), w


def read_adjlist(path, symmetric: bool = False, **kw) -> Graph:
    """Edge-pair list, weight 1.0 (linalgcpp ``ReadAdjList``)."""
    s, r, _ = _parse(path, 2)
    return from_edges(s, r, None, symmetrize=symmetric, **kw)


def read_coolist(path, symmetric: bool = False, **kw) -> Graph:
    """Weighted triple list (linalgcpp ``ReadCooList``)."""
    s, r, w = _parse(path, 3)
    return from_edges(s, r, w, symmetrize=symmetric, **kw)


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


def _host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_partition(vertex_to_agg, path) -> None:
    """One aggregate id per line (src/export.cpp:16-25)."""
    arr = _host(vertex_to_agg).astype(np.int64)
    with open(path, "w") as f:
        f.write("\n".join(str(int(a)) for a in arr))
        f.write("\n")


def write_coolist(g: Graph, path) -> None:
    """Edge triple dump (linalgcpp ``WriteCooList``, run-tests.cpp:412)."""
    s, r, w = g.to_coo_numpy()
    with open(path, "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{int(i)} {int(j)} {float(v)}\n")


def write_multilevel_partition(hierarchy_assignments, path) -> None:
    """The embedder pipeline's multilevel partition dump
    (embedder.cpp:230-267): an ``n k`` header, the aggregate count of each
    level, then per level one line per aggregate listing its members.
    ``hierarchy_assignments[l]`` maps level-l vertices to level-(l+1)
    aggregate ids (tensors or arrays)."""
    assigns = [_host(a) for a in hierarchy_assignments]
    n = int(assigns[0].shape[0])
    with open(path, "w") as f:
        f.write(f"{n} {len(assigns)}\n")
        f.write(" ".join(str(int(a.max()) + 1) for a in assigns))
        f.write(" \n")
        for assign in assigns:
            m = int(assign.max()) + 1
            order = np.argsort(assign, kind="stable")
            counts = np.bincount(assign, minlength=m)
            start = 0
            for a in range(m):
                members = order[start:start + counts[a]]
                start += counts[a]
                f.write(" ".join(str(int(v)) for v in members))
                f.write(" \n")


def write_coords(coords, path) -> None:
    """One space-separated coordinate row per vertex (src/export.cpp:27-39).
    ``coords`` is a tensor on any device or an array."""
    rows = _host(coords).astype(np.float64).tolist()
    with open(path, "w") as f:
        f.writelines(" ".join(map(repr, row)) + " \n" for row in rows)
