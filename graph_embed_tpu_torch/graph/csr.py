"""Core graph container: CSR-ordered COO tensors on one device plus a host
copy.

Counterpart of graph_embed_tpu/graph/csr.py.  PyTorch runs eagerly, so
there is no static padded capacity: ``senders``/``receivers``/``weights``
hold exactly the ``num_edges`` stored entries, sorted by (sender,
receiver).  Every stored direction counts, so a symmetric graph stores each
undirected edge twice plus self loops once, like the reference CSR
(include/matrixutils.hpp:15-19).

Graphs built on the host keep their numpy COO in ``host_coo``: the
coarsener, the slot layout and the radii sweep read it without a device
pull.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import segment


@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly weighted, symmetric) sparse adjacency matrix.

    indptr:    [n+1] int64 CSR row pointers.
    senders:   [E] int64 row ids (sorted).
    receivers: [E] int64 column ids.
    weights:   [E] float edge weights.
    host_coo:  numpy (senders int64, receivers int64, weights) or None.
    """

    indptr: torch.Tensor
    senders: torch.Tensor
    receivers: torch.Tensor
    weights: torch.Tensor
    n: int
    num_edges: int
    host_coo: tuple | None = dataclasses.field(default=None, repr=False,
                                               compare=False)

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    def to(self, device) -> "Graph":
        """The same graph with its tensors on ``device`` (host copy shared)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, indptr=self.indptr.to(device),
            senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            weights=self.weights.to(device))

    def to_coo_numpy(self):
        """(senders, receivers, weights) as numpy arrays."""
        if self.host_coo is not None:
            return self.host_coo
        return (self.senders.cpu().numpy(), self.receivers.cpu().numpy(),
                self.weights.cpu().numpy())

    def row_counts(self) -> torch.Tensor:
        """[n] number of stored entries per row (unweighted degree)."""
        return (self.indptr[1:] - self.indptr[:-1]).to(self.dtype)

    def row_sums(self) -> torch.Tensor:
        """[n] weighted degree, the row sum incl. the diagonal
        (forceatlas.hpp:127-135), on the graph's device: each row's entries
        added in their stored order (``ops.segment``, kernel A on the
        card), so the result does not depend on atomics."""
        csr = segment.sorted_csr(self.indptr, self.num_edges)
        return segment.segment_sum(self.weights, csr)

    def total_weight(self) -> torch.Tensor:
        """Sum of all stored entries (the ``T`` of modularity,
        partitioner.cpp:101), a 0-d tensor on the graph's device."""
        return self.weights.sum()

    def to_dense_numpy(self) -> np.ndarray:
        s, r, w = self.to_coo_numpy()
        out = np.zeros((self.n, self.n), dtype=np.asarray(w).dtype)
        np.add.at(out, (s, r), w)
        return out

    def degrees_numpy(self, use_weights: bool = True) -> np.ndarray:
        """[n] float64 degree = row sum incl. diagonal
        (forceatlas.hpp:127-140), or the stored-entry count."""
        s, _, w = self.to_coo_numpy()
        if use_weights:
            return np.bincount(s, weights=np.asarray(w, np.float64),
                               minlength=self.n)
        return np.bincount(s, minlength=self.n).astype(np.float64)

    def degrees(self, use_weights: bool = True) -> torch.Tensor:
        """[n] degree vector on the graph's device.  Summed on the host in
        float64 so the result does not depend on a device's summation
        order."""
        return torch.as_tensor(self.degrees_numpy(use_weights),
                               dtype=self.dtype).to(self.device)

    def __repr__(self):
        return (f"Graph(n={self.n}, num_edges={self.num_edges}, "
                f"dtype={self.dtype}, device={self.device})")


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _build(s, r, w, n: int, *, dtype, device) -> Graph:
    """Graph from a COO already sorted by (sender, receiver)."""
    e = int(s.size)
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(s, minlength=n)[:n])
    w_host = np.asarray(w).astype(_np_dtype(dtype))
    g = Graph(indptr=torch.from_numpy(indptr),
              senders=torch.from_numpy(np.ascontiguousarray(s, np.int64)),
              receivers=torch.from_numpy(np.ascontiguousarray(r, np.int64)),
              weights=torch.from_numpy(w_host.copy()),
              n=int(n), num_edges=e,
              host_coo=(np.asarray(s, np.int64).copy(),
                        np.asarray(r, np.int64).copy(), w_host))
    return g.to(device)


#: from_coo sums duplicates with the native radix sort (native/pack_lib)
#: from this many entries; below it numpy beats the ctypes round trip
_NATIVE_MIN_EDGES = 1 << 16


def _finish_coo(s, r, w, n, *, sum_duplicates: bool, dtype, device) -> Graph:
    if sum_duplicates and s.size >= _NATIVE_MIN_EDGES:
        from ..native import pack_lib

        s, r, w, _ = pack_lib.coo_dedup(s, r, w, n)
    elif sum_duplicates and s.size:
        key = s * np.int64(n) + r
        order = np.argsort(key, kind="stable")
        key, s, r, w = key[order], s[order], r[order], w[order]
        uniq = np.empty(key.shape, dtype=bool)
        uniq[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq[1:])
        seg = np.cumsum(uniq) - 1
        # bincount adds in input order, exactly like np.add.at
        w = np.bincount(seg, weights=w)
        s, r = s[uniq], r[uniq]
    elif s.size:
        order = np.lexsort((r, s))
        s, r, w = s[order], r[order], w[order]
    return _build(s, r, w, n, dtype=dtype, device=device)


def _as_coo(senders, receivers, weights):
    s = np.asarray(senders, dtype=np.int64).ravel()
    r = np.asarray(receivers, dtype=np.int64).ravel()
    w = (np.ones(s.shape[0], dtype=np.float64) if weights is None
         else np.asarray(weights, dtype=np.float64).ravel())
    if not (s.shape == r.shape == w.shape):
        raise ValueError("senders/receivers/weights must have equal length")
    return s, r, w


def from_coo(senders, receivers, weights=None, *, n: int | None = None,
             symmetrize: bool = False, sum_duplicates: bool = True,
             dtype=torch.float32, device="cpu") -> Graph:
    """Build a :class:`Graph` from COO triples (linalgcpp ``CooMatrix.Add +
    ToSparse``, embed.cpp:51-66): duplicates summed, rows sorted.
    ``symmetrize`` adds the transpose of every off-diagonal entry."""
    s, r, w = _as_coo(senders, receivers, weights)
    if n is None:
        n = int(max(s.max(initial=-1), r.max(initial=-1)) + 1)
    if s.size and (s.min() < 0 or r.min() < 0 or s.max() >= n
                   or r.max() >= n):
        raise ValueError("vertex id out of range")
    if symmetrize:
        off = s != r
        s, r, w = (np.concatenate([s, r[off]]), np.concatenate([r, s[off]]),
                   np.concatenate([w, w[off]]))
    return _finish_coo(s, r, w, n, sum_duplicates=sum_duplicates,
                       dtype=dtype, device=device)


def from_edges(senders, receivers, weights=None, *, n: int | None = None,
               symmetrize: bool = False, dtype=torch.float32,
               device="cpu") -> Graph:
    """Build a Graph from an edge list, optionally adding the reverse
    direction (linalgcpp ``ReadCooList`` with ``symmetric``,
    examples/embed.cpp:81-91); duplicates are summed."""
    return from_coo(senders, receivers, weights, n=n, symmetrize=symmetrize,
                    sum_duplicates=True, dtype=dtype, device=device)


def from_canonical_coo(s, r, w, n: int, *, dtype=torch.float32,
                       device="cpu") -> Graph:
    """Trusted constructor: the COO is already sorted by (sender, receiver)
    and deduplicated (the coarsener's emitted Galerkin graphs)."""
    s = np.ascontiguousarray(s).ravel().astype(np.int64)
    r = np.ascontiguousarray(r).ravel().astype(np.int64)
    w = (np.ones(s.shape[0], np.float64) if w is None
         else np.asarray(w, dtype=np.float64).ravel())
    return _build(s, r, w, n, dtype=dtype, device=device)


def from_dense(mat, *, dtype=torch.float32, device="cpu") -> Graph:
    """A Graph from a dense adjacency matrix (host; for tests and
    oracles)."""
    m = np.asarray(mat)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        raise ValueError("expected a square matrix")
    s, r = np.nonzero(m)
    return from_edges(s, r, m[s, r], n=m.shape[0], dtype=dtype,
                      device=device)


def from_scipy(sp_mat, *, dtype=torch.float32, device="cpu") -> Graph:
    """A Graph from any scipy sparse matrix (host; for tests and
    oracles)."""
    coo = sp_mat.tocoo()
    return from_edges(coo.row, coo.col, coo.data, n=coo.shape[0],
                      dtype=dtype, device=device)


def submatrix(g: Graph, vertices, *, dtype=None) -> Graph:
    """Induced subgraph on ``vertices`` (linalgcpp ``GetSubMatrix``,
    examples/embedder.cpp:92,112), built on the host and placed on ``g``'s
    device."""
    vertices = np.asarray(vertices, dtype=np.int64)
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[vertices] = np.arange(vertices.size)
    s, r, w = g.to_coo_numpy()
    keep = (remap[s] >= 0) & (remap[r] >= 0)
    return from_edges(remap[s[keep]], remap[r[keep]], w[keep],
                      n=int(vertices.size), dtype=dtype or g.dtype,
                      device=g.device)
