"""Aggregation operator: the vertex -> aggregate assignment that stands for
the reference's CSR ``P^T`` (src/partitioner.cpp:29-65).  Counterpart of
graph_embed_tpu/partition/interpolation.py: ``P^T x`` is a segment sum
(``restrict``, row-owned through ``ops.segment``), ``P y`` a gather
(``prolong``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import segment


@dataclasses.dataclass(frozen=True)
class Partition:
    """``vertex_to_agg``: [n] int64 tensor with dense ids in
    [0, num_aggs); ``host_v2a`` keeps the int32 host copy when the
    partition was built on the host."""

    vertex_to_agg: torch.Tensor
    num_aggs: int
    host_v2a: np.ndarray | None = dataclasses.field(default=None, repr=False,
                                                    compare=False)

    @property
    def n(self) -> int:
        return int(self.vertex_to_agg.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vertex_to_agg.device

    @classmethod
    def from_numpy(cls, v2a, num_aggs: int, *, device="cpu") -> "Partition":
        v2a = np.ascontiguousarray(v2a, dtype=np.int32)
        return cls(torch.from_numpy(v2a.astype(np.int64)).to(device),
                   int(num_aggs), v2a)

    def to(self, device) -> "Partition":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(self,
                                   vertex_to_agg=self.vertex_to_agg.to(device))

    def vertex_to_agg_numpy(self) -> np.ndarray:
        if self.host_v2a is not None:
            return self.host_v2a
        return self.vertex_to_agg.cpu().numpy().astype(np.int32)

    def agg_sizes(self) -> torch.Tensor:
        """[num_aggs] member count per aggregate."""
        return torch.bincount(self.vertex_to_agg, minlength=self.num_aggs)

    def members_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr [num_aggs+1], order [n]), host int64: the rows of P^T,
        each aggregate's members sorted by vertex id (interpolationMatrix's
        member order, src/partitioner.cpp:54-62)."""
        v2a = self.vertex_to_agg_numpy()
        order = np.argsort(v2a, kind="stable")
        counts = np.bincount(v2a, minlength=self.num_aggs)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return indptr.astype(np.int64), order.astype(np.int64)

    def segment_csr(self):
        """The members-by-aggregate segment CSR on the partition's device
        (``ops.segment``), in vertex order."""
        return segment.segment_csr(self.vertex_to_agg_numpy(), self.num_aggs,
                                   device=self.device)

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        """P^T x: vertex values summed into their aggregates, each over its
        members in vertex order (kernel A on the card)."""
        return segment.segment_sum(x, self.segment_csr())

    def prolong(self, y: torch.Tensor) -> torch.Tensor:
        """P y: aggregate values copied to their members."""
        return y[self.vertex_to_agg.to(y.device)]


def partition_from_labels(labels, *, device="cpu") -> Partition:
    """A Partition from arbitrary (possibly sparse) labels, densely
    re-ranked on the host: one aggregate per distinct label."""
    uniq, dense = np.unique(np.asarray(labels), return_inverse=True)
    return Partition.from_numpy(dense.ravel().astype(np.int32), int(uniq.size),
                                device=device)


def compose(parts: list[Partition], upto: int | None = None) -> Partition:
    """Compose level assignments 0..upto-1 into original vertex -> coarse
    aggregate (graph_embed_tpu/partition/interpolation.py:97).  Host
    copies compose on the host; otherwise on the first level's device."""
    if upto is None:
        upto = len(parts)
    if all(p.host_v2a is not None for p in parts[:upto]):
        h = parts[0].host_v2a
        for p in parts[1:upto]:
            h = p.host_v2a[h]
        return Partition.from_numpy(h, parts[upto - 1].num_aggs,
                                    device=parts[0].device)
    v2a = parts[0].vertex_to_agg
    for p in parts[1:upto]:
        v2a = p.vertex_to_agg.to(v2a.device)[v2a]
    return Partition(v2a, parts[upto - 1].num_aggs)
