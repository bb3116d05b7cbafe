"""Deterministic per-segment sums: a row-owned walk instead of atomics.

Counterpart of graph_embed_tpu/ops/segment.py.  JAX's
``jax.ops.segment_sum`` is a scatter-add; ``index_add_`` would be the
PyTorch spelling, but on CUDA it adds with atomics in an order that changes
from run to run.  Here a segment sum is ``y = A v`` over a CSR whose rows
are the segments and whose columns index the value array, all weights 1:
kernel A's unit mode on a CUDA tensor (a thread, or a warp for a segment
of more than 32 values, owns one segment and adds its values in a fixed
order), its plain version on a CPU tensor.  The CSR is
built once per level on the host (``segment_csr``) or, for values already
grouped by segment, straight from the row pointers (``sorted_csr``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import edge_spmm as ES

def segment_csr(segment_ids, num_segments: int, *, device="cpu"
                ) -> ES.EdgeCSR:
    """Members-by-segment CSR from a host [E] id array: row a lists the
    positions e with ``segment_ids[e] == a`` in increasing order (a stable
    sort), which fixes the summation order."""
    seg = np.asarray(segment_ids, dtype=np.int64)
    csr, _ = ES.build_csr(seg, np.arange(seg.size), None, int(num_segments),
                          int(seg.size), device=device)
    return csr


def sorted_csr(indptr: torch.Tensor, num_values: int) -> ES.EdgeCSR:
    """The CSR of values already grouped by segment: segment i owns values
    ``indptr[i]:indptr[i+1]`` (a graph's stored entries, sorted by
    sender), so column e is value e."""
    if num_values >= 1 << 31:
        raise ValueError("kernel A indexes with int32")
    dev = indptr.device
    return ES.EdgeCSR(indptr=indptr.to(torch.int32).contiguous(),
                      col=torch.arange(num_values, dtype=torch.int32,
                                       device=dev),
                      w=None, n_rows=int(indptr.shape[0]) - 1,
                      n_cols=int(num_values))


def segment_sum(values: torch.Tensor, csr: ES.EdgeCSR) -> torch.Tensor:
    """[num_segments] or [num_segments, d] sums of ``values`` ([E] or
    [E, d]; on the card float32 with d <= 4, as kernel A takes them) over
    the segments of ``csr``."""
    if csr.w is not None:
        raise ValueError("a segment CSR carries no weights")
    if values.dim() == 1:
        return ES.spmv(values[:, None].contiguous(), csr)[:, 0]
    return ES.spmv(values.contiguous(), csr)
