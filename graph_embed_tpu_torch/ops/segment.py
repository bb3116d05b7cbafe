"""Deterministic per-segment sums: a row-owned walk instead of atomics.

Counterpart of graph_embed_tpu/ops/segment.py.  JAX's
``jax.ops.segment_sum`` is a scatter-add; ``index_add_`` would be the
PyTorch spelling, but on CUDA it adds with atomics in an order that changes
from run to run.  Here a segment sum is ``y = A v`` over a CSR whose rows
are the segments and whose columns index the value array, all weights 1:
kernel A's unit mode on a CUDA tensor (a thread, a warp for a segment of
more than 32 values, or a block for a hub segment, owns one segment and
adds its values in a fixed order), its plain version on a CPU tensor.  The CSR is
built once per level on the host (``segment_csr``), on the values' device
from their segment ids (``grouped``), or, for values already grouped by
segment, straight from the row pointers (``sorted_csr``).

``segment_max`` and ``segment_min`` are the JAX helpers' counterparts on
``scatter_reduce``, whose maxima and minima do not depend on the order of
the values.

``sequential_sum`` is the sum a sequential loop takes: ``((init + v_0) +
v_1) + ...`` per segment, in the values' order, bitwise.  The native
coarsener folds its weights and alphas that way, and the device coarsener
must round as it does.
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


#: kernel A sums a row of at most this many entries in one thread, in
#: order from zero (edge_spmm.cu's LONG_ROW); longer rows go to a warp
SEQUENTIAL_ROW = 32


def grouped(ids: torch.Tensor, num_segments: int
            ) -> tuple[torch.Tensor, ES.EdgeCSR]:
    """(order, csr) for values with segment ids ``ids`` ([E] int64), built
    on their device: ``values[order]`` lies grouped by segment, each
    segment's values in their input order (a stable sort), and ``csr`` is
    the CSR of those grouped values (``sorted_csr``)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    bounds = torch.arange(num_segments + 1, device=ids.device)
    indptr = torch.searchsorted(sorted_ids, bounds)
    return order, sorted_csr(indptr, int(ids.shape[0]))


def sequential_sum(values: torch.Tensor, indptr: torch.Tensor,
                   init: torch.Tensor | None = None) -> torch.Tensor:
    """[S] sums of the segments ``values[indptr[i]:indptr[i+1]]`` ([E]),
    each added in order onto ``init[i]`` (zero without it): bitwise the
    sum of a sequential loop.

    Kernel A adds a row of up to ``SEQUENTIAL_ROW`` entries in one thread
    in order, so each pass hands it, per segment not yet done, the running
    sum followed by the next ``SEQUENTIAL_ROW - 1`` values; a segment of L
    values takes ceil(L / 31) passes, each pass one launch over the
    segments still open.  On the CPU the plain version runs the same
    passes."""
    n_seg = int(indptr.shape[0]) - 1
    dev = values.device
    indptr = indptr.to(dev, torch.int64)
    acc = (torch.zeros(n_seg, dtype=values.dtype, device=dev)
           if init is None else init.to(values.dtype).clone())
    e = int(values.shape[0])
    step = SEQUENTIAL_ROW - 1
    lens = indptr[1:] - indptr[:-1]
    active = torch.nonzero(lens > 0).flatten()
    taken = 0
    while active.numel():
        rem = lens[active] - taken
        k = torch.clamp(rem, max=step)
        row_len = k + 1
        rows = torch.zeros(active.numel() + 1, dtype=torch.int64,
                           device=dev)
        torch.cumsum(row_len, 0, out=rows[1:])
        total = int(rows[-1])
        seg = torch.repeat_interleave(
            torch.arange(active.numel(), device=dev), row_len,
            output_size=total)
        pos = torch.arange(total, device=dev) - rows[:-1][seg]
        col = torch.where(pos == 0, e + active[seg],
                          indptr[active][seg] + taken + pos - 1)
        csr = ES.EdgeCSR(indptr=rows.to(torch.int32),
                         col=col.to(torch.int32), w=None,
                         n_rows=int(active.numel()), n_cols=e + n_seg)
        x = torch.cat([values, acc])
        acc[active] = segment_sum(x, csr)
        taken += step
        active = active[rem > step]
    return acc


def _extreme(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments] maxima of ``values`` by segment; an empty segment
    holds the dtype's lowest value, as ``jax.ops.segment_max`` gives."""
    out = torch.full((num_segments,), _extreme(values.dtype, False),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, segment_ids, values, "amax",
                              include_self=True)


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """[num_segments] minima by segment; an empty segment holds the
    dtype's highest value."""
    out = torch.full((num_segments,), _extreme(values.dtype, True),
                     dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, segment_ids, values, "amin",
                              include_self=True)
