"""DIA (diagonal / stencil) decomposition of the attraction SpMV.

Counterpart of graph_embed_tpu/ops/dia.py (the rationale is there).  Edges
at a handful of constant index offsets j - i (a 3D grid in natural order
has six: +-1, +-L, +-L^2) are applied as

    y[i] = sum_k  W_k[i] * x[i + o_k]        (W_k[i] = 0 where no edge)

in exact float32; the remaining (residual) edges stay on kernel A.  The
plan's rules are the reference's; the port has no padded vertex count, so
the plan's weight rows are [n] where the reference's are [n_pad], and
``min_count`` defaults to ``max(DIA_MIN_COUNT, n // 16)``.  Kernel D
applies the offsets in-kernel (``csrc/fused_step.cu``); ``dia_spmv`` here
is the plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: an offset qualifies when it covers >= max(DIA_MIN_COUNT, n // 16) edges
DIA_MIN_COUNT = 1 << 16
MAX_OFFSETS = 32  # also kernel D's limit (csrc/fused_step.cu)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Host-side result of plan_dia."""

    offsets: tuple          # K ints (j - i), descending edge count
    weights: np.ndarray     # [K, n] f32, W_k[i] = w(i, i+o_k) or 0
    residual_mask: np.ndarray  # [E] bool: edges NOT absorbed by a diagonal


def plan_dia(s, r, w, n: int, *,
             min_count: int | None = None) -> DiaPlan | None:
    """Pick the index offsets worth a dedicated pass (host, numpy).

    Returns None when no offset covers enough edges (irregular graphs keep
    every edge on kernel A)."""
    s = np.asarray(s)
    r = np.asarray(r)
    w = np.asarray(w, dtype=np.float64)
    if min_count is None:
        min_count = max(DIA_MIN_COUNT, n // 16)
    if s.size == 0 or min_count <= 0 or s.size < min_count:
        return None
    off = r.astype(np.int64) - s.astype(np.int64)
    vals, inv = np.unique(off, return_inverse=True)
    counts = np.bincount(inv)
    sel = np.flatnonzero(counts >= min_count)
    if sel.size == 0:
        return None
    if sel.size > MAX_OFFSETS:
        sel = sel[np.argsort(counts[sel])[::-1][:MAX_OFFSETS]]
    else:
        sel = sel[np.argsort(counts[sel])[::-1]]
    remap = np.full(vals.size, -1, dtype=np.int64)
    remap[sel] = np.arange(sel.size)
    k_of = remap[inv]
    is_dia = k_of >= 0
    weights = np.zeros((sel.size, n), np.float32)
    # (s, offset) pairs are unique in a deduped COO: plain assignment
    weights[k_of[is_dia], s[is_dia]] = w[is_dia].astype(np.float32)
    return DiaPlan(offsets=tuple(int(v) for v in vals[sel]),
                   weights=weights, residual_mask=~is_dia)


def dia_spmv(x: torch.Tensor, dia_w: torch.Tensor, offsets: tuple,
             y0: torch.Tensor | None = None) -> torch.Tensor:
    """y = y0 + A_dia x for [n, d] ``x`` (y0 = 0 when None), one offset
    after another in plan order.  Rows whose partner i + o_k falls outside
    [0, n) have W_k[i] = 0 and are skipped."""
    n = x.shape[0]
    y = torch.zeros_like(x) if y0 is None else y0.clone()
    for k, o in enumerate(offsets):
        lo, hi = max(0, -o), min(n, n - o)
        if lo < hi:
            y[lo:hi] = y[lo:hi] + dia_w[k, lo:hi, None] * x[lo + o:hi + o]
    return y


def dia_row_sums(weights: np.ndarray) -> np.ndarray:
    """[n] row sums of the DIA part (f32 exact: DIA edges skip the residual
    weights' bf16 truncation)."""
    return weights.astype(np.float64).sum(axis=0).astype(np.float32)
