"""The reference's block-sparse (BSR) weight rule, as a host rule on the
CSR (counterpart of graph_embed_tpu/ops/bsr.py).

For a locality-rich graph without DIA structure the reference's
``prepare_tiled`` may store the attraction as dense [256, 256] bf16 blocks
(tiled.py:162-178).  What that changes in the arithmetic is the weights:
entries of a (sender block, receiver window) pair holding at least
``min_pair_edges`` edges are stored rounded to NEAREST bf16 (the blocks'
``astype(bfloat16)``, bsr.py:161-165), those of sparser pairs stay exact
float32 on the overflow path (bsr.py:142), and x stays float32 through a
hi/lo split (bsr.py:190-197).  The port builds no dense block: kernel A's
weighted mode runs the CSR with these weights.
"""

from __future__ import annotations

import numpy as np
import torch

BSR_SB = 256
BSR_W = 256


def plan_bsr(s, r, *, min_pair_edges: int = 64, sender_block: int = BSR_SB,
             window: int = BSR_W) -> tuple[float, int]:
    """(coverage, resident bytes) of the reference's pair census
    (bsr.py:97): the fraction of edges in pairs of at least
    ``min_pair_edges`` edges, and the bytes their dense bf16 blocks would
    take."""
    s = np.asarray(s)
    r = np.asarray(r)
    key = (s // sender_block).astype(np.int64) * (1 << 32) + r // window
    _, counts = np.unique(key, return_counts=True)
    dense = counts >= min_pair_edges
    cov = float(counts[dense].sum()) / max(s.size, 1)
    return cov, int(dense.sum()) * sender_block * window * 2


def bsr_weights(s, r, w, *, min_pair_edges: int = 64,
                sender_block: int = BSR_SB,
                window: int = BSR_W) -> np.ndarray:
    """[E] float32 weights as the reference's BSR path applies them, in
    the input order: dense-pair entries rounded to nearest bf16, overflow
    entries exact.  Every edge counts toward its pair, zero weights too
    (build_bsr counts before it sets)."""
    s = np.asarray(s)
    r = np.asarray(r)
    key = (s // sender_block).astype(np.int64) * (1 << 32) + r // window
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    dense = (counts >= min_pair_edges)[inv.ravel()]
    out = np.asarray(w, dtype=np.float32).copy()
    # torch's bf16 cast rounds to nearest even, as the blocks' astype does
    out[dense] = torch.from_numpy(out[dense]).to(torch.bfloat16).float(
        ).numpy()
    return out
