"""Force terms of the ForceAtlas2 iteration as tensor functions.

Counterpart of graph_embed_tpu/forceatlas/forces.py (semantics notes and
reference citations there, forceatlas.hpp:146-261):

* repulsion (deg_i+1)(deg_j+1) * repel / d^2 along (x_i - x_j)/d with
  d clamped below at epsilon;
* attraction per stored entry with the folded constant c_e of
  ``fold_edge_weights``; under plain FA (no linlog) fa/d = c_e, so the
  whole term is the SpMV ``attract * (A_c x - deg_c * x)``; linlog keeps
  the distance per entry (both in ops/edge_spmm.py, kernels A and E);
* gravity toward the origin with magnitude gravity * (deg_i + 1).

The gram and sampled repulsions use full-float32 matmuls: the gram
identity cancels catastrophically for near pairs (forces.py:58-62), so
TF32 must stay off (``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import numpy as np
import torch

TINY = 1e-30


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def repulsion_exact(coords, deg_p1, repel: float, eps: float):
    """Per-pair differences, O(n^2 d) memory (forceatlas.hpp:151-167)."""
    n = coords.shape[0]
    diff = coords[:, None, :] - coords[None, :, :]
    dist = torch.clamp(_norm(diff), min=eps)
    w = deg_p1[None, :] / (dist * dist * dist)
    w = w.masked_fill(torch.eye(n, dtype=torch.bool, device=coords.device),
                      0.0)
    return (repel * deg_p1)[:, None] * torch.einsum("ijk,ij->ik", diff, w)


def repulsion_gram(coords, deg_p1, repel: float, eps: float, *,
                   block: int = 1024):
    """Gram-identity repulsion, row-blocked to bound memory."""
    n = coords.shape[0]
    sq_all = torch.sum(coords * coords, dim=1)
    cols = torch.arange(n, device=coords.device)
    out = []
    for row0 in range(0, n, block):
        x_blk = coords[row0: row0 + block]
        d2 = (sq_all[row0: row0 + block, None] + sq_all[None, :]
              - 2.0 * (x_blk @ coords.T))
        dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
        w = deg_p1[None, :] / (dist * dist * dist)
        w = w.masked_fill(cols[row0: row0 + x_blk.shape[0], None]
                          == cols[None, :], 0.0)
        f = x_blk * torch.sum(w, dim=1, keepdim=True) - w @ coords
        out.append((repel * deg_p1[row0: row0 + block])[:, None] * f)
    return torch.cat(out, dim=0)


def repulsion_sampled(coords, deg_p1, repel: float, eps: float,
                      idx: torch.Tensor):
    """Unbiased negative-sampling estimator over the shared sample ids
    ``idx`` [s] (drawn uniformly with replacement by the caller); self
    pairs masked, scaled by n/s."""
    n = coords.shape[0]
    s = idx.shape[0]
    xs = coords[idx]
    degs = deg_p1[idx]
    sq_all = torch.sum(coords * coords, dim=1)
    d2 = (sq_all[:, None] + torch.sum(xs * xs, dim=1)[None, :]
          - 2.0 * (coords @ xs.T))
    dist = torch.clamp(torch.sqrt(torch.clamp(d2, min=0.0)), min=eps)
    w = degs[None, :] / (dist * dist * dist)
    w = w.masked_fill(torch.arange(n, device=coords.device)[:, None]
                      == idx[None, :], 0.0)
    f = coords * torch.sum(w, dim=1, keepdim=True) - w @ xs
    return (repel * deg_p1)[:, None] * f * (n / s)


def fold_edge_weights(weights, deg_senders, *, use_weights: bool,
                      delta: float, nohubs: bool) -> np.ndarray:
    """Per-edge constant c_e of the attraction magnitude
    (forceatlas.hpp:180-196), host numpy:
      c_e = w (delta == 1), 1 (delta == 0), sign(w)|w|^delta otherwise,
    divided by (deg_i + 1) when nohubs.  use_weights=False sets w = 1."""
    w = weights if use_weights else np.ones_like(weights)
    if delta == 1.0:
        c = w
    elif delta == 0.0:
        c = np.ones_like(w)
    else:
        c = np.sign(w) * np.abs(w) ** delta
    if nohubs:
        c = c / (deg_senders + 1.0)
    return c


def gravity_force(coords, deg_p1, gravity: float, *,
                  clamp_eps: float | None = None):
    """F_g = -(x_i/|x_i|) * gravity * (deg_i+1) (forceatlas.hpp:205-211);
    the flat reference guards exact zero only, the multilevel one clamps
    at epsilon."""
    mag = torch.clamp(_norm(coords), min=TINY if clamp_eps is None
                      else clamp_eps)
    return -(coords / mag[:, None]) * (gravity * deg_p1)[:, None]


def speed_update(coords, forces, forces_prev, deg_p1, *, ks: float,
                 ksmax: float, tolerate: float,
                 swing_clamp_eps: float | None = None):
    """Adaptive-speed displacement (forceatlas.hpp:214-261).  The
    reference overwrites its global swing/traction sums with 1.0
    (:228,:242), so the global speed is ``tolerate``."""
    swing = _norm(forces - forces_prev)
    if swing_clamp_eps is not None:
        swing = torch.clamp(swing, min=swing_clamp_eps)
    speed = ks * tolerate / (1.0 + tolerate * torch.sqrt(swing))
    total_f = _norm(forces)
    constraint = torch.where(total_f > 0,
                             ksmax / torch.clamp(total_f, min=TINY),
                             torch.full_like(total_f, float("inf")))
    speed = torch.minimum(speed, constraint)
    return coords + forces * speed[:, None]


def normalize_coords(coords, *, max_clamp_eps: float | None = None):
    """Center at the mean and scale to the unit ball
    (forceatlas.hpp:272-303)."""
    centered = coords - torch.mean(coords, dim=0, keepdim=True)
    max_len = torch.max(_norm(centered))
    max_len = torch.clamp(max_len, min=TINY if max_clamp_eps is None
                          else max_clamp_eps)
    return centered / max_len
