"""Plain reference of one flat ForceAtlas iteration with sampled repulsion
(float64 PyTorch; imports nothing of the program).

From the graph as the benchmark drew it (unit weights), the coordinates
x and previous forces f_prev the program stepped from, and the sample ids
it was handed, it works out again everything the program derived (the
degrees, the attraction over every stored entry, the repulsion, gravity,
the swing and speed) after forceatlas.hpp:146-269 and the sampled
estimator of the port's ``ops/repulsion.py``:

    f_i   = attract (sum_j x_j - deg_i x_i)
          + repel (n / s) (deg_i + 1) sum_k w_ik (x_i - x_{idx_k})
          - gravity (deg_i + 1) x_i / |x_i|
    w_ik  = (deg_k + 1) max(|x_{idx_k} - x_i|^2, eps^2)^(-3/2),
            0 where idx_k == i
    x'_i  = x_i + f_i min(ks tol / (1 + tol sqrt|f_i - f_prev,i|),
                          ksmax / |f_i|)

Beside each force element it gives the sum of the magnitudes of its
terms, the scale its float32 rounding is held to.
"""

from __future__ import annotations

import torch

TINY = 1e-30
# rows of the repulsion evaluated at once
ROW_BLOCK = 1 << 18


def degrees(senders: torch.Tensor, n: int) -> torch.Tensor:
    return torch.bincount(senders, minlength=n).to(torch.float64)


def forces(senders, receivers, n: int, x, idx, *, repel: float,
           attract: float, gravity: float, eps: float):
    """(f, scale), both [n, d] float64, at float32 ``x`` [n, d] with the
    [s] sample ids ``idx``."""
    x = x.to(torch.float64)
    ax = x.abs()
    deg = degrees(senders, n)
    dp1 = deg + 1.0
    y = torch.zeros_like(x).index_add_(0, senders, x[receivers])
    y_abs = torch.zeros_like(x).index_add_(0, senders, ax[receivers])
    f = attract * (y - deg[:, None] * x)
    scale = abs(attract) * (y_abs + deg[:, None] * ax)
    del y, y_abs
    idx = idx.long()
    s = idx.shape[0]
    xs, ws = x[idx], dp1[idx]
    for r0 in range(0, n, ROW_BLOCK):
        xb = x[r0:r0 + ROW_BLOCK]
        diff = xs[None, :, :] - xb[:, None, :]
        d2 = torch.sum(diff * diff, dim=2)
        w = ws[None, :] * torch.clamp(d2, min=eps * eps) ** -1.5
        rows = torch.arange(r0, r0 + xb.shape[0], device=x.device)
        w = w.masked_fill(idx[None, :] == rows[:, None], 0.0)
        c = repel * (n / s) * dp1[r0:r0 + xb.shape[0], None]
        wsum = w.sum(dim=1, keepdim=True)
        f[r0:r0 + xb.shape[0]] += c * (xb * wsum - w @ xs)
        scale[r0:r0 + xb.shape[0]] += abs(c) * (xb.abs() * wsum
                                                + w @ xs.abs())
    norm = torch.clamp(torch.linalg.vector_norm(x, dim=1), min=TINY)
    grav = -(x / norm[:, None]) * (gravity * dp1)[:, None]
    return f + grav, scale + grav.abs()


def update(x, f, f_prev, *, ks: float, ksmax: float, tolerate: float):
    """(x', speed): the displacement of forceatlas.hpp:214-261 (global
    swing and traction fixed at 1, so the global speed is ``tolerate``)."""
    x, f, f_prev = (t.to(torch.float64) for t in (x, f, f_prev))
    swing = torch.linalg.vector_norm(f - f_prev, dim=1)
    speed = ks * tolerate / (1.0 + tolerate * torch.sqrt(swing))
    total = torch.linalg.vector_norm(f, dim=1)
    bound = torch.where(total > 0, ksmax / torch.clamp(total, min=TINY),
                        torch.full_like(total, float("inf")))
    speed = torch.minimum(speed, bound)
    return x + f * speed[:, None], speed

