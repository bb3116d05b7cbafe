"""Sampled repulsion over shared samples: kernel C (``csrc/repulsion.cu``).

Counterpart of graph_embed_tpu/ops/pallas/repulsion.py: the estimator of
``_rep_math`` (:37) over s sample ids drawn uniformly with replacement,

    rep_i = repel * (n/s) * (deg_i + 1) * (x_i * sum_j w_ij - sum_j w_ij xs_j)
    w_ij  = (deg_j + 1) * rsqrt(max(|xs_j - x_i|^2, eps^2))^3, 0 if j == i

with the diff-form squared distance.  (forceatlas/forces.py's
``repulsion_sampled`` is the other semantics: the gram form of the flat
base case.)  The sample ids are an explicit [s] int32 tensor; the tiled
loop draws them on the device from its ``torch.Generator`` where the
reference draws ``jax.random.randint(key, (s,), 0, n)`` (:132), so tests
inject the reference's ids.

``repulsion_sampled`` launches kernel C on a CUDA tensor and runs the plain
PyTorch version on a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda

# the plain version evaluates at most this many (vertex, sample) pairs at once
PLAIN_MAX_PAIRS = 1 << 24


def draw_samples(n: int, s: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """[s] int32 sample ids, uniform in [0, n) with replacement."""
    return torch.randint(0, n, (s,), generator=generator, device=device,
                         dtype=torch.int32)


def _sampled_terms(x: torch.Tensor, xs: torch.Tensor, degs: torch.Tensor,
                   idx: torch.Tensor, row0: int, eps: float, *,
                   absolute: bool = False) -> torch.Tensor:
    """x_i * sum_j w_ij - sum_j w_ij xs_j for the rows ``x`` (global ids
    from ``row0``): the unscaled estimator.  With ``absolute`` the terms'
    magnitudes |x_i| sum_j w_ij + sum_j w_ij |xs_j| instead."""
    d = x.shape[1]
    d2 = torch.zeros((x.shape[0], xs.shape[0]), dtype=x.dtype,
                     device=x.device)
    for k in range(d):
        dk = xs[None, :, k] - x[:, k, None]
        d2 = d2 + dk * dk
    inv = torch.rsqrt(torch.clamp(d2, min=eps * eps))
    w = degs[None, :] * (inv * inv * inv)
    rows = torch.arange(row0, row0 + x.shape[0], device=x.device)
    w = w.masked_fill(idx.long()[None, :] == rows[:, None], 0.0)
    colsum = torch.sum(w, dim=1, keepdim=True)
    if absolute:
        return x.abs() * colsum + w @ xs.abs()
    return x * colsum - w @ xs


def repulsion_sampled_plain(x: torch.Tensor, deg_p1: torch.Tensor,
                            idx: torch.Tensor, *, repel: float, eps: float,
                            absolute: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel C on [n, d] ``x``.  ``absolute``
    gives each element's sum of |terms| (the scale its float32 rounding
    is held to)."""
    n, s = x.shape[0], idx.shape[0]
    xs, degs = x[idx.long()], deg_p1[idx.long()]
    per = max(1, PLAIN_MAX_PAIRS // max(s, 1))
    out = [_sampled_terms(x[r0:r0 + per], xs, degs, idx, r0, eps,
                          absolute=absolute) for r0 in range(0, n, per)]
    f = torch.cat(out, dim=0) if out else torch.zeros_like(x)
    return (repel * (n / s)) * deg_p1[:, None] * f


def check_samples(idx: torch.Tensor, x: torch.Tensor, name: str) -> None:
    """The sample ids a kernel takes: a non-empty contiguous [s] int32
    tensor on x's device."""
    if idx.device != x.device or idx.dtype != torch.int32 \
            or idx.dim() != 1 or idx.shape[0] == 0 \
            or not idx.is_contiguous():
        raise ValueError(f"{name} takes a non-empty contiguous [s] int32 "
                         f"sample tensor on {x.device}")


def check_rows(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2 \
            or not 1 <= x.shape[1] <= 4 or x.shape[0] == 0:
        raise ValueError(f"{name} takes contiguous float32 [n, d<=4] "
                         f"coordinates, got {x.dtype} {tuple(x.shape)}")


def check_vector(v: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if v.device != x.device or v.dtype != torch.float32 \
            or not v.is_contiguous() or tuple(v.shape) != (x.shape[0],):
        raise ValueError(f"{what} must be a contiguous float32 "
                         f"[{x.shape[0]}] tensor on {x.device}")


def repulsion_sampled_cuda(x: torch.Tensor, deg_p1: torch.Tensor,
                           idx: torch.Tensor, *, repel: float,
                           eps: float) -> torch.Tensor:
    """Kernel C on the card."""
    check_rows(x, "kernel C")
    check_vector(deg_p1, x, "deg + 1")
    check_samples(idx, x, "kernel C")
    n, d = x.shape
    s = idx.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_sampled_repulsion(
            n, d, s, x.data_ptr(), deg_p1.data_ptr(), idx.data_ptr(),
            float(repel) * (n / s), float(eps) * float(eps), out.data_ptr(),
            cuda.stream_of(x))
    cuda.check(rc, "sampled_repulsion")
    cuda.LAUNCHES["sampled_repulsion"] += 1
    return out


def repulsion_sampled(x: torch.Tensor, deg_p1: torch.Tensor,
                      idx: torch.Tensor, *, repel: float,
                      eps: float) -> torch.Tensor:
    """Sampled repulsion: kernel C for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.is_cuda:
        return repulsion_sampled_cuda(x, deg_p1, idx, repel=repel, eps=eps)
    if x.device.type != "cpu":
        raise ValueError(f"repulsion_sampled runs on CUDA or the CPU, not "
                         f"{x.device}")
    return repulsion_sampled_plain(x, deg_p1, idx, repel=repel, eps=eps)
