"""Whole-iteration fused ForceAtlas step: kernel D (``csrc/fused_step.cu``).

Counterpart of graph_embed_tpu/ops/pallas/fused_step.py.  For
sampled-repulsion graphs one kernel computes a whole iteration from x,
f_prev, the DIA weights, the residual attraction ``y_res`` (kernel A's
output, or None), the row sums, deg + 1 and the sample ids, and writes
(x', f).  The TPU kernel splits DIA offsets into near (in-kernel lane
rolls within one block of halo) and far (pre-applied into ``y_res``); on
the card every offset is read in-kernel, so there is no split.

``fa_step_fused`` launches kernel D on CUDA tensors and runs the plain
version, the same step composed of PyTorch ops, on CPU tensors; there is
no fallback between the two.
"""

from __future__ import annotations

import torch

from ..forceatlas import forces as F
from . import cuda
from . import dia as DIA
from . import repulsion as RP


def step_forces_plain(x, dia_w, offsets: tuple, y_res, deg_w, deg_p1, idx,
                      params, *, absolute: bool = False) -> torch.Tensor:
    """The force of kernel D's step, composed of PyTorch ops:
    attract * (y - x * deg_w) + sampled repulsion + gravity, with
    y = y_res + sum_k w_k * x[. + o_k].  ``absolute`` gives each
    element's sum of |terms| instead (the scale of its float32
    rounding)."""
    if absolute:
        x_t = x.abs()
        dia_w = None if dia_w is None else dia_w.abs()
        y_res = None if y_res is None else y_res.abs()
    else:
        x_t = x
    y = DIA.dia_spmv(x_t, dia_w, offsets, y_res)
    if absolute:
        att = params.attract * (y + x_t * deg_w.abs()[:, None])
    else:
        att = params.attract * (y - x * deg_w[:, None])
    rep = RP.repulsion_sampled_plain(x, deg_p1, idx, repel=params.repel,
                                     eps=params.epsilon, absolute=absolute)
    grav = F.gravity_force(x, deg_p1, params.gravity)
    return att + rep + (grav.abs() if absolute else grav)


def speed_update(x, f, f_prev, params) -> torch.Tensor:
    """The step's displacement (swing, speed and the ksmax constraint,
    fused_step.py:116-122)."""
    return F.speed_update(x, f, f_prev, None, ks=params.ks,
                          ksmax=params.ksmax, tolerate=params.tolerate)


def fa_step_fused_plain(x, f_prev, dia_w, offsets: tuple, y_res, deg_w,
                        deg_p1, idx, params):
    """Plain PyTorch version of kernel D: returns (x', f)."""
    f = step_forces_plain(x, dia_w, offsets, y_res, deg_w, deg_p1, idx,
                          params)
    return speed_update(x, f, f_prev, params), f


def fa_step_fused_cuda(x, f_prev, dia_w, dia_off, y_res, deg_w, deg_p1,
                       idx, params):
    """Kernel D on the card.  ``dia_off`` is the [K] int32 device tensor of
    the offsets (K <= 32), ``dia_w`` their [K, n] weights (None when
    K = 0)."""
    RP.check_rows(x, "kernel D")
    n, d = x.shape
    if f_prev.shape != x.shape or f_prev.dtype != x.dtype \
            or f_prev.device != x.device or not f_prev.is_contiguous():
        raise ValueError("f_prev must match x")
    if y_res is not None and (y_res.shape != x.shape or y_res.dtype
                              != x.dtype or y_res.device != x.device
                              or not y_res.is_contiguous()):
        raise ValueError("y_res must match x")
    RP.check_vector(deg_w, x, "deg_w")
    RP.check_vector(deg_p1, x, "deg + 1")
    RP.check_samples(idx, x, "kernel D")
    k = int(dia_off.shape[0])
    if dia_off.device != x.device or dia_off.dtype != torch.int32 \
            or dia_off.dim() != 1 or not dia_off.is_contiguous() \
            or k > DIA.MAX_OFFSETS:
        raise ValueError(f"kernel D takes a contiguous [K <= "
                         f"{DIA.MAX_OFFSETS}] int32 offset tensor on "
                         f"{x.device}")
    if k and (dia_w is None or tuple(dia_w.shape) != (k, n)
              or dia_w.dtype != torch.float32 or dia_w.device != x.device
              or not dia_w.is_contiguous()):
        raise ValueError(f"kernel D takes contiguous float32 [{k}, {n}] "
                         f"DIA weights")
    s = idx.shape[0]
    x_out = torch.empty_like(x)
    f_out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = cuda.library().ge_fused_step(
            n, d, s, k, dia_off.data_ptr(),
            dia_w.data_ptr() if k else None,
            None if y_res is None else y_res.data_ptr(), x.data_ptr(),
            f_prev.data_ptr(), deg_w.data_ptr(), deg_p1.data_ptr(),
            idx.data_ptr(), float(params.repel) * (n / s),
            float(params.epsilon) ** 2, params.attract, params.gravity,
            float(params.ks) * float(params.tolerate), params.tolerate,
            params.ksmax, x_out.data_ptr(), f_out.data_ptr(),
            cuda.stream_of(x))
    cuda.check(rc, "fused_step")
    cuda.LAUNCHES["fused_step"] += 1
    return x_out, f_out


def fa_step_fused(x, f_prev, dia_w, offsets: tuple, dia_off, y_res, deg_w,
                  deg_p1, idx, params):
    """One fused step: kernel D for CUDA tensors, the plain version for CPU
    tensors.  ``offsets`` (a tuple) and ``dia_off`` (its int32 tensor on
    x's device) name the same DIA offsets."""
    if x.is_cuda:
        return fa_step_fused_cuda(x, f_prev, dia_w, dia_off, y_res, deg_w,
                                  deg_p1, idx, params)
    if x.device.type != "cpu":
        raise ValueError(f"fa_step_fused runs on CUDA or the CPU, not "
                         f"{x.device}")
    return fa_step_fused_plain(x, f_prev, dia_w, offsets, y_res, deg_w,
                               deg_p1, idx, params)
