"""The flat tiled ForceAtlas step: the iteration that bench.py times.

Counterpart of graph_embed_tpu/forceatlas/tiled.py.  One host plan per
graph (``prepare_tiled``), then per iteration:

* sampled repulsion, not linlog (every bench graph): kernel A's unit or
  weighted SpMV over the residual edges, if any, then kernel D, the whole
  iteration in one launch (DIA attraction, sampled repulsion, gravity,
  swing and speed);
* linlog: kernel E (per-edge attraction with the distance) and, for
  sampled repulsion, kernel C, then the speed update in PyTorch;
* gram or exact repulsion: the attraction as above (DIA part in PyTorch,
  residual on kernel A) and the repulsion of forceatlas/forces.py.

The state is row-major [n, d]; the reference's transposed [D_PAD, n_pad]
state, its slab and BSR tilings and its near/far offset split are TPU
layout and have no counterpart (ROADMAP "Not carried over").  On CPU
tensors every kernel runs its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops import dia as DIA
from ..ops import edge_spmm as ES
from ..ops import fused_step as FS
from ..ops import repulsion as RP
from ..utils.params import ForceAtlasParams
from . import forces as F

SPMV_MODES = ("auto", "dia", "packed", "bsr")


@dataclasses.dataclass(frozen=True)
class TiledFA:
    """Per-graph state of the tiled step, built once on the host.

    ``csr`` holds the residual edges (those no DIA offset absorbed) with
    folded weights truncated to bf16 as the reference packer stores them,
    or None for unit weights (kernel A's unit mode); None as a whole when
    the DIA plan absorbed every edge.  Under linlog it holds every edge
    with its folded float32 weight (kernel E).  ``deg_w_att`` are the row
    sums exactly as the attraction applies them (zero under linlog)."""

    csr: ES.EdgeCSR | None
    deg_p1: torch.Tensor     # [n] degree + 1 (forceatlas.hpp:127-140)
    deg_w_att: torch.Tensor  # [n]
    dia_off: torch.Tensor    # [K] int32 DIA offsets on the device, K >= 0
    n: int
    dim: int
    linlog: bool = False
    dia_w: torch.Tensor | None = None  # [K, n] float32
    dia_offsets: tuple = ()            # the same K offsets, plan order

    @property
    def device(self) -> torch.device:
        return self.deg_p1.device


def prepare_tiled(g: Graph, dim: int, params: ForceAtlasParams,
                  *, tile: int | None = None, interpret: bool | None = None,
                  min_pair_edges: int = 0,
                  sender_block: int | None = None,
                  window: int | None = None,
                  spmv_mode: str = "auto",
                  dia_min_count: int | None = None,
                  tiered_specs=None,
                  tiered_thresholds=None) -> TiledFA:
    """Plan the tiled step on ``g``'s device (host numpy, once per graph).

    ``spmv_mode`` 'auto' and 'dia' plan the DIA offsets (honouring
    ``dia_min_count``); 'packed' and 'bsr' keep every edge on kernel A.
    The keywords of the reference's slab tilings (``tile``,
    ``min_pair_edges``, ``sender_block``, ``window``) and ``interpret``
    are accepted and shape nothing here."""
    if spmv_mode not in SPMV_MODES:
        raise ValueError(f"unknown spmv_mode {spmv_mode!r}")
    if tiered_specs is not None:
        raise NotImplementedError(
            "tiered tilings are TPU layout, not ported (ROADMAP, "
            "\"Not carried over\")")
    if params.x_precision != "f32":
        raise NotImplementedError(
            "x_precision='bf16' is not ported yet (ROADMAP queue 1, "
            "item 4)")
    dev = g.device
    s, r, w = g.to_coo_numpy()
    deg = g.degrees_numpy(params.use_weights)
    folded = np.asarray(F.fold_edge_weights(
        w, deg[s], use_weights=params.use_weights, delta=params.delta,
        nohubs=params.nohubs), dtype=np.float64)
    deg_t = torch.from_numpy(deg.astype(np.float32)).to(dev)
    common = dict(deg_p1=deg_t + 1.0, n=g.n, dim=dim,
                  dia_off=torch.zeros(0, dtype=torch.int32, device=dev))
    if params.linlog:
        # distance-dependent magnitude: every edge, float32 weights
        csr, _ = ES.build_csr(s, r, folded, g.n, device=dev)
        return TiledFA(csr=csr, deg_w_att=torch.zeros_like(deg_t),
                       linlog=True, **common)

    unit = bool(np.all(folded == 1.0))
    dia = None
    if spmv_mode in ("auto", "dia"):
        dia = DIA.plan_dia(s, r, folded, g.n, min_count=dia_min_count)
    deg_w = np.zeros(g.n, np.float32)
    csr = None
    mask = None if dia is None else dia.residual_mask
    if mask is None or mask.any():
        if mask is not None:
            s, r, folded = s[mask], r[mask], folded[mask]
        # residual weights as the reference packer stores them: truncated
        # toward zero to bf16; the row sums from those same weights
        csr, deg_w = ES.build_csr(
            s, r, None if unit else ES.truncate_bf16(folded), g.n,
            device=dev)
        deg_w = deg_w.cpu().numpy()
    if dia is not None:
        deg_w = deg_w + DIA.dia_row_sums(dia.weights)
        common.update(
            dia_w=torch.from_numpy(dia.weights).to(dev),
            dia_offsets=dia.offsets,
            dia_off=torch.tensor(dia.offsets, dtype=torch.int32,
                                 device=dev))
    return TiledFA(csr=csr, deg_w_att=torch.from_numpy(deg_w).to(dev),
                   **common)


def _sample_ids(tfa: TiledFA, params: ForceAtlasParams, sample_idx,
                generator) -> torch.Tensor:
    if sample_idx is not None:
        return sample_idx.to(tfa.device, torch.int32).contiguous()
    if generator is None:
        raise ValueError("sampled repulsion needs sample ids or a generator")
    return RP.draw_samples(tfa.n, params.num_negative_samples, generator,
                           tfa.device)


def _attraction(x, tfa: TiledFA, params: ForceAtlasParams):
    """The attraction term: kernel E under linlog, else
    attract * (A_dia x + A_res x - x * deg_w)."""
    if tfa.linlog:
        return ES.linlog(x, tfa.csr, attract=params.attract,
                         eps=params.epsilon)
    y = None if tfa.csr is None else ES.spmv(x, tfa.csr)
    y = DIA.dia_spmv(x, tfa.dia_w, tfa.dia_offsets, y)
    return params.attract * (y - x * tfa.deg_w_att[:, None])


def tiled_forces(x, tfa: TiledFA, params: ForceAtlasParams, *,
                 sample_idx: torch.Tensor | None = None,
                 generator: torch.Generator | None = None):
    """Total force [n, dim] of one iteration, composed term by term (the
    fused step's reference)."""
    eps = params.epsilon
    att = _attraction(x, tfa, params)
    if params.repulsion == "sampled":
        idx = _sample_ids(tfa, params, sample_idx, generator)
        rep = RP.repulsion_sampled(x, tfa.deg_p1, idx, repel=params.repel,
                                   eps=eps)
    elif params.repulsion == "gram":
        rep = F.repulsion_gram(x, tfa.deg_p1, params.repel, eps)
    elif params.repulsion == "exact":
        rep = F.repulsion_exact(x, tfa.deg_p1, params.repel, eps)
    else:
        raise NotImplementedError(
            f"{params.repulsion!r} repulsion is not ported to the tiled "
            "step (ROADMAP queue 1, item 5)")
    grav = F.gravity_force(x, tfa.deg_p1, params.gravity)
    return rep + att + grav


def fused_applies(tfa: TiledFA, params: ForceAtlasParams) -> bool:
    """Whether the step takes kernel D (the reference's fused branch,
    tiled.py:343-347): sampled repulsion, not linlog, and some
    attraction (DIA offsets or residual edges)."""
    return (params.repulsion == "sampled" and not tfa.linlog
            and (bool(tfa.dia_offsets) or tfa.csr is not None))


def fa_step_tiled(x, f_prev, tfa: TiledFA, params: ForceAtlasParams, *,
                  sample_idx: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """One full iteration; returns (x', f).  Sampled repulsion takes
    ``sample_idx`` ([s] ids) or draws them from ``generator``."""
    if fused_applies(tfa, params):
        idx = _sample_ids(tfa, params, sample_idx, generator)
        y_res = None if tfa.csr is None else ES.spmv(x, tfa.csr)
        return FS.fa_step_fused(x, f_prev, tfa.dia_w, tfa.dia_offsets,
                                tfa.dia_off, y_res, tfa.deg_w_att,
                                tfa.deg_p1, idx, params)
    f = tiled_forces(x, tfa, params, sample_idx=sample_idx,
                     generator=generator)
    return FS.speed_update(x, f, f_prev, params), f


def tiled_loop(x0, tfa: TiledFA, params: ForceAtlasParams, iterations: int,
               *, generator: torch.Generator | None = None,
               sample_ids=None) -> torch.Tensor:
    """``iterations`` steps from ``x0`` with f_prev = 0, then the optional
    normalization (the reference's _tiled_loop_T / _tiled_loop, :387 and
    :403).  ``sample_ids`` optionally gives the ids of every step (a
    sequence of [s] tensors) in place of draws from ``generator``."""
    x = x0
    f = torch.zeros_like(x0)
    for it in range(iterations):
        idx = None if sample_ids is None else sample_ids[it]
        x, f = fa_step_tiled(x, f, tfa, params, sample_idx=idx,
                             generator=generator)
    if params.normalize:
        x = F.normalize_coords(x)
    return x


def force_atlas_tiled(g: Graph, dim: int = 2, *, coords=None, seed: int = 0,
                      params: ForceAtlasParams | None = None,
                      iterations: int | None = None,
                      tile: int | None = None) -> torch.Tensor:
    """Flat ForceAtlas layout on the tiled step, on ``g``'s device (drop-in
    for flat.force_atlas; sampled repulsion by default).

    ``coords`` warm-starts the layout; otherwise U(-1, 1)^dim from a
    ``torch.Generator`` seeded with ``seed``, which also draws the sample
    ids of every step."""
    params = params or ForceAtlasParams(repulsion="sampled")
    if iterations is None:
        iterations = params.iterations
    gen = torch.Generator(device=g.device).manual_seed(int(seed))
    if coords is None:
        x0 = (torch.rand((g.n, dim), generator=gen, dtype=torch.float32,
                         device=g.device) * 2.0 - 1.0)
    else:
        x0 = torch.as_tensor(coords, dtype=torch.float32).to(g.device)
    tfa = prepare_tiled(g, dim, params, tile=tile)
    return tiled_loop(x0.contiguous(), tfa, params, iterations,
                      generator=gen)
