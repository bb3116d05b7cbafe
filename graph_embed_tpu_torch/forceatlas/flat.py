"""Flat ForceAtlas2 layout (include/forceatlas.hpp:89-312): the multilevel
embed's base case.  Counterpart of graph_embed_tpu/forceatlas/flat.py.

One iteration reads coords and writes coords in separate phases
(forces -> swing/speed -> displacement), a Python loop over
``fa_step``.  Plain-FA attraction is ``attract * (A_c x - deg_c * x)`` with
the folded constants c_e (forces.fold_edge_weights) in float32: on a CUDA
device it runs through kernel A.  linlog attraction keeps the per-edge
distance and runs through kernel E over the same CSR.  Both kernels own one
row per thread and sum in CSR order, so the card's result is bitwise
repeatable.  ``repulsion="centroids"`` takes the far field of a grouping
(``farfield.py``); without one, ``force_atlas`` builds the JAX package's
default, ``partition_num_parts(g, max(32, n // 64))``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..graph.csr import Graph
from ..ops import edge_spmm as ES
from ..partition.hierarchy import partition_num_parts
from ..utils.device import resolve
from ..utils.params import ForceAtlasParams
from . import farfield as FF
from . import forces as F


@dataclasses.dataclass(frozen=True)
class FlatAttraction:
    """The attraction operator of one graph under one parameter set: the
    folded-weight CSR and its row sums (the row sums serve plain FA only)."""

    csr: ES.EdgeCSR
    deg_c: torch.Tensor
    attract: float
    eps: float
    linlog: bool

    @classmethod
    def build(cls, g: Graph, params: ForceAtlasParams) -> "FlatAttraction":
        s, r, w = g.to_coo_numpy()
        deg = g.degrees_numpy(params.use_weights)
        c = F.fold_edge_weights(w, deg[s], use_weights=params.use_weights,
                                delta=params.delta, nohubs=params.nohubs)
        csr, deg_c = ES.build_csr(s, r, c, g.n, device=g.device)
        return cls(csr=csr, deg_c=deg_c.to(g.dtype), attract=params.attract,
                   eps=params.epsilon, linlog=params.linlog)

    def __call__(self, coords: torch.Tensor, g: Graph) -> torch.Tensor:
        if self.linlog:
            return ES.linlog(coords, self.csr, attract=self.attract,
                             eps=self.eps)
        return ES.attraction_spmv(coords, self.csr, self.deg_c,
                                  attract=self.attract)


def compute_forces(coords, g: Graph, deg, params: ForceAtlasParams, *,
                   attraction: FlatAttraction | None = None,
                   generator: torch.Generator | None = None,
                   sample_idx: torch.Tensor | None = None, groups=None):
    """Total force per vertex for one iteration (forceatlas.hpp:146-212).
    Sampled repulsion takes ``sample_idx`` or draws it from
    ``generator``; centroids repulsion takes ``groups`` (a
    ``farfield.Groups``, built once per layout)."""
    deg_p1 = deg + 1.0
    eps = params.epsilon
    if params.repulsion == "exact":
        rep = F.repulsion_exact(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "gram":
        rep = F.repulsion_gram(coords, deg_p1, params.repel, eps)
    elif params.repulsion == "sampled":
        if sample_idx is None:
            if generator is None:
                raise ValueError("sampled repulsion needs a generator")
            sample_idx = torch.randint(0, g.n, (params.num_negative_samples,),
                                       generator=generator,
                                       device=coords.device)
        rep = F.repulsion_sampled(coords, deg_p1, params.repel, eps,
                                  sample_idx)
    elif params.repulsion == "centroids":
        if groups is None:
            raise ValueError("centroids repulsion needs its groups "
                             "(farfield.Groups)")
        rep = FF.centroid_repulsion(coords, deg_p1, groups, params.repel,
                                    eps)
    else:
        raise ValueError(f"unknown repulsion {params.repulsion!r}")
    if attraction is None:
        attraction = FlatAttraction.build(g, params)
    att = attraction(coords, g)
    grav = F.gravity_force(coords, deg_p1, params.gravity)
    return rep + att + grav


def fa_step(coords, forces_prev, g: Graph, deg, params: ForceAtlasParams,
            *, attraction: FlatAttraction | None = None,
            generator: torch.Generator | None = None,
            sample_idx: torch.Tensor | None = None, groups=None):
    """One full iteration; returns (coords', forces)."""
    f = compute_forces(coords, g, deg, params, attraction=attraction,
                       generator=generator, sample_idx=sample_idx,
                       groups=groups)
    new_coords = F.speed_update(coords, f, forces_prev, deg + 1.0,
                                ks=params.ks, ksmax=params.ksmax,
                                tolerate=params.tolerate)
    return new_coords, f


def force_atlas(g: Graph, dim: int = 2, *, coords=None, seed: int = 0,
                params: ForceAtlasParams | None = None,
                iterations: int | None = None, groups=None,
                device="cuda") -> torch.Tensor:
    """Flat ForceAtlas layout on ``device`` (the graph moves there; the
    card by default, the CPU only when asked for).

    ``coords`` warm-starts the layout (forceatlas.hpp:118-125); otherwise
    U(-1, 1)^dim init from a ``torch.Generator`` seeded with ``seed``,
    which also draws the sampled repulsion's partners.  ``groups`` (a
    Partition) are the centroids repulsion's; by default
    ``partition_num_parts(g, max(32, n // 64))`` (flat.py:153-157).
    ``x_precision`` has no effect here, as in the reference's flat.py."""
    params = params or ForceAtlasParams()
    if iterations is None:
        iterations = params.iterations
    g = g.to(resolve(device))
    gen = torch.Generator(device=g.device).manual_seed(int(seed))
    if coords is None:
        coords = (torch.rand((g.n, dim), generator=gen, dtype=g.dtype,
                             device=g.device) * 2.0 - 1.0)
    else:
        coords = torch.as_tensor(coords, dtype=g.dtype).to(g.device)
    deg = g.degrees(params.use_weights)
    attraction = FlatAttraction.build(g, params)
    if params.repulsion == "centroids":
        if groups is None:
            groups = partition_num_parts(g, max(32, g.n // 64))
        groups = FF.Groups.build(groups, g.device)
    forces_prev = torch.zeros_like(coords)
    for _ in range(iterations):
        coords, forces_prev = fa_step(coords, forces_prev, g, deg, params,
                                      attraction=attraction, generator=gen,
                                      groups=groups)
    if params.normalize:
        coords = F.normalize_coords(coords)
    return coords
