"""Config dataclasses, field for field the JAX package's
(graph_embed_tpu/utils/params.py).  Defaults follow the reference
(forceatlas.hpp:92-103,320-331; partitioner.hpp:40-53); the comments on
each extension field live beside the JAX definitions."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ForceAtlasParams:
    """ForceAtlas2 knobs.  ``repulsion``: 'exact' (per-pair differences),
    'gram' (|xi-xj|^2 from the gram identity, full-f32 matmuls) or
    'sampled' (unbiased negative-sampling estimator).  ``x_precision``
    'bf16' gathers x rounded to bf16 in the SpMVs where the reference's
    dispatch would (kernel A's bf16x mode); elsewhere it has no effect."""

    iterations: int = 100_000
    ks: float = 0.1
    ksmax: float = 1.0
    repel: float = 1.0
    attract: float = 1.0
    gravity: float = 1.0
    use_weights: bool = True
    linlog: bool = False
    nohubs: bool = False
    delta: float = 1.0
    tolerate: float = 1.0
    normalize: bool = False
    repulsion: str = "gram"
    num_negative_samples: int = 256
    epsilon: float = 1e-5
    x_precision: str = "f32"


@dataclasses.dataclass(frozen=True)
class MultilevelFAParams(ForceAtlasParams):
    """forceAtlasMultilevel knobs; the embed driver runs 100 iterations per
    level.  Aggregates whose slot size class reaches
    ``sampled_slots_threshold`` use the sampled within-aggregate repulsion
    (0 = always exact)."""

    iterations: int = 10
    pull: float = 100.0
    sampled_slots_threshold: int = 2048


@dataclasses.dataclass(frozen=True)
class PartitionParams:
    """Coarsener knobs (the native coarsener reads every field)."""

    printing: bool = False
    positive_merging: bool = True
    stall_stop_threshold: float = 1.0
    matching_iterations: int = 2
    merge_leaves: bool = False
    weight_jitter: float = 0.0
    tie_break: str = "hash"
    max_agg_size: int = 0
    cap_unit: str = "level"
    absorb_below: float = 0.05
    force_coarsen_to: int = 64
