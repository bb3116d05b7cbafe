"""graph_embed_tpu_torch: the PyTorch + CUDA port of graph_embed_tpu, the
multilevel graph partitioning and embedding framework modelled on
LLNL/graph-embed.

The JAX package ``graph_embed_tpu`` beside it is the frozen reference.
This package imports ``torch`` and never JAX; its hand-written Hopper
kernels live in ``csrc/`` and build with ``nvcc`` at first use.
"""

from .embed.driver import embed, embed_graph, default_base_iterations
from .embed.minimization import embed_via_minimization
from .embed.via import any_to_multilevel, embed_via
from .forceatlas.flat import compute_forces, fa_step, force_atlas
from .forceatlas.multilevel import force_atlas_multilevel
from .forceatlas.tiled import force_atlas_tiled, prepare_tiled
from .graph import synth
from .graph.csr import Graph, from_canonical_coo, from_coo, from_edges
from .graph.io import FORMATS, read_graph, write_coords
from .graph.reorder import apply_order, partition_order, rcm_order
from .graph.synth import community_rmat
from .partition.hierarchy import (HierarchyResult, partition_hierarchy,
                                  partition_num_parts, partition_single)
from .partition.interpolation import Partition, compose, partition_from_labels
from .utils.params import ForceAtlasParams, MultilevelFAParams, PartitionParams
from .utils.timing import MetricsLogger

__version__ = "0.1.0"
