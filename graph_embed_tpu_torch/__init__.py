"""graph_embed_tpu_torch: the PyTorch + CUDA port of graph_embed_tpu, the
multilevel graph partitioning and embedding framework modelled on
LLNL/graph-embed.

The JAX package ``graph_embed_tpu`` beside it is the frozen reference.
This package imports ``torch`` and never JAX; its hand-written Hopper
kernels live in ``csrc/`` and build with ``nvcc`` at first use.
"""

from .embed.driver import embed, embed_graph, default_base_iterations
from .forceatlas.flat import compute_forces, fa_step, force_atlas
from .forceatlas.tiled import force_atlas_tiled, prepare_tiled
from .graph.csr import Graph, from_canonical_coo, from_coo, from_edges
from .graph.io import FORMATS, read_graph, write_coords
from .partition.hierarchy import HierarchyResult, partition_hierarchy
from .partition.interpolation import Partition
from .utils.params import ForceAtlasParams, MultilevelFAParams, PartitionParams
from .utils.timing import MetricsLogger

__version__ = "0.1.0"
