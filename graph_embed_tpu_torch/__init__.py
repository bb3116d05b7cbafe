"""graph_embed_tpu_torch: the PyTorch + CUDA port of graph_embed_tpu, the
multilevel graph partitioning and embedding framework modelled on
LLNL/graph-embed.

The JAX package ``graph_embed_tpu`` beside it is the frozen reference.
This package imports ``torch`` and never JAX; its hand-written Hopper
kernels live in ``csrc/`` and build with ``nvcc`` at first use.
"""

from .embed.driver import (build_galerkin_chain, default_base_iterations,
                           embed, embed_graph)
from .embed.minimization import embed_via_minimization
from .embed.via import any_to_multilevel, embed_via
from .forceatlas.flat import compute_forces, fa_step, force_atlas
from .forceatlas.multilevel import force_atlas_multilevel
from .forceatlas.tiled import force_atlas_tiled, prepare_tiled
from .graph import synth
from .graph.algebra import matmul, matvec, scale_cols, scale_rows, transpose
from .graph.components import largest_component, remove_largest
from .graph.csr import (Graph, from_canonical_coo, from_coo, from_dense,
                        from_edges, submatrix)
from .graph.io import (FORMATS, read_adjlist, read_coolist, read_csr,
                       read_graph, read_mtx, read_table, write_coolist,
                       write_coords, write_partition)
from .graph.laplacian import from_laplacian, identity, to_laplacian
from .graph.reorder import apply_order, partition_order, rcm_order
from .graph.synth import community_rmat
from .ops.spgemm import coarsen_graph
from .partition.hierarchy import (HierarchyResult, partition_base,
                                  partition_base2, partition_hierarchy,
                                  partition_num_parts, partition_single,
                                  partition_test)
from .partition.interpolation import Partition, compose, partition_from_labels
from .partition.modularity import modularity
from .utils.params import ForceAtlasParams, MultilevelFAParams, PartitionParams
from .utils.timing import MetricsLogger

__version__ = "0.1.0"
