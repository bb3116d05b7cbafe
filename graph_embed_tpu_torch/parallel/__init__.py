"""Multi-shard designs, each process's shards stacked on its one device:
the replicated flat step (the default of ``embed(mesh=...)``), the
halo-exchange flat step with its ring overlap, the aggregate-sharded
refinement, and a mesh over processes (``multihost``)."""

from .mesh import EDGE_AXIS, edge_sharding, make_mesh, replicated
from .sharded import (make_sharded_fa_step, pad_graph_for_mesh,
                      sharded_force_atlas)
from .sharded_ml import prepare_refine_sharded, refine_level_sharded
from . import multihost
