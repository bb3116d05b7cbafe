from . import radii, driver, minimization, via, checkpoint
from .driver import embed, embed_graph, build_galerkin_chain, validate_hierarchy
from .minimization import embed_via_minimization
from .via import any_to_multilevel, embed_via
from .checkpoint import CheckpointStore, embed_resumable
