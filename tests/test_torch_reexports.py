"""Every public name that a JAX package ``__init__.py`` binds is bound in
the port's counterpart, and every public function of the JAX modules
ported last (``parallel/multihost.py``, ``utils/profiling.py``) exists in
the port's, apart from ROADMAP.md's "Not carried over" (the compilation
cache).  The JAX files are read as source, not imported."""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("", "embed", "forceatlas", "graph", "harness", "native", "ops",
               "parallel", "partition", "utils")
# XLA's persistent compilation cache (utils/profiling.py): TPU tooling
NOT_CARRIED_OVER = {"enable_compilation_cache", "_host_fingerprint"}


def _bound(path: str) -> set:
    """The public names a module binds at its top level: its relative
    imports, functions, classes and assignments (not the standard library
    or JAX modules it imports)."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_binds_the_reference_names(sub):
    path = os.path.join(REPO, "graph_embed_tpu", sub, "__init__.py")
    want = _bound(path) - NOT_CARRIED_OVER
    port = importlib.import_module(
        ".".join(filter(None, ("graph_embed_tpu_torch", sub))))
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, missing


@pytest.mark.parametrize("module", ["parallel/multihost", "utils/profiling"])
def test_last_modules_are_ported(module):
    want = _bound(os.path.join(REPO, "graph_embed_tpu", module + ".py"))
    port = importlib.import_module(
        "graph_embed_tpu_torch." + module.replace("/", "."))
    missing = sorted(n for n in want - NOT_CARRIED_OVER
                     if not hasattr(port, n))
    assert not missing, missing


def test_subpackage_imports():
    from graph_embed_tpu_torch.embed import embed
    from graph_embed_tpu_torch.graph import Graph
    from graph_embed_tpu_torch.parallel import multihost
    from graph_embed_tpu_torch.utils import profiling

    import graph_embed_tpu_torch as gp

    assert embed is gp.embed and Graph is gp.Graph
    assert multihost.global_mesh and profiling.trace
