"""The port's profiler hooks (``utils/profiling.py``) against the JAX
package's: ``trace`` writes a Chrome trace of the enclosed block with its
``annotate`` regions, ``trace(None)`` traces nothing, and
``edges_per_second`` is the reference's formula."""

import json
import os

import pytest
import torch

from graph_embed_tpu.utils import profiling as jprof

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.utils import profiling


def test_trace_writes_the_annotated_step(tmp_path):
    g = gp.synth.ring_of_cliques(4, 5)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("flat_step"):
            out = gp.force_atlas(g, 2, iterations=2, device="cpu")
    assert prof is not None and out.shape == (g.n, 2)
    path = tmp_path / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "flat_step" for e in events)
    assert any(a.key == "flat_step" for a in prof.key_averages())


def test_trace_none_is_a_noop(tmp_path):
    before = set(os.listdir(tmp_path))
    with profiling.trace(None) as prof:
        with profiling.annotate("nothing"):
            torch.ones(3).sum()
    assert prof is None and set(os.listdir(tmp_path)) == before


@pytest.mark.parametrize("args", [(12_484_608, 20, 0.25), (1, 1, 3.0),
                                  (8_388_608, 100, 1e-3)])
def test_edges_per_second_matches_jax(args):
    assert profiling.edges_per_second(*args) == jprof.edges_per_second(*args)
