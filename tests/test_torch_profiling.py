"""The port's profiler hooks (``utils/profiling.py``): ``trace`` writes a
Chrome trace of the enclosed block, in which the program's spans
(``MetricsLogger`` phases and ``timing.span`` sub-spans) are named
regions, and ``trace(None)`` traces nothing."""

import json
import os

import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.utils import profiling, timing


def test_trace_writes_the_annotated_step(tmp_path):
    g = gp.synth.ring_of_cliques(4, 5)
    metrics = timing.MetricsLogger()
    with profiling.trace(str(tmp_path)) as prof, timing.use(metrics):
        with metrics.span("flat_step", "cpu"):
            out = gp.force_atlas(g, 2, iterations=2, device="cpu")
    assert prof is not None and out.shape == (g.n, 2)
    path = tmp_path / "trace.json"
    names = {e.get("name")
             for e in json.loads(path.read_text())["traceEvents"]}
    # the phase and the flat layout's own sub-span, as recorded
    assert {"flat_step", "base.loop"} <= names
    assert {"flat_step", "base.loop"} <= {a.key for a in prof.key_averages()}
    (rec,) = metrics.records
    assert [sp["name"] for sp in rec["sub"]] == ["base.loop"]


def test_trace_none_is_a_noop(tmp_path):
    before = set(os.listdir(tmp_path))
    metrics = timing.MetricsLogger()
    with profiling.trace(None) as prof, timing.use(metrics):
        with timing.span("nothing"):
            torch.ones(3).sum()
    assert prof is None and set(os.listdir(tmp_path)) == before
