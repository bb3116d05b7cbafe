"""The port's entry points against the JAX package: the run-tests harness,
its helpers, the viz HTML, the multilevel partition dump, and the CLI's
``run-tests`` and ``embedder`` commands end to end on the CPU.

Tolerance: harness records equal the JAX package's key for key with the
seconds left out; the modularities are float32 sums in another order and
agree within 1e-6.  The helpers are numpy in both packages and agree
exactly; the viz HTML is byte-equal.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu import viz as jviz
from graph_embed_tpu.graph import io as jio
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.harness import runtests as jrt

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import viz as pviz
from graph_embed_tpu_torch.graph import io as pio
from graph_embed_tpu_torch.harness import runtests as prt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = ("partition_seconds", "variant_seconds", "louvain_seconds")


@pytest.mark.parametrize("spec", ["synth:planted:4:30:0.3:0.01",
                                  "synth:ring:6:5"])
def test_run_test_records_match_jax(spec):
    kw = dict(do_heuristics=True, has_true_communities=True)
    want = jrt.run_test(spec, out=io.StringIO(), **kw)
    out = io.StringIO()
    got = prt.run_test(spec, device="cpu", out=out, **kw)
    assert json.loads(out.getvalue()) == got
    assert set(got) == set(want)
    for key, value in want.items():
        if key in TIMING:
            continue
        if key.endswith("modularity"):
            assert got[key] == pytest.approx(value, abs=1e-6), key
        else:
            assert got[key] == value, key


def test_harness_helpers_match_jax(tmp_path, rng):
    a = rng.integers(0, 5, 200)
    b = rng.integers(0, 7, 200)
    assert (prt.pair_counting_similarity(a, b)
            == jrt.pair_counting_similarity(a, b))
    cmty = tmp_path / "g.cmty"
    cmty.write_text("0 1 2\n3 4\n5 1\n")
    np.testing.assert_array_equal(prt.read_cmty(cmty, 8),
                                  jrt.read_cmty(cmty, 8))
    tree = tmp_path / "g.tree"
    tree.write_text("0 0\n1 0\n2 1\n3 1\n0 0\n1 0\n")
    np.testing.assert_array_equal(prt.read_louvain_aggregates(tree),
                                  jrt.read_louvain_aggregates(tree))
    gj = jsynth.mesh3d(4)
    g = gp.synth.mesh3d(4)
    x = rng.normal(size=(g.n, 3))
    assert prt.layout_stress(g, torch.from_numpy(x)) == jrt.layout_stress(
        gj, x)


def test_viz_html_byte_equal(tmp_path, rng):
    gj = jsynth.mesh3d(4)
    res = gt.partition_hierarchy(gj, 0.3, backend="native")
    assigns = [p.vertex_to_agg_numpy() for p in res.levels]
    s, r, _ = gj.to_coo_numpy()
    coords = rng.normal(size=(gj.n, 3))
    for mod, tag in ((jviz, "j"), (pviz, "p")):
        mod.write_embedding_html(coords, (s, r), tmp_path / f"{tag}.html",
                                 level_assignments=assigns)
        mod.write_embedding_html(coords[:, :2], (s, r),
                                 tmp_path / f"{tag}2.html", max_points=20)
    pviz.write_embedding_html(torch.from_numpy(coords), (s, r),
                              tmp_path / "t.html", level_assignments=assigns)
    for a, b in (("j", "p"), ("j2", "p2"), ("j", "t")):
        assert ((tmp_path / f"{a}.html").read_bytes()
                == (tmp_path / f"{b}.html").read_bytes())
    np.testing.assert_array_equal(pviz.vertex_colors(assigns, gj.n),
                                  jviz.vertex_colors(assigns, gj.n))


def test_multilevel_partition_round_trip(tmp_path):
    """write_multilevel_partition's bytes equal the JAX writer's, and
    ``_read_multilevel_partition`` gives the assignments back."""
    g = gp.synth.mesh3d(5)
    res = gp.partition_hierarchy(g, 0.3)
    assigns = [p.vertex_to_agg for p in res.levels]
    pio.write_multilevel_partition(assigns, tmp_path / "p.part")
    jio.write_multilevel_partition([a.numpy() for a in assigns],
                                   tmp_path / "j.part")
    assert ((tmp_path / "p.part").read_bytes()
            == (tmp_path / "j.part").read_bytes())
    back = pviz._read_multilevel_partition(tmp_path / "p.part")
    assert [len(a) for a in back] == res.level_sizes[:-1]
    for a, b in zip(back, assigns):
        np.testing.assert_array_equal(a, b.numpy())


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "graph_embed_tpu_torch.cli",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=300)


def test_cli_run_tests_on_cpu():
    proc = _cli("run-tests", "synth:ring:6:5", "-heuristics", "-device",
                "cpu")
    assert proc.returncode == 0, proc.stderr
    records = [json.loads(line) for line in proc.stdout.splitlines()]
    assert len(records) == 1
    want = jrt.run_test("synth:ring:6:5", do_heuristics=True,
                        out=io.StringIO())
    assert records[0]["aggregates"] == want["aggregates"] == 6
    assert records[0]["modularity"] == pytest.approx(want["modularity"],
                                                     abs=1e-6)
    assert "kernel launches: {}" in proc.stderr


def test_cli_embedder_on_cpu(tmp_path):
    """The embedder pipeline on a ring of cliques plus an isolated edge
    (dropped as a second component): coords, partition dump and the HTML
    plot with one point per vertex."""
    K, C = 6, 8
    i, j = np.triu_indices(K, 1)
    lines = []
    for c in range(C):
        lines += [f"{c * K + a} {c * K + b}" for a, b in zip(i, j)]
        lines.append(f"{c * K} {((c + 1) % C) * K}")
    lines.append(f"{K * C} {K * C + 1}")
    src = tmp_path / "g.txt"
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "out"
    proc = _cli("embedder", "-f", str(src), "-outdir", str(out), "-plot",
                "true", "-device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "(native parser)" in proc.stdout
    n = K * C
    coords = np.loadtxt(out / "coords.temp", ndmin=2)
    assert coords.shape == (n, 3) and np.isfinite(coords).all()
    sizes = [int(x) for x in
             proc.stdout.split("partitioned!")[1].splitlines()[1].split()]
    back = pviz._read_multilevel_partition(out / "part.temp")
    assert [len(a) for a in back] == sizes[:-1] and sizes[0] == n
    html = (out / "plot.html").read_text()
    verts = json.loads(html.split("const V=")[1].split(", E=")[0])
    assert len(verts) == n


@pytest.mark.parametrize("entry", ["embed", "embed_graph", "embed_via",
                                   "run_test", "run_embed_test"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` these entry points run on CUDA (through
    ``utils.device.resolve``); without a card they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    g = gp.synth.ring_of_cliques(3, 4)
    res = gp.partition_hierarchy(g, 0.5, emit_graphs=True)
    graphs = [g] + res.coarse_graphs
    calls = {
        "embed": lambda: gp.embed(graphs, res.levels, 2),
        "embed_graph": lambda: gp.embed_graph(g, 2),
        "embed_via": lambda: gp.embed_via(
            graphs, res.levels, 2,
            gp.any_to_multilevel(lambda sub, dim, seed=0: None)),
        "run_test": lambda: prt.run_test("synth:ring:3:4",
                                         out=io.StringIO()),
        "run_embed_test": lambda: prt.run_embed_test("synth:ring:3:4",
                                                     out=io.StringIO()),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
