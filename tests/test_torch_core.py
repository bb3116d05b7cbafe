"""The port's host layers against the JAX package: params, Graph, synth
generators, readers, and the native hierarchy with its Galerkin chain."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.utils import params as jparams

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.graph import io as pio
from graph_embed_tpu_torch.graph import synth as psynth
from graph_embed_tpu_torch.utils import params as pparams


@pytest.mark.parametrize("name", ["ForceAtlasParams", "MultilevelFAParams",
                                  "PartitionParams"])
def test_params_mirror(name):
    want = [(f.name, f.default) for f in
            dataclasses.fields(getattr(jparams, name))]
    got = [(f.name, f.default) for f in
           dataclasses.fields(getattr(pparams, name))]
    assert got == want


def _coo_equal(g_port, g_jax):
    ps, pr, pw = g_port.to_coo_numpy()
    js, jr, jw = g_jax.to_coo_numpy()
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pw, jw)
    assert pw.dtype == jw.dtype


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_coo_and_degrees_match_jax(rng, weighted):
    n = 90
    s = rng.integers(0, n, 400)
    r = rng.integers(0, n, 400)
    w = rng.uniform(0.5, 2.0, 400) if weighted else None
    gj = gt.from_edges(s, r, w, n=n, symmetrize=True, dtype=jnp.float32)
    g = gp.from_edges(s, r, w, n=n, symmetrize=True)
    _coo_equal(g, gj)
    assert g.num_edges == gj.num_edges
    np.testing.assert_array_equal(g.indptr.numpy(), np.asarray(gj.indptr))
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(
        gj.senders)[: gj.num_edges])
    # host float64 degrees are identical; the tensor form rounds them once
    # to float32 where JAX sums in float32 (one ulp)
    for uw in (True, False):
        np.testing.assert_array_equal(g.degrees_numpy(uw),
                                      gj.degrees_numpy(uw))
        np.testing.assert_allclose(g.degrees(uw).numpy(),
                                   np.asarray(gj.degrees(uw)), rtol=1e-6)


def test_synth_generators_identical():
    _coo_equal(psynth.mesh3d(6), jsynth.mesh3d(6))
    _coo_equal(psynth.mesh3d(5, extra_frac=0.1, seed=3),
               jsynth.mesh3d(5, extra_frac=0.1, seed=3))
    _coo_equal(psynth.rmat(9, 8, seed=2), jsynth.rmat(9, 8, seed=2))
    _coo_equal(psynth.ring_of_cliques(5, 4), jsynth.ring_of_cliques(5, 4))


def test_readers_roundtrip(tmp_path, rng):
    n = 30
    s = rng.integers(0, n, 80)
    r = rng.integers(0, n, 80)
    w = np.round(rng.uniform(0.5, 2.0, 80), 3)
    (tmp_path / "g.adj").write_text(
        "".join(f"{a} {b}\n" for a, b in zip(s, r)))
    (tmp_path / "g.coo").write_text(
        "".join(f"{a} {b} {c}\n" for a, b, c in zip(s, r, w)))
    rows = [[] for _ in range(n)]
    for a, b in zip(s, r):
        rows[a].append(str(b))
    (tmp_path / "g.table").write_text("".join(" ".join(x) + "\n"
                                              for x in rows))
    gj = gt.from_edges(s, r, w, n=n, dtype=jnp.float32)
    js, jr, jw = gj.to_coo_numpy()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(js, minlength=n))])
    (tmp_path / "g.csr").write_text(
        f"{n} {n} {js.size}\n" + " ".join(map(str, indptr)) + "\n"
        + " ".join(map(str, jr)) + "\n" + " ".join(map(repr, map(float, jw)))
        + "\n")
    (tmp_path / "g.mtx").write_text(
        "%%MatrixMarket matrix coordinate real general\n"
        f"{n} {n} {s.size}\n"
        + "".join(f"{a + 1} {b + 1} {c}\n" for a, b, c in zip(s, r, w)))
    for fmt, name, sym in [("adjlist", "g.adj", True),
                           ("coolist", "g.coo", True),
                           ("coolist", "g.coo", False),
                           ("table", "g.table", False),
                           ("csr", "g.csr", False), ("mtx", "g.mtx", False)]:
        path = str(tmp_path / name)
        _coo_equal(pio.read_graph(path, fmt, symmetric=sym),
                   gt.read_graph(path, fmt, symmetric=sym))
    g = pio.read_graph(str(tmp_path / "g.coo"), "coolist")
    coords = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    pio.write_coords(coords, str(tmp_path / "p.txt"))
    gt.write_coords(coords.numpy(), str(tmp_path / "j.txt"))
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert g.n == n


@pytest.mark.parametrize("which", ["mesh", "rmat"])
def test_hierarchy_bit_identical_to_jax(which):
    if which == "mesh":
        gj, g = jsynth.mesh3d(10), psynth.mesh3d(10)
    else:
        gj, g = jsynth.rmat(10, 8, seed=1), psynth.rmat(10, 8, seed=1)
    want = gt.partition_hierarchy(gj, 0.1, emit_graphs=True)
    got = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    assert got.level_sizes == want.level_sizes
    assert len(got.level_sizes) > 2
    assert got.modularity == want.modularity
    for pp, pj in zip(got.levels, want.levels):
        assert pp.num_aggs == pj.num_aggs
        np.testing.assert_array_equal(pp.vertex_to_agg_numpy(),
                                      pj.vertex_to_agg_numpy())
        np.testing.assert_array_equal(pp.vertex_to_agg.numpy(),
                                      np.asarray(pj.vertex_to_agg))
    for cp, cj in zip(got.coarse_graphs, want.coarse_graphs):
        _coo_equal(cp, cj)
        np.testing.assert_array_equal(cp.weights.numpy(),
                                      np.asarray(cj.weights)[: cj.num_edges])


def test_interop_carries_jax_state(rng):
    gj = jsynth.mesh3d(5)
    res = gt.partition_hierarchy(gj, 0.2, emit_graphs=True)
    graphs_j = [gj] + res.coarse_graphs
    coos = [(*x.to_coo_numpy(), x.n) for x in graphs_j]
    assign = [(p.vertex_to_agg_numpy(), p.num_aggs) for p in res.levels]
    graphs, parts = interop.hierarchy(coos, assign)
    for a, b in zip(graphs, graphs_j):
        _coo_equal(a, b)
    for p, q in zip(parts, res.levels):
        np.testing.assert_array_equal(p.vertex_to_agg_numpy(),
                                      q.vertex_to_agg_numpy())
        np.testing.assert_array_equal(p.agg_sizes().numpy(),
                                      np.asarray(q.agg_sizes()))
    x = rng.uniform(-1, 1, (7, 3))
    t = interop.tensor(x)
    assert t.dtype == torch.float32 and t.shape == (7, 3)
    np.testing.assert_array_equal(t.numpy(), x.astype(np.float32))


def test_device_coarsener_not_ported():
    """The device coarsener is ported: backend="device" gives the native
    backend's hierarchy."""
    g = psynth.mesh3d(3)
    dev = gp.partition_hierarchy(g, 0.1, backend="device")
    nat = gp.partition_hierarchy(g, 0.1, backend="native")
    assert dev.level_sizes == nat.level_sizes
    for a, b in zip(dev.levels, nat.levels):
        np.testing.assert_array_equal(a.vertex_to_agg_numpy(),
                                      b.vertex_to_agg_numpy())
