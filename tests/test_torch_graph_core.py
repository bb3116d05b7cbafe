"""The port's graph core against the JAX package: the tests/test_graph.py
cases run through both packages on the same seeded inputs.

Tolerance: the host rebuilds (submatrix, Laplacian, algebra, readers,
writers, synth, the disk cache) are numpy in both packages and must agree
exactly; ``matvec`` and ``row_sums`` are float64 sums on the CPU and agree
within 1e-12 relative (the JAX package sums with XLA's scatter, the port
row by row in order); components are integer labels, exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.graph import algebra as jalgebra
from graph_embed_tpu.graph import synth as jsynth

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.graph import algebra as palgebra
from graph_embed_tpu_torch.graph import components as pcomp
from graph_embed_tpu_torch.graph import csr as pcsr
from graph_embed_tpu_torch.graph import io as pio
from graph_embed_tpu_torch.graph import synth as psynth

from conftest import random_graph

F64 = torch.float64


def _port(gj, dtype=F64):
    return interop.graph(*gj.to_coo_numpy(), gj.n, dtype=dtype)


def _coo_equal(a, b):
    for x, y in zip(a.to_coo_numpy(), b.to_coo_numpy()):
        np.testing.assert_array_equal(x, y)
    assert a.n == b.n and a.num_edges == b.num_edges


def test_from_dense_scipy_and_helpers(rng):
    import scipy.sparse as sp

    gj = random_graph(rng, 40)
    dense = gj.to_dense_numpy()
    g = gp.from_dense(dense, dtype=F64)
    _coo_equal(g, gt.from_dense(dense, dtype=jnp.float64))
    _coo_equal(pcsr.from_scipy(sp.coo_matrix(dense), dtype=F64),
               gt.graph.csr.from_scipy(sp.coo_matrix(dense),
                                       dtype=jnp.float64))
    np.testing.assert_array_equal(g.to_dense_numpy(), dense)
    np.testing.assert_array_equal(g.row_counts().numpy(),
                                  np.asarray(gj.row_counts()))
    np.testing.assert_allclose(g.row_sums().numpy(),
                               np.asarray(gj.row_sums()), rtol=1e-12)
    assert float(g.total_weight()) == pytest.approx(
        float(gj.total_weight()), rel=1e-12)


def test_submatrix(rng):
    gj = random_graph(rng, 20)
    keep = np.array([3, 5, 7, 11, 13])
    sub = gp.submatrix(_port(gj), keep)
    _coo_equal(sub, gt.submatrix(gj, keep))
    np.testing.assert_allclose(sub.to_dense_numpy(),
                               gj.to_dense_numpy()[np.ix_(keep, keep)])


def test_laplacian_roundtrip(rng):
    gj = random_graph(rng, 25)
    g = _port(gj)
    lap = gp.to_laplacian(g)
    _coo_equal(lap, gt.to_laplacian(gj))
    _coo_equal(gp.from_laplacian(lap), gt.from_laplacian(gt.to_laplacian(gj)))
    _coo_equal(gp.identity(7, dtype=F64), gt.identity(7, dtype=jnp.float64))


def test_algebra_surface(rng):
    gj = random_graph(rng, 20)
    g = _port(gj)
    v = rng.uniform(0.5, 2, 20)
    _coo_equal(palgebra.transpose(g), jalgebra.transpose(gj))
    _coo_equal(palgebra.matmul(g, g), jalgebra.matmul(gj, gj))
    _coo_equal(palgebra.scale_rows(g, v), jalgebra.scale_rows(gj, v))
    _coo_equal(palgebra.scale_cols(g, v), jalgebra.scale_cols(gj, v))
    for shape in ((20,), (20, 3), (20, 6)):
        x = rng.normal(size=shape)
        want = np.asarray(jalgebra.matvec(gj, jnp.asarray(x)))
        got = palgebra.matvec(g, torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["two_components", "mesh", "random"])
def test_components(rng, case):
    if case == "two_components":
        gj = gt.from_edges([0, 1, 2, 3], [1, 2, 0, 4], None, n=5,
                           symmetrize=True)
    elif case == "mesh":
        gj = jsynth.mesh3d(4)
    else:
        gj = random_graph(rng, 200, avg_deg=1, dtype="float32")
    g = _port(gj, torch.float32)
    from graph_embed_tpu.graph import components as jcomp

    np.testing.assert_array_equal(pcomp.component_labels(g),
                                  jcomp.component_labels(gj))
    sub, verts = gp.largest_component(g)
    sub_j, verts_j = gt.largest_component(gj)
    np.testing.assert_array_equal(verts, verts_j)
    _coo_equal(sub, sub_j)
    sub, verts = gp.remove_largest(g, 0.5)
    sub_j, verts_j = gt.remove_largest(gj, 0.5)
    np.testing.assert_array_equal(verts, verts_j)
    _coo_equal(sub, sub_j)


def test_io_readers_and_fastload(tmp_path, rng):
    """The edge lists go through the native parser in both packages; its
    result equals the port's loadtxt route on the same files."""
    gj = random_graph(rng, 20)
    s, r, w = gj.to_coo_numpy()
    p = tmp_path / "g.coolist"
    with open(p, "w") as f:
        for i, j, v in zip(s, r, w):
            f.write(f"{i} {j} {v}\n")
    (tmp_path / "g.adjlist").write_text("# c\n0 1\n1 2\n% c\n2 5\n")
    before = dict(pio.PARSES)
    for name, fmt, kw in (("g.coolist", "coolist", {}),
                          ("g.adjlist", "adjlist", {"symmetric": True})):
        path = str(tmp_path / name)
        got = gp.read_graph(path, fmt, dtype=F64, **kw)
        _coo_equal(got, gt.read_graph(path, fmt, dtype=jnp.float64, **kw))
        data = np.loadtxt(path, comments=("%", "#"), ndmin=2)
        ws = data[:, 2] if fmt == "coolist" else None
        _coo_equal(got, gp.from_edges(data[:, 0].astype(np.int64),
                                      data[:, 1].astype(np.int64), ws,
                                      symmetrize=kw.get("symmetric", False),
                                      dtype=F64))
    assert pio.PARSES["native"] == before.get("native", 0) + 2
    p3 = tmp_path / "g.mtx"
    p3.write_text("%%MatrixMarket matrix coordinate real symmetric\n"
                  "3 3 2\n1 2 1.5\n2 3 2.0\n")
    _coo_equal(gp.read_mtx(str(p3), dtype=F64),
               gt.read_mtx(str(p3), dtype=jnp.float64))
    p4 = tmp_path / "g.table"
    p4.write_text("1 2\n0\n0\n")
    _coo_equal(gp.read_table(str(p4)), gt.read_table(str(p4)))
    p5 = tmp_path / "g.csr"
    p5.write_text("2 2 2\n0 1 2\n1 0\n3.0 4.0\n")
    _coo_equal(gp.read_csr(str(p5), dtype=F64),
               gt.read_csr(str(p5), dtype=jnp.float64))


def test_writers_match_jax(tmp_path, rng):
    gj = random_graph(rng, 15)
    g = _port(gj)
    v2a = rng.integers(0, 4, 15)
    files = []
    for pkg, gg, tag in ((gt, gj, "j"), (gp, g, "p")):
        pkg.write_partition(v2a, tmp_path / f"part.{tag}")
        pkg.write_coolist(gg, tmp_path / f"coo.{tag}")
        files.append(tag)
    gp.write_partition(torch.from_numpy(v2a), tmp_path / "part.t")
    for stem in ("part", "coo"):
        assert ((tmp_path / f"{stem}.p").read_bytes()
                == (tmp_path / f"{stem}.j").read_bytes())
    assert ((tmp_path / "part.t").read_bytes()
            == (tmp_path / "part.j").read_bytes())


def test_synth_planted_partition_matches_jax():
    for args, kw in (((4, 30), dict(p_in=0.5, p_out=0.01, seed=0)),
                     ((6, 25), dict(seed=3))):
        g, labels = psynth.planted_partition(*args, **kw)
        gj, labels_j = jsynth.planted_partition(*args, **kw)
        _coo_equal(g, gj)
        np.testing.assert_array_equal(labels, labels_j)


def test_synth_cached_bit_identical(tmp_path):
    g1 = psynth.cached("rmat", 10, 8, seed=3, cache_dir=str(tmp_path))
    g2 = psynth.cached("rmat", 10, 8, seed=3, cache_dir=str(tmp_path))
    _coo_equal(g1, g2)
    _coo_equal(g1, jsynth.rmat(10, 8, seed=3))
    assert torch.equal(g1.indptr, g2.indptr)
    gpl, lab = psynth.cached("planted_partition", 6, 30, seed=1,
                             cache_dir=str(tmp_path))
    gpl2, lab2 = psynth.cached("planted_partition", 6, 30, seed=1,
                               cache_dir=str(tmp_path))
    _coo_equal(gpl, gpl2)
    np.testing.assert_array_equal(lab, lab2)
    s, r, w, n = psynth.cached_arrays("rmat", 10, 8, seed=3,
                                      cache_dir=str(tmp_path))
    _coo_equal(gp.from_canonical_coo(s, r, w, n), g1)
    assert len(os.listdir(tmp_path)) == 2
    with pytest.raises(ValueError):
        psynth.cached("nosuch", 1, cache_dir=str(tmp_path))


def test_native_copies_are_byte_identical():
    import filecmp

    from graph_embed_tpu_torch import native

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("fastload.cpp", "greedy.cpp"):
        assert filecmp.cmp(os.path.join(native.SRC_DIR, name),
                           os.path.join(repo, "graph_embed_tpu", "native",
                                        name), shallow=False), name
