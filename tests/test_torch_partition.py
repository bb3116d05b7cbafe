"""The port's partition layer against the JAX package: modularity, the
Galerkin products, the device coarsener and its hierarchy drivers, the
greedy partitionBase, and the ``auto`` backend.

Tolerance: the device hierarchy must equal the native one exactly (level
sizes and every assignment), in float64 and float32, because the device
coarsener computes every gain, alpha and duplicate sum as the native code
does; the running Q, a float64 sum of the same gains in another order,
within 1e-9.  Modularity: within 1e-10 of the JAX package and of the numpy
oracle on float64 graphs (the sums differ only in order).  The device
Galerkin products sum integer weights exactly and other weights, on the
CPU, in input order, as the JAX package's sorted segment sum does:
float64 weights within 1e-12 relative, the structure exact; the chain
built on a graph's device equals the host chain (integer weights) or
lies within 1e-6 of it (float32 weights).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.ops import spgemm as jspgemm
from graph_embed_tpu.partition import coarsen as jcoarsen
from graph_embed_tpu.utils.params import PartitionParams as JParams

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.ops import segment
from graph_embed_tpu_torch.ops import spgemm as pspgemm
from graph_embed_tpu_torch.partition import coarsen as pcoarsen
from graph_embed_tpu_torch.partition import hierarchy as phier
from graph_embed_tpu_torch.utils import timing
from graph_embed_tpu_torch.utils.params import PartitionParams as PParams

import oracle
from conftest import random_graph

CPU = torch.device("cpu")


def _port(gj):
    s, r, w = gj.to_coo_numpy()
    dtype = torch.float64 if w.dtype == np.float64 else torch.float32
    return interop.graph(s, r, w, gj.n, dtype=dtype)


def _card_only(g):
    """The same graph without its host COO, as a graph that lives only on
    a device."""
    return dataclasses.replace(g, host_coo=None)


def _assert_levels_equal(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert pa.num_aggs == pb.num_aggs
        np.testing.assert_array_equal(pa.vertex_to_agg_numpy(),
                                      pb.vertex_to_agg_numpy())


def _star(n=4001):
    return gt.from_edges(np.zeros(n - 1, np.int64), np.arange(1, n), None,
                         n=n, symmetrize=True, dtype=jnp.float64)


@pytest.mark.parametrize("int_truncate", [False, True])
def test_modularity_matches_jax_and_oracle(rng, int_truncate):
    gj = random_graph(rng, 60)
    if int_truncate:
        gj = gt.from_edges(*gj.to_coo_numpy()[:2],
                           gj.to_coo_numpy()[2] * 3.0, n=60,
                           dtype=jnp.float64)
    v2a = rng.integers(0, 7, size=60)
    g = _port(gj)
    got = float(gp.modularity(g, interop.partition(v2a, 7),
                              int_truncate=int_truncate))
    want = float(gt.modularity(gj, gt.Partition(jnp.asarray(
        v2a.astype(np.int32)), 7), int_truncate=int_truncate))
    assert abs(got - want) < 1e-10
    assert abs(got - oracle.modularity(gj, v2a, int_truncate=int_truncate)
               ) < 1e-10


def test_modularity_float32_against_float64():
    gj = jsynth.planted_partition(6, 40, seed=2)[0]
    g = _port(gj)
    part = gp.partition_base(g, 0.999)
    want = oracle.modularity(gj, part.vertex_to_agg_numpy())
    assert abs(float(gp.modularity(g, part)) - want) < 1e-6


def test_galerkin_device_matches_jax_and_host(rng):
    gj = random_graph(rng, 40)
    v2a = rng.integers(0, 5, size=40).astype(np.int32)
    g = _port(gj)
    host = gp.coarsen_graph(g, v2a, 5)
    dev = pspgemm.coarsen_graph_device(_card_only(g), torch.from_numpy(v2a),
                                       5)
    want = jspgemm.coarsen_graph_device(gj, jnp.asarray(v2a), 5)
    np.testing.assert_allclose(host.to_dense_numpy(),
                               oracle.galerkin_dense(gj, v2a, 5), rtol=1e-12)
    assert dev.host_coo is None and dev.num_edges == want.num_edges
    e = want.num_edges
    np.testing.assert_array_equal(dev.senders.numpy(),
                                  np.asarray(want.senders)[:e])
    np.testing.assert_array_equal(dev.receivers.numpy(),
                                  np.asarray(want.receivers)[:e])
    np.testing.assert_allclose(dev.weights.numpy(),
                               np.asarray(want.weights)[:e], rtol=1e-12)
    np.testing.assert_array_equal(dev.indptr.numpy(), np.asarray(want.indptr))
    hs, hr, hw = host.to_coo_numpy()
    np.testing.assert_array_equal(dev.senders.numpy(), hs)
    np.testing.assert_array_equal(dev.receivers.numpy(), hr)
    ns, nr, nw = pspgemm.coarsen_coo_device(
        g.senders, g.receivers, g.weights, torch.from_numpy(v2a), 5)
    js, jr, jw = jspgemm.coarsen_coo_device(
        gj.senders, gj.receivers, gj.weights, jnp.asarray(v2a), 5)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(js)[:e])
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr)[:e])
    np.testing.assert_allclose(nw.numpy(), np.asarray(jw)[:e], rtol=1e-12)


def _chain_with_counts(g, levels, **kw):
    """build_galerkin_chain inside a ``galerkin`` span: (chain, the span's
    counters)."""
    metrics = gp.MetricsLogger()
    with timing.use(metrics), metrics.span("galerkin"):
        chain = gp.build_galerkin_chain(g, levels, **kw)
    return chain, metrics.records[-1].get("counts", {})


@pytest.mark.parametrize("weighted", [False, True])
def test_galerkin_chain_device_equals_native_emitted(rng, weighted):
    """build_galerkin_chain on a graph without a host COO, which builds
    the chain on its device by default, against the native coarsener's
    emitted chain and the host chain: the same structure, unit-weight sums
    equal (integers), weighted ones within 1e-6; each coarse level carries
    a host COO equal to its tensors, with the host chain's dtypes."""
    gj = random_graph(rng, 400, avg_deg=6, weighted=weighted,
                      dtype="float32")
    g = _port(gj)
    res = gp.partition_hierarchy(g, 0.25, backend="native", emit_graphs=True)
    chain, counts = _chain_with_counts(_card_only(g), res.levels)
    forced = gp.build_galerkin_chain(_card_only(g), res.levels,
                                     backend="device")
    host = gp.build_galerkin_chain(g, res.levels)
    assert counts == {"galerkin_card_levels": len(res.levels)}
    assert len(chain) == len(host) == len(res.levels) + 1
    for a, b, c, d in zip(chain[1:], res.coarse_graphs, host[1:],
                          forced[1:]):
        for x in (b, c, d):
            assert torch.equal(a.indptr, x.indptr)
            assert torch.equal(a.receivers, x.receivers)
        assert torch.equal(a.weights, d.weights)
        for want in (b.weights, c.weights):
            if weighted:
                np.testing.assert_allclose(a.weights.numpy(), want.numpy(),
                                           rtol=1e-6)
            else:
                assert torch.equal(a.weights, want)
        assert a.host_coo is not None
        for got, t, h in zip(a.host_coo, (a.senders, a.receivers,
                                          a.weights), c.host_coo):
            assert got.dtype == h.dtype
            np.testing.assert_array_equal(got, t.numpy())
            if weighted and got.dtype.kind == "f":
                np.testing.assert_allclose(got, h, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, h)


@pytest.mark.parametrize("card_only", [False, True])
def test_galerkin_chain_routes_by_host_coo(monkeypatch, card_only):
    """build_galerkin_chain chooses its side from its input alone: a graph
    with a host COO is coarsened on the host (the device coarsener is never
    called), one without on its device (the host coarsener is never
    called); ``galerkin_card_levels`` reads the levels built on the
    device, 0 on the host."""
    from graph_embed_tpu_torch.embed import driver as D

    g = gp.synth.mesh3d(5)
    res = gp.partition_hierarchy(g, 0.1, backend="native")

    def refuse(*a, **k):
        raise AssertionError("the other side's coarsener was called")

    monkeypatch.setattr(D, "coarsen_graph" if card_only
                        else "coarsen_graph_device", refuse)
    chain, counts = _chain_with_counts(_card_only(g) if card_only else g,
                                       res.levels)
    assert len(res.levels) >= 2
    assert counts == {"galerkin_card_levels":
                      len(res.levels) if card_only else 0}
    assert all(a.host_coo is not None for a in chain[1:])
    with pytest.raises(ValueError, match="backend"):
        gp.build_galerkin_chain(g, res.levels, backend="gpu")


def test_edge_hash_matches_jax(rng):
    es = rng.integers(0, 1 << 31, 5000)
    er = rng.integers(0, 1 << 31, 5000)
    es[:100] = rng.integers(1 << 16, 1 << 17, 100)
    for salt in (0, 7, 123456):
        got = pcoarsen._edge_hash(torch.from_numpy(es), torch.from_numpy(er),
                                  salt)
        want = jcoarsen._edge_hash(jnp.asarray(es, jnp.int32),
                                   jnp.asarray(er, jnp.int32),
                                   jnp.asarray(salt, jnp.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pairwise_sum_is_the_native_tree(rng):
    def native(x):
        if x.size <= 8:
            s = x.dtype.type(0)
            for v in x:
                s = x.dtype.type(s + v)
            return s
        h = x.size // 2
        return x.dtype.type(native(x[:h]) + native(x[h:]))

    for n in (1, 8, 9, 100, 1237):
        x = rng.uniform(0, 1, n).astype(np.float32)
        assert pcoarsen._pairwise_sum(torch.from_numpy(x)).item() == native(x)


def test_segment_extrema_match_jax(rng):
    """segment_max / segment_min against the JAX package's helpers, empty
    segments included (exact: order-free)."""
    from graph_embed_tpu.ops import segment as jseg

    ids = rng.integers(0, 9, 200)
    ids[ids == 4] = 5                     # segment 4 stays empty
    vals = rng.integers(-5, 5, 200).astype(np.float64)
    for name in ("segment_max", "segment_min"):
        got = getattr(segment, name)(torch.from_numpy(vals),
                                     torch.from_numpy(ids), 9)
        want = getattr(jseg, name)(jnp.asarray(vals), jnp.asarray(ids), 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sequential_sum_is_a_sequential_loop(rng):
    lens = rng.integers(0, 80, 40)
    lens[5] = 500
    indptr = np.concatenate([[0], np.cumsum(lens)])
    v = rng.uniform(0, 1, indptr[-1]).astype(np.float32)
    init = rng.uniform(0, 9, 40).astype(np.float32)
    got = segment.sequential_sum(torch.from_numpy(v),
                                 torch.from_numpy(indptr),
                                 torch.from_numpy(init)).numpy()
    want = init.copy()
    for i in range(40):
        for x in v[indptr[i]:indptr[i + 1]]:
            want[i] = np.float32(want[i] + x)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integer", [False, True])
def test_galerkin_run_sums(rng, integer):
    """The Galerkin chain's duplicate sums (``run_sums``): integer weights
    whose runs sum past 2^24, where a float32 sum in input order rounds
    away from the float64 one, come out as the float64 sums rounded once;
    other weights as the sequential float32 loop (the plain version's
    order on the CPU)."""
    lens = rng.integers(1, 300, 200)
    lens[3] = 50_000
    indptr = np.concatenate([[0], np.cumsum(lens)])
    e = int(indptr[-1])
    w = (rng.integers(1, 800, e).astype(np.float32) if integer
         else rng.uniform(0, 1, e).astype(np.float32))
    got = pspgemm.run_sums(torch.from_numpy(w), torch.from_numpy(indptr))
    seq = segment.sequential_sum(torch.from_numpy(w),
                                 torch.from_numpy(indptr))
    if integer:
        want = np.add.reduceat(w.astype(np.float64), indptr[:-1])
        assert want.max() > 1 << 24
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
        assert not torch.equal(got, seq)
    else:
        assert torch.equal(got, seq)


CASES = {
    "hash": (lambda rng: random_graph(rng, 300, avg_deg=6), {}, 1 / 8),
    "unit_leaves_jitter": (
        lambda rng: random_graph(rng, 300, avg_deg=5, weighted=False),
        dict(merge_leaves=True, weight_jitter=0.01), 1 / 8),
    "index": (lambda rng: random_graph(rng, 300, avg_deg=6),
              dict(tie_break="index"), 1 / 8),
    "cap_per_level": (
        lambda rng: random_graph(rng, 300, avg_deg=6, weighted=False),
        dict(max_agg_size=4), 1 / 8),
    "cap_original": (
        lambda rng: random_graph(rng, 400, avg_deg=6, weighted=False),
        dict(max_agg_size=10, cap_unit="original"), 1 / 8),
    "star_absorb": (lambda rng: _star(), {}, 0.1),
    "force_coarsen_to": (lambda rng: jsynth.rmat(12, 8, seed=3,
                                                 dtype=jnp.float64), {}, 0.1),
    "float32": (lambda rng: random_graph(rng, 300, avg_deg=6,
                                         dtype="float32"), {}, 1 / 8),
    "single": (lambda rng: random_graph(rng, 200, avg_deg=5), {}, None),
    "num_parts": (lambda rng: random_graph(rng, 200, avg_deg=5), {}, 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_hierarchy_equals_native_and_jax(rng, case):
    """tests/test_partition.py:230-420, through the port: the device
    backend on a graph without a host COO equals the port's native
    backend and the JAX package's device backend."""
    make, kw, cf = CASES[case]
    gj = make(rng)
    g = _port(gj)
    if case in ("single", "num_parts"):
        fn, jfn = ((gp.partition_single, gt.partition_single)
                   if case == "single" else
                   (lambda g, **k: gp.partition_num_parts(g, cf, **k),
                    lambda g, **k: gt.partition_num_parts(g, cf, **k)))
        dev = fn(_card_only(g), backend="auto")
        nat = fn(g, backend="native")
        jdev = jfn(gj, backend="device")
        _assert_levels_equal([dev], [nat])
        _assert_levels_equal([dev], [jdev])
        return
    dev = gp.partition_hierarchy(_card_only(g), cf, PParams(**kw))
    nat = gp.partition_hierarchy(g, cf, PParams(**kw), backend="native")
    jdev = gt.partition_hierarchy(gj, cf, JParams(**kw), backend="device")
    assert dev.level_sizes == nat.level_sizes == jdev.level_sizes
    _assert_levels_equal(dev.levels, nat.levels)
    _assert_levels_equal(dev.levels, jdev.levels)
    assert abs(dev.modularity - nat.modularity) < 1e-9
    assert dev.coarse_graphs is None
    if case == "star_absorb":
        assert dev.levels[-1].num_aggs == 1


def test_auto_picks_by_host_coo(monkeypatch):
    g = gp.synth.mesh3d(4)
    assert phier._pick_backend("auto", g) == "native"
    assert phier._pick_backend("auto", _card_only(g)) == "device"
    calls = []
    real = phier._run_rounds
    monkeypatch.setattr(phier, "_run_rounds",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gp.partition_hierarchy(g, 0.1)
    assert not calls
    gp.partition_hierarchy(_card_only(g), 0.1)
    assert calls
    with pytest.raises(ValueError, match="backend"):
        gp.partition_hierarchy(g, 0.1, backend="gpu")


@pytest.mark.parametrize("variant", ["base", "base2"])
def test_greedy_native_python_jax_agree(rng, variant):
    """partitionBase / partitionBase2: the native backend, the pure-Python
    version and the JAX package's give the same assignment."""
    for n, weighted in [(60, True), (150, False)]:
        gj = random_graph(rng, n, avg_deg=5, weighted=weighted)
        g = _port(gj)
        fn = gp.partition_base if variant == "base" else gp.partition_base2
        jfn = gt.partition_base if variant == "base" else gt.partition_base2
        nat = fn(g, 0.999)
        py = fn(g, 0.999, backend="python")
        want = jfn(gj, 0.999)
        _assert_levels_equal([nat], [py])
        _assert_levels_equal([nat], [want])


def test_partition_test_matches_jax():
    gj = jsynth.ring_of_cliques(12, 10, dtype=jnp.float64)
    g = _port(gj)
    got = gp.partition_test(g, 0.999)
    _assert_levels_equal([got], [gt.partition_test(gj, 0.999)])
    assert got.num_aggs == 12
    assert float(gp.modularity(g, got)) == pytest.approx(
        float(gp.modularity(g, gp.partition_base(g, 0.999))), abs=1e-9)


def test_embed_graph_without_host_coo():
    """A graph that lives only on its device: embed_graph partitions it
    with the device coarsener, builds the chain with build_galerkin_chain
    and embeds it, the same layout as the graph with its host COO."""
    g = gp.synth.mesh3d(6)
    kw = dict(device=CPU, base_iterations=200, refine_iterations=10)
    coords, res = gp.embed_graph(_card_only(g), 3, **kw)
    want, res_n = gp.embed_graph(g, 3, **kw)
    assert res.coarse_graphs is None and res_n.coarse_graphs is not None
    assert res.level_sizes == res_n.level_sizes
    assert coords.shape == (g.n, 3) and bool(torch.isfinite(coords).all())
    assert torch.equal(coords, want)


@pytest.mark.parametrize("linlog", [False, True])
def test_embed_graph_card_chain_equals_host_chain(monkeypatch, linlog):
    """embed_graph of a card-only unit-weight community graph (the
    benchmark's LinLog graph in small, drawn by its generator with no host
    COO: the portable route under LinLog,
    the slot route without) gives the same coordinates, bit for bit,
    whether build_galerkin_chain builds the chain on the graph's device,
    as it does by default, or is forced onto the host."""
    from graph_embed_tpu_torch.embed import driver as D
    from portbench.generators import community_rmat as C
    from portbench.program import program_graph

    g = program_graph(C.build(dict(scale=12, communities=8, edge_factor=6,
                                   a=0.57, b=0.19, c=0.19, inter_frac=0.05),
                              5, "cpu"))
    kw = dict(device=CPU, seed=3, base_iterations=150, refine_iterations=8)
    if linlog:
        kw.update(base_params=gp.ForceAtlasParams(linlog=True),
                  refine_params=gp.MultilevelFAParams(linlog=True))
    metrics = gp.MetricsLogger()
    coords, res = gp.embed_graph(g, 3, metrics=metrics, **kw)
    (gal,) = [r for r in metrics.records if r["phase"] == "galerkin"]
    assert gal["counts"]["galerkin_card_levels"] == len(res.levels) >= 2
    real = D.build_galerkin_chain
    monkeypatch.setattr(D, "build_galerkin_chain",
                        lambda g, parts: real(g, parts, backend="host"))
    want, res_h = gp.embed_graph(g, 3, **kw)
    assert res_h.level_sizes == res.level_sizes
    assert torch.equal(coords, want)
