"""The port's replicated multi-shard flat step (parallel/sharded.py)
against the JAX package on its 8 virtual CPU devices (Pallas in interpret
mode, as tests/test_sharded.py runs it), then the port's own contract:
bitwise the same layout at 1 and 8 shards on every route.

Each tolerance is the JAX suite's for the same comparison: the portable
step in float64 1e-9/1e-12 (tests/test_sharded.py:47-48), the tiled step
2e-4/2e-4 (:232, :287), tiled against portable 2e-4/2e-5 (:126).  The JAX
draws (threefry) are replayed for the port through ``sample_ids``: per
iteration ``key, sub = split(key)`` after the init split, then
``randint(sub, (samples,), 0, n)`` (sharded.py:210, :238, :624).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import graph_embed_tpu as gt
from graph_embed_tpu.graph.synth import mesh3d as jmesh3d
from graph_embed_tpu.ops import dia as JDIA
from graph_embed_tpu.ops.pallas import edge_spmm as JES
from graph_embed_tpu.parallel import sharded as JSH
from graph_embed_tpu.parallel.mesh import make_mesh as jmesh
from graph_embed_tpu.utils.params import ForceAtlasParams as JParams

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch import parallel as PP
from graph_embed_tpu_torch.parallel import sharded as PSH
from graph_embed_tpu_torch.parallel.mesh import (StackedLayout, edge_sharding,
                                                 make_mesh, replicated)

CPU = "cpu"


def _graphs(rng, n, *, avg_deg=4, weighted=True, dtype="float32"):
    """A random symmetric graph on both sides (self-loop free)."""
    m = n * avg_deg // 2
    s, r = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != r
    w = rng.uniform(0.5, 2.0, keep.sum()) if weighted else None
    jd, td = ((jnp.float64, torch.float64) if dtype == "float64"
              else (jnp.float32, torch.float32))
    gj = gt.from_edges(s[keep], r[keep], w, n=n, symmetrize=True, dtype=jd)
    return gj, interop.graph(*gj.to_coo_numpy(), n, dtype=td)


def _unit_graphs(rng, n=640, m=4000):
    """tests/test_sharded.py:155-162: a unit-weight symmetric graph."""
    s, r = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != r
    gj = gt.from_edges(s[keep], r[keep], None, n=n, symmetrize=True,
                       dtype=jnp.float64)
    sc, rc, _ = gj.to_coo_numpy()
    gj = gt.from_edges(sc, rc, np.ones(sc.size), n=n, dtype=jnp.float64)
    return gj, interop.graph(*gj.to_coo_numpy(), n, dtype=torch.float64)


def _mesh3d():
    """tests/test_sharded.py:238: a 5^3 grid with 30% extra edges."""
    gj = jmesh3d(5, extra_frac=0.3, seed=7)
    return gj, interop.graph(*gj.to_coo_numpy(), gj.n)


def _params(**kw):
    return JParams(**kw), gp.ForceAtlasParams(**kw)


def _jax_ids(key, iterations, n, samples):
    """The sample ids sharded_force_atlas draws from ``key``."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            jax.random.randint(sub, (samples,), 0, n))))
    return out


def _put(mesh, a, spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, spec))


def test_full_float32_matmuls():
    """The gram repulsion cancels for near pairs: TF32 must stay off."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_stacked_layouts():
    """edge_sharding splits the leading axis into one contiguous block per
    shard; replicated is one copy every shard reads; the parallel package
    exports what the JAX one does."""
    mesh = make_mesh(4, device=CPU)
    split, rep = edge_sharding(mesh), replicated(mesh)
    assert isinstance(split, StackedLayout) and split.split
    assert split.blocks(16) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert rep.blocks(16) == [(0, 16)] * 4
    with pytest.raises(ValueError, match="equal blocks"):
        split.put(torch.zeros(10))
    assert rep.put(torch.zeros(10)).shape == (10,)
    assert PP.EDGE_AXIS == "x"
    for name in ("sharded_force_atlas", "make_sharded_fa_step",
                 "pad_graph_for_mesh", "edge_sharding", "replicated",
                 "make_mesh", "prepare_refine_sharded",
                 "refine_level_sharded"):
        assert callable(getattr(PP, name)), name


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_pad_graph_for_mesh_matches_jax(rng, ndev):
    gj, g = _graphs(rng, 70, dtype="float64")
    want = JSH.pad_graph_for_mesh(gj, ndev)
    got = PSH.pad_graph_for_mesh(g, ndev)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_row_cuts_own_every_row(rng):
    """Each cut moves forward to the next row start: every row has one
    owning shard, and the shards cover the list in order."""
    s = np.sort(rng.integers(0, 50, 400))
    for ndev in (1, 3, 8):
        cuts = PSH.row_cuts(s, ndev)
        assert cuts[0] == 0 and cuts[-1] == s.size
        assert np.all(np.diff(cuts) >= 0)
        for c in cuts[1:-1]:
            assert c in (0, s.size) or s[c] != s[c - 1]
        per = -(-s.size // ndev)
        assert np.all(cuts[:-1] >= np.minimum(np.arange(ndev) * per,
                                              s.size))


@pytest.mark.parametrize("repulsion", ["gram", "sampled"])
@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_portable_step_matches_jax(rng, ndev, repulsion):
    """One float64 step of make_sharded_fa_step on pad_graph_for_mesh's
    arrays against the JAX step (tests/test_sharded.py:23-48), the JAX
    samples injected."""
    gj, g = _graphs(rng, 64, dtype="float64")
    jp, pp = _params(repulsion=repulsion, num_negative_samples=16)
    s, r, w, n_pad = JSH.pad_graph_for_mesh(gj, ndev)
    coords = rng.uniform(-1, 1, size=(n_pad, 3))
    fprev = rng.uniform(-0.1, 0.1, size=(n_pad, 3))
    deg = np.zeros(n_pad)
    deg[: gj.n] = np.asarray(gj.degrees(True))
    key = jax.random.PRNGKey(3)
    mesh = jmesh(ndev)
    jstep = JSH.make_sharded_fa_step(mesh, n_pad, s.shape[0], 3, jp, gj.n,
                                     jnp.float64)
    want = jstep(_put(mesh, coords, P()), _put(mesh, fprev, P("x")),
                 *(_put(mesh, a, P("x")) for a in (s, r, w)),
                 _put(mesh, deg, P()), key)
    step = PSH.make_sharded_fa_step(make_mesh(ndev, device=CPU), n_pad,
                                    s.shape[0], 3, pp, g.n, torch.float64)
    ids = torch.from_numpy(np.array(jax.random.randint(key, (16,), 0,
                                                       gj.n)))
    got = step(torch.from_numpy(coords), torch.from_numpy(fprev),
               step.shard_edges(s, r, w), torch.from_numpy(deg), ids)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)


def _jax_tiled_step(gj, ndev, jp, coords, dia_min_count):
    """One step of the JAX make_sharded_fa_step_tiled (the construction of
    tests/test_sharded.py:195-230)."""
    stacked, aux, dia = JSH.build_sharded_tiles(gj, ndev, params=jp,
                                                dia_min_count=dia_min_count)
    deg_w = _jax_row_sums(stacked, aux, dia, ndev)
    mesh = jmesh(ndev)
    offsets = dia.offsets if dia is not None else ()
    step, n_pad = JSH.make_sharded_fa_step_tiled(
        mesh, aux, aux.n_pad, 3, jp, gj.n, jnp.asarray(deg_w),
        interpret=True, dia_offsets=offsets)
    dia_w = np.zeros((max(len(offsets), 1), n_pad), np.float32)
    if dia is not None:
        dia_w[:, : dia.weights.shape[1]] = dia.weights
    x = np.zeros((n_pad, 3), np.float32)
    x[: gj.n] = coords
    deg = np.zeros(n_pad, np.float32)
    deg[: gj.n] = np.asarray(gj.degrees(True))
    out, _ = step(_put(mesh, x, P()),
                  _put(mesh, np.zeros((n_pad, 3), np.float32), P("x")),
                  *(_put(mesh, stacked[k], P("x"))
                    for k in ("sbf", "rw", "packed")),
                  _put(mesh, dia_w, P(None, "x")), _put(mesh, deg, P()),
                  jax.random.PRNGKey(0))
    return np.asarray(out)[: gj.n]


def _jax_row_sums(stacked, aux, dia, ndev):
    """sharded.py:267-281: the shards' tiled_row_sums added in float32,
    then the DIA row sums."""
    deg_w = np.zeros(aux.n_pad, np.float32)
    for d in range(ndev):
        deg_w += JES.tiled_row_sums(dataclasses.replace(
            aux, sbf=stacked["sbf"][d], rw=stacked["rw"][d],
            packed=stacked["packed"][d]))
    if dia is not None:
        deg_w += JDIA.dia_row_sums(dia.weights)
    return deg_w


def _port_tiled_step(g, ndev, pp, coords, dia_min_count):
    tiles = PSH.build_sharded_tiles(g, ndev, params=pp,
                                    dia_min_count=dia_min_count)
    step, n_pad = PSH.make_sharded_fa_step_tiled(
        make_mesh(ndev, device=CPU), tiles, 3, pp, g.n)
    x = torch.zeros((n_pad, 3))
    x[: g.n] = torch.from_numpy(coords)
    deg = torch.zeros(n_pad)
    deg[: g.n] = g.degrees(True)
    out, _ = step(x, torch.zeros_like(x), deg)
    return out[: g.n].numpy(), tiles


@pytest.mark.parametrize("route", ["weighted", "dia"])
def test_tiled_step_matches_jax(rng, route):
    """One gram step on the bf16 packing's truncated weights (a random
    weighted graph), and with the DIA plan on mesh3d(5) (threshold 16,
    tests/test_sharded.py:234-288), against the JAX tiled step at 4
    shards."""
    if route == "dia":
        gj, g = _mesh3d()
        count = 16
    else:
        gj, g = _graphs(rng, 96)
        count = 0
    jp, pp = _params(repulsion="gram")
    coords = rng.uniform(-1, 1, size=(g.n, 3)).astype(np.float32)
    want = _jax_tiled_step(gj, 4, jp, coords, count)
    got, tiles = _port_tiled_step(g, 4, pp, coords, count)
    assert tiles.packing == "bf16" and tiles.csrs[0].kind == "weighted"
    if route == "dia":
        assert len(tiles.dia_offsets) >= 6
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["weighted", "dia", "unit"])
def test_row_sums_match_jax(rng, route, monkeypatch):
    """deg_w_att equals the JAX tiled_row_sums of the same shards (the
    port's row-owned cuts packed by the JAX builder), added in float32
    with the DIA row sums, bit for bit."""
    count = 0
    if route == "dia":
        gj, g = _mesh3d()
        count = 16
    elif route == "unit":
        gj, g = _unit_graphs(rng)
        monkeypatch.setattr(PSH, "UNIT_JUMBO_MIN_EDGES", 100)
        monkeypatch.setattr(JSH, "UNIT_JUMBO_MIN_EDGES", 100)
    else:
        gj, g = _graphs(rng, 96)
    jp, pp = _params()
    tiles = PSH.build_sharded_tiles(g, 4, params=pp, dia_min_count=count)
    _, jaux, jdia = JSH.build_sharded_tiles(gj, 4, params=jp,
                                            dia_min_count=count)
    assert tiles.packing == jaux.packing
    assert (tiles.sender_block, tiles.window) == (jaux.sender_block,
                                                  jaux.window)
    assert tiles.n_pad_tiles == jaux.n_pad
    assert tiles.dia_offsets == (() if jdia is None else jdia.offsets)
    want = np.zeros(jaux.n_pad, np.float32)
    for csr in tiles.csrs:
        lens = (csr.indptr[1:] - csr.indptr[:-1]).numpy()
        rows = np.repeat(np.arange(csr.n_rows), lens)
        w = (np.ones(rows.size, np.float32) if csr.w is None
             else csr.w.numpy())
        t = JES.build_window_tiles(
            JSH._CooShim(rows, csr.col.numpy(), w, g.n), tile=jaux.tile,
            sender_block=jaux.sender_block, window=jaux.window,
            packing=jaux.packing)
        want += JES.tiled_row_sums(t)
    if jdia is not None:
        want += JDIA.dia_row_sums(jdia.weights)
    np.testing.assert_array_equal(tiles.deg_w_att[: jaux.n_pad].numpy(),
                                  want)


def _both_sharded(gj, g, ndev, jp, pp, iterations, **kw):
    """sharded_force_atlas on both sides, as tests/test_sharded.py calls
    the JAX one (key PRNGKey(3), random start); the port is given the JAX
    start and draws."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(JSH.sharded_force_atlas(
        gj, 3, mesh=jmesh(ndev), params=jp, iterations=iterations, key=key,
        **kw))
    c0 = jax.random.uniform(jax.random.split(key)[1], (gj.n, 3),
                            dtype=gj.dtype, minval=-1.0, maxval=1.0)
    ids = (_jax_ids(key, iterations, g.n, pp.num_negative_samples)
           if pp.repulsion == "sampled" else None)
    got = PSH.sharded_force_atlas(
        g, 3, mesh=make_mesh(ndev, device=CPU), params=pp,
        iterations=iterations, coords0=torch.from_numpy(np.array(c0)),
        device=CPU, sample_ids=ids, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("ndev", [1, 4])
def test_linlog_matches_jax(rng, ndev):
    """Linlog through kernel E's plain version on per-shard CSRs against
    the JAX per-shard attraction_tiled (tests/test_sharded.py:129-144),
    then against the port's own portable step."""
    gj, g = _graphs(rng, 160, dtype="float64")
    jp, pp = _params(repulsion="sampled", num_negative_samples=16,
                     linlog=True)
    got, want = _both_sharded(gj, g, ndev, jp, pp, 2, tiled=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    portable, _ = _both_sharded(gj, g, ndev, jp, pp, 2, tiled=False)
    np.testing.assert_allclose(got, portable, rtol=2e-4, atol=2e-5)


def test_unit_route_matches_jax(rng, monkeypatch):
    """Folded-unit graphs past UNIT_JUMBO_MIN_EDGES take the unit route
    (4096 x 4096 tiles, paired; tests/test_sharded.py:147-174), against
    the JAX tiled route and the port's portable step."""
    gj, g = _unit_graphs(rng)
    monkeypatch.setattr(PSH, "UNIT_JUMBO_MIN_EDGES", 100)
    monkeypatch.setattr(JSH, "UNIT_JUMBO_MIN_EDGES", 100)
    jp, pp = _params(repulsion="sampled", num_negative_samples=16)
    tiles = PSH.build_sharded_tiles(g, 2, params=pp)
    assert tiles.packing == "unit" and tiles.sender_block == 4096
    assert all(c.kind == "unit" and c.bf16_gather for c in tiles.csrs)
    got, want = _both_sharded(gj, g, 4, jp, pp, 2, tiled=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    portable, _ = _both_sharded(gj, g, 4, jp, pp, 2, tiled=False)
    np.testing.assert_allclose(got, portable, rtol=2e-4, atol=2e-5)


def test_weighted_route_matches_portable(rng):
    """The bf16 packing's route against the JAX tiled route and the
    portable step (tests/test_sharded.py:112-126), at 1 and 4 shards."""
    gj, g = _graphs(rng, 160, dtype="float64")
    jp, pp = _params(repulsion="sampled", num_negative_samples=16)
    for ndev in (1, 4):
        got, want = _both_sharded(gj, g, ndev, jp, pp, 2, tiled=True)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        portable, _ = _both_sharded(gj, g, ndev, jp, pp, 2, tiled=False)
        np.testing.assert_allclose(got, portable, rtol=2e-4, atol=2e-5)


def test_dense_block_switches_to_sampled(rng, monkeypatch):
    """A dense block past DENSE_D2_MAX_BYTES switches the repulsion to
    'sampled': bitwise the explicit sampled run (tests/test_sharded.py:
    91-109)."""
    _, g = _graphs(rng, 96, dtype="float64")
    kw = dict(mesh=make_mesh(4, device=CPU), iterations=2, seed=7,
              tiled=False, device=CPU)
    want = PSH.sharded_force_atlas(
        g, 2, params=gp.ForceAtlasParams(repulsion="sampled"), **kw)
    gram = PSH.sharded_force_atlas(
        g, 2, params=gp.ForceAtlasParams(repulsion="gram"), **kw)
    assert not torch.equal(gram, want)
    monkeypatch.setattr(PSH, "DENSE_D2_MAX_BYTES", 64)
    got = PSH.sharded_force_atlas(
        g, 2, params=gp.ForceAtlasParams(repulsion="gram"), **kw)
    assert torch.equal(got, want)


ROUTES = ["portable gram", "portable sampled", "weighted", "unit", "dia",
          "linlog"]


@pytest.mark.parametrize("route", ROUTES)
def test_eight_shards_equal_one(rng, route, monkeypatch):
    """The same seed gives the same layout at 8 shards and at 1, bit for
    bit, on every route."""
    kw = dict(iterations=3, seed=2, device=CPU)
    if route == "unit":
        _, g = _unit_graphs(rng)
        monkeypatch.setattr(PSH, "UNIT_JUMBO_MIN_EDGES", 100)
    elif route == "dia":
        _, g = _mesh3d()
    else:
        _, g = _graphs(rng, 150)
    params = gp.ForceAtlasParams(
        repulsion="gram" if route == "portable gram" else "sampled",
        num_negative_samples=16, linlog=route == "linlog")
    outs = []
    for ndev in (8, 1):
        extra = {"tiled": not route.startswith("portable")}
        if route == "dia":
            extra["tiles"] = PSH.build_sharded_tiles(
                g, ndev, params=params, dia_min_count=16)
            assert extra["tiles"].dia_offsets
        outs.append(PSH.sharded_force_atlas(
            g, 3, mesh=make_mesh(ndev, device=CPU), params=params, **kw,
            **extra))
    assert outs[0].shape == (g.n, 3) and bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])


def test_embed_mesh_default_sharding(rng):
    """embed(mesh=...) with the default sharding: the replicated base case
    and the sharded refinement on every level (mesh_min_n=1), finite and
    bitwise the same at 1 and 4 shards; a warm-started gram base case of
    5 iterations within rtol=1e-5 of the JAX embed's.  That comparison
    runs in float64, as the JAX suite holds this step
    (tests/test_sharded.py:23-48): in float32 the gram identity loses
    ~|x|^2 2^-24 per pair, which near pairs of a random start turn into
    relative errors of 1e-4 in one step, and each iteration amplifies."""
    _, g = _graphs(rng, 300)
    res = gp.partition_hierarchy(g, 0.25, emit_graphs=True)
    graphs = [g] + res.coarse_graphs
    kw = dict(device=CPU, base_iterations=6, refine_iterations=3,
              mesh_min_n=1, seed=4)
    outs = [gp.embed(graphs, res.levels, 2, mesh=make_mesh(ndev, device=CPU),
                     **kw) for ndev in (1, 4)]
    assert outs[0].shape == (g.n, 2) and bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])

    gj, g = _graphs(rng, 300, dtype="float64")
    c0 = rng.uniform(-1, 1, size=(gj.n, 2))
    want = np.asarray(gt.embed([gj], [], 2, mesh=jmesh(4), mesh_min_n=1,
                               base_iterations=5, coords0=jnp.asarray(c0)))
    got = gp.embed([g], [], 2, mesh=make_mesh(4, device=CPU), mesh_min_n=1,
                   base_iterations=5, coords0=torch.from_numpy(c0),
                   device=CPU)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_refine_step_is_the_level(rng):
    """make_refine_sharded_step is refine_level_sharded's device loop: the
    same placed slots from the same start."""
    from graph_embed_tpu_torch.parallel import sharded_ml as PSM

    _, g = _graphs(rng, 200)
    part = gp.partition_hierarchy(g, 0.2).levels[0]
    params = gp.MultilevelFAParams()
    cA = torch.rand((part.num_aggs, 2), generator=torch.Generator()
                    .manual_seed(1))
    rA = torch.full((part.num_aggs,), 0.1)
    mesh = make_mesh(4, device=CPU)
    want = PSM.refine_level_sharded(g, part, cA, rA, 2, mesh=mesh, seed=3,
                                    iterations=4, params=params)
    shl = PSM.prepare_refine_sharded(g, part, params, 4)
    lay = shl.layout
    step = PSM.make_refine_sharded_step(mesh, shl, 2, params, 4)
    gen = torch.Generator().manual_seed(3)
    pull = torch.zeros((lay.n_slots, 2))
    pull[lay.slot_of_vertex] = PSM.external_pull(
        g, part, cA, pull=params.pull, eps=params.epsilon,
        csr=lay.sender_csr).float()
    x = torch.zeros((lay.n_slots, 2))
    x[lay.slot_of_vertex] = torch.rand((g.n, 2), generator=gen) * 2.0 - 1.0
    # every shard laid out: kernel B's slot space names the same slots
    assert torch.equal(lay.space.slot, lay.slot_of_vertex)
    got = step(x, pull, cA, rA, gen)[lay.space.slot]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shards"):
        PSM.make_refine_sharded_step(make_mesh(2, device=CPU), shl, 2,
                                     params, 4)
