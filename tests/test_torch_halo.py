"""The port's halo-sharded flat step, its ring overlap (kernel F's plain
version) and the aggregate-sharded refinement against the JAX package on
the 8 virtual CPU devices (the ring in interpret mode, as
tests/test_halo.py runs it), with the same plans and the same samples;
then the port's own contracts: overlap == collective, and bitwise the same
layout at 1 and 8 shards (tests/test_halo.py:377, test_sharded_ml.py:52).

The JAX draws (jax.random threefry) are replayed for the port: each
iteration's sample ids come from the key sequence of halo_force_atlas
(halo.py:623, 675) and are injected through ``sample_ids``.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import graph_embed_tpu as gt
from graph_embed_tpu.parallel import halo as JH
from graph_embed_tpu.parallel import overlap as JOV
from graph_embed_tpu.parallel import sharded_ml as JSM
from graph_embed_tpu.parallel.mesh import EDGE_AXIS
from graph_embed_tpu.parallel.mesh import make_mesh as jmesh
from graph_embed_tpu.utils.params import (ForceAtlasParams,
                                          MultilevelFAParams)

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch import parallel as PP
from graph_embed_tpu_torch.ops import bucket_repulsion as BR
from graph_embed_tpu_torch.parallel import halo as PH
from graph_embed_tpu_torch.parallel import overlap as POV
from graph_embed_tpu_torch.parallel import sharded_ml as PSM
from graph_embed_tpu_torch.parallel.mesh import make_mesh

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs(rng, n, avg_deg=6, weighted=False):
    """A random symmetric graph on both sides (float32, self-loop free)."""
    m = n * avg_deg // 2
    s, r = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != r
    w = rng.uniform(0.5, 2.0, keep.sum()) if weighted else None
    gj = gt.from_edges(s[keep], r[keep], w, n=n, symmetrize=True,
                       dtype=jnp.float32)
    return gj, interop.graph(*gj.to_coo_numpy(), n)


def _close(got, want, tol):
    """Every entry within ``tol`` times the layout's extent."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _jax_ids(key, iterations, plan, params, mode):
    """The sample ids halo_force_atlas draws from ``key`` (halo.py:509-529:
    per iteration ``key, sub = split(key)`` after the init split;
    stratified shard s draws randint(fold_in(sub, s), samp_per, max(nr_s,
    1)), invariant randint(sub, K, n)), for the port's ``sample_ids``."""
    samp_per = max(params.num_negative_samples // plan.ndev, 1)
    key, _ = jax.random.split(key)
    out = []
    for _ in range(iterations):
        key, sub = jax.random.split(key)
        if mode == "invariant":
            ids = jax.random.randint(sub, (params.num_negative_samples,), 0,
                                     jnp.asarray(max(plan.n, 1)))
        else:
            ids = jnp.stack([jax.random.randint(
                jax.random.fold_in(sub, jnp.int32(me)), (samp_per,), 0,
                jnp.maximum(jnp.int32(plan.n_real[me, 0]), 1))
                for me in range(plan.ndev)])
        out.append(torch.from_numpy(np.array(ids)))
    return out


@pytest.mark.parametrize("ndev", [1, 4, 8])
def test_plan_and_groups_match_jax(rng, ndev):
    """The host plans are numpy on both sides: array-equal."""
    gj, g = _graphs(rng, 8 * 31, weighted=True)
    for bm in (None, 128):
        want = JH.build_halo_plan(gj, ndev, boundary_multiple=bm)
        got = PH.build_halo_plan(g, ndev, boundary_multiple=bm)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name), f.name)
        assert got.boundary_fraction == want.boundary_fraction
        assert got.comm_floats_per_step(3, 64) == \
            want.comm_floats_per_step(3, 64)
    gw = JOV.build_overlap_groups(want)
    gp_ = POV.build_overlap_groups(interop.halo_plan(want))
    for f in dataclasses.fields(gw):
        np.testing.assert_array_equal(getattr(gp_, f.name),
                                      getattr(gw, f.name), f.name)


def test_ring_forces_plain_match_jax(rng):
    """ring_cross_forces_plain against the Pallas ring (interpret mode) per
    edge, linlog and nohubs on, from one layout: the one-hot gather at
    HIGHEST precision selects exactly, so only the float32 rounding of
    the distance differs (1e-6 of the largest force)."""
    ndev, d = 4, 3
    gj, g = _graphs(rng, ndev * 50, weighted=True)
    params = ForceAtlasParams(repulsion="sampled", linlog=True, nohubs=True,
                              delta=0.5)
    jplan = JH.build_halo_plan(gj, ndev, boundary_multiple=128)
    jgroups = JOV.build_overlap_groups(jplan)
    x = np.zeros((ndev * jplan.blk, d), np.float32)
    x[: gj.n] = rng.uniform(-1, 1, (gj.n, d))
    deg_p1 = (jplan.deg.reshape(-1) + 1.0).astype(np.float32)

    def body(xb, dg, bidx, cs, cr, cw, mask):
        out = JOV.ring_cross_forces(xb, dg, bidx[0], cs[0], cr[0], cw[0],
                                    mask[0], ndev=ndev, b_max=jplan.B_max,
                                    params=params, interpret=True)
        return out[None]

    ring = jax.jit(jax.shard_map(body, mesh=jmesh(ndev),
                                 in_specs=(P(EDGE_AXIS),) * 7,
                                 out_specs=P(EDGE_AXIS), check_vma=False))
    want = np.asarray(ring(jnp.asarray(x), jnp.asarray(deg_p1),
                           jplan.boundary_idx, jgroups.cs, jgroups.cr,
                           jnp.asarray(jgroups.cw, jnp.float32),
                           jgroups.mask))              # [dev, slot, ec, d]
    plan = interop.halo_plan(jplan)
    rg = POV.ring_groups(interop.overlap_groups(jgroups), plan, CPU)
    got = POV.ring_cross_forces_plain(torch.from_numpy(x),
                                      torch.from_numpy(deg_p1), rg, params)
    got = np.swapaxes(got.numpy(), 0, 1)               # [shard, slot, ...]
    assert jgroups.mask.sum() > 0
    _close(got, want, 1e-6)
    # padding entries are exact zeros
    assert not got[jgroups.mask == 0].any()


@pytest.mark.parametrize("ndev", [4, 8])
def test_ring_live_counts_are_group_prefixes(rng, ndev):
    """Kernel F reads only the live prefix of each (slot, shard) group and
    not its mask: the ring's counts equal the mask sums, the prefix has
    mask 1 and every group's padding (mask 0, ghost sender blk) is a
    contiguous tail, slot 0 counts 0, and groups with a hole before their
    last live entry, or a live mask other than 1, are refused."""
    _, g = _graphs(rng, ndev * 60, weighted=True)
    plan = PH.build_halo_plan(g, ndev, boundary_multiple=128)
    groups = POV.build_overlap_groups(plan)
    ring = POV.ring_groups(groups, plan, CPU)
    mask, live = ring.mask.numpy(), ring.live.numpy()
    assert live.dtype == np.int32 and live.shape == (ndev, ndev)
    assert ring.live.is_contiguous()
    np.testing.assert_array_equal(live, mask.sum(-1))
    np.testing.assert_array_equal(
        mask, (np.arange(ring.ec) < live[..., None]).astype(np.float32))
    assert (ring.cs.numpy()[mask == 0] == plan.blk).all()
    assert not live[0].any() and live.sum() == ring.live_edges > 0
    shard, slot = np.argwhere(groups.mask.sum(-1) >= 2)[0]
    for value in (0.0, 0.5):
        bad = groups.mask.copy()
        bad[shard, slot, 0] = value
        with pytest.raises(ValueError, match="prefix"):
            POV.ring_groups(dataclasses.replace(groups, mask=bad), plan, CPU)


def _run_jax(gj, plan, params, c0, key, iters, **kw):
    return np.asarray(JH.halo_force_atlas(
        gj, c0.shape[1], mesh=jmesh(plan.ndev), params=params,
        iterations=iters, coords0=c0, key=key, plan=plan, **kw))


def _run_port(g, plan, params, c0, ids, **kw):
    return gp.parallel.halo.halo_force_atlas(
        g, c0.shape[1], mesh=make_mesh(plan.ndev, device=CPU),
        params=params, iterations=len(ids), coords0=torch.from_numpy(c0),
        plan=interop.halo_plan(plan), sample_ids=ids, device=CPU,
        **kw).numpy()


# (name, ndev, weighted, params, JAX kwargs, port kwargs, tolerance)
#  segment / overlap / invariant 2e-5: the JAX suite's class for the halo
#    step (test_halo.py:206); the per-edge arithmetic is the same float32,
#    only the order of the sums differs;
#  tiled 2e-3: the reference's tiled SpMV scatters through a bf16 hi/lo
#    join (test_halo.py:72, 228), the port's kernel A path is exact f32;
#  linlog overlap 1e-4 (test_halo.py:133).
_SAMPLED = ForceAtlasParams(repulsion="sampled", num_negative_samples=16)
STEP_CASES = [
    ("segment", 4, True, _SAMPLED, dict(tiled=False), dict(tiled=False),
     2e-5),
    ("overlap", 4, False, _SAMPLED,
     dict(tiled=False, overlap=True, interpret=True),
     dict(tiled=False, overlap=True), 2e-5),
    ("tiled unit", 4, False, _SAMPLED, dict(tiled=True, interpret=True),
     dict(tiled=True), 2e-3),
    ("tiled weighted", 2, True, _SAMPLED, dict(tiled=True, interpret=True),
     dict(tiled=True), 2e-3),
    ("linlog overlap", 4, True,
     dataclasses.replace(_SAMPLED, linlog=True, num_negative_samples=8),
     dict(tiled=True, overlap=True, interpret=True),
     dict(tiled=True, overlap=True), 1e-4),
    ("invariant", 8, True, dataclasses.replace(_SAMPLED, nohubs=True),
     dict(tiled=False, sample_mode="invariant"),
     dict(tiled=False, sample_mode="invariant"), 2e-5),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_halo_step_matches_jax(rng, case):
    """Three halo steps from one start, with the JAX step's own samples,
    to ``tol`` of the layout's extent."""
    name, ndev, weighted, params, jkw, pkw, tol = case
    gj, g = _graphs(rng, ndev * 40 + 13, weighted=weighted)
    plan = JH.build_halo_plan(
        gj, ndev, boundary_multiple=128 if jkw.get("overlap") else None)
    c0 = rng.uniform(-1, 1, (gj.n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    iters = 3
    mode = jkw.get("sample_mode", "stratified")
    want = _run_jax(gj, plan, params, c0, key, iters, **jkw)
    got = _run_port(g, plan, params, c0,
                    _jax_ids(key, iters, plan, params, mode), **pkw)
    assert np.isfinite(got).all()
    _close(got, want, tol)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("linlog", [False, True])
def test_port_overlap_matches_collective(rng, tiled, linlog):
    """The ring (kernel F's plain version, copies in order) against the
    boundary gather, from one start with the same samples: the same
    per-edge float32 terms, summed in two groups instead of one; after
    three steps within the JAX suite's classes for this pair, 2e-5 of the
    extent (test_halo.py:206) and 1e-4 under linlog (:133).  Tiled on
    weights, the local tiles truncate them to bf16 while the ring keeps
    them, as in the reference: 2e-3 (test_halo.py:243)."""
    ndev = 4
    _, g = _graphs(rng, ndev * 60, weighted=True)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=16,
                              linlog=linlog)
    plan = PH.build_halo_plan(g, ndev, boundary_multiple=128)
    c0 = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    kw = dict(mesh=make_mesh(ndev, device=CPU), params=params, iterations=3,
              coords0=c0, plan=plan, seed=3, tiled=tiled, device=CPU)
    a = PH.halo_force_atlas(g, 3, **kw)
    b = PH.halo_force_atlas(g, 3, overlap=True, **kw)
    tol = 1e-4 if linlog else (2e-3 if tiled else 2e-5)
    _close(b.numpy(), a.numpy(), tol)
    assert not torch.equal(a, c0)


def test_invariant_halo_is_shard_count_invariant(rng):
    """sample_mode='invariant' draws the same global ids at any shard
    count and the repulsion runs over the real rows only: bitwise the same
    layout on 1, 4 and 8 shards, tiled and not."""
    _, g = _graphs(rng, 300, weighted=True)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
    for tiled in (False, True):
        outs = [PH.halo_force_atlas(
            g, 3, mesh=make_mesh(ndev, device=CPU), params=params,
            iterations=4, seed=2, sample_mode="invariant", tiled=tiled,
            device=CPU) for ndev in (1, 4, 8)]
        assert bool(torch.isfinite(outs[0]).all())
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0],
                                                             outs[2])


def _level(rng, n=300, m=30, d=3, weighted=False):
    gj, g = _graphs(rng, n, weighted=weighted)
    v2a = rng.integers(0, m, size=n).astype(np.int32)
    v2a[:m] = np.arange(m)
    v2a[m: m + 60] = 0        # one larger aggregate: a second size class
    coords_A = rng.uniform(-2, 2, size=(m, d)).astype(np.float32)
    r_A = rng.uniform(0.3, 1.0, size=m).astype(np.float32)
    c0 = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    return gj, g, v2a, m, coords_A, r_A, c0


@pytest.mark.parametrize("weighted", [False, True])
def test_refine_level_sharded_matches_jax(rng, weighted):
    """Four sharded refinement iterations and the epilogue from the same
    warm start (the draw injected: no random init on either side), against
    the JAX sharded refinement on 8 devices, at the refine class 2e-3
    (test_torch_refine.py: JAX's interpret path is the gram-form batch);
    and the port's 1- and 8-shard levels bitwise equal."""
    gj, g, v2a, m, coords_A, r_A, c0 = _level(rng, weighted=weighted)
    params = MultilevelFAParams()
    want = np.asarray(JSM.refine_level_sharded(
        gj, gt.Partition(jnp.asarray(v2a), m), coords_A, r_A, 3,
        mesh=jmesh(8), key=jax.random.PRNGKey(0), iterations=4,
        params=params, coords0=c0))
    part = interop.partition(v2a, m)
    outs = [PSM.refine_level_sharded(
        g, part, torch.from_numpy(coords_A), torch.from_numpy(r_A), 3,
        mesh=make_mesh(ndev, device=CPU), iterations=4, params=params,
        coords0=torch.from_numpy(c0)) for ndev in (1, 8)]
    _close(outs[1].numpy(), want, 2e-3)
    assert torch.equal(outs[0], outs[1])
    dist = np.linalg.norm(outs[1].numpy() - coords_A[v2a], axis=1)
    assert (dist <= r_A[v2a] + 1e-5).all()


def test_sharded_layout_deals_aggregates(rng):
    """The deal of prepare_refine_sharded: every vertex one slot, each
    shard's slots inside its block, q aggregates per class per shard
    (ghosts where it runs out), and the sampled classes' draws dealt so
    that 1 and 8 shards agree with the threshold forcing them."""
    gj, g, v2a, m, coords_A, r_A, c0 = _level(rng, n=400, m=40)
    part = interop.partition(v2a, m)
    shl = PSM.prepare_refine_sharded(g, part, MultilevelFAParams(), 8)
    sov = shl.layout.slot_of_vertex.numpy()
    assert np.unique(sov).size == g.n
    assert int(shl.layout.valid_slot.sum()) == g.n
    np.testing.assert_array_equal(shl.agg_of_slot.numpy()[sov], v2a)
    assert not shl.layout.deg_loc[~shl.layout.valid_slot].any()
    classes = BR.size_classes(np.bincount(v2a, minlength=m))
    buckets = shl.layout.space.buckets
    assert len(buckets) == 8 * len(classes)
    for i, b in enumerate(buckets):
        shard, (S, aggs) = i // len(classes), classes[i % len(classes)]
        assert b.S == S and b.m_b == -(-aggs.size // 8)
        lo = shard * shl.n_slots_local
        assert lo <= b.base and b.base + b.m_b * S <= lo + shl.n_slots_local
    params = MultilevelFAParams(sampled_slots_threshold=64)
    sampled = PSM.prepare_refine_sharded(g, part, params, 8).layout
    assert [c for c, _ in sampled.space.sampled_classes] == [
        aggs.size for S, aggs in classes if S >= 64]
    assert sampled.space.sampled_classes and all(
        len(bis) == 8 for _, bis in sampled.space.sampled_classes)
    outs = [PSM.refine_level_sharded(
        g, part, torch.from_numpy(coords_A), torch.from_numpy(r_A), 3,
        mesh=make_mesh(ndev, device=CPU), iterations=3, params=params,
        seed=5) for ndev in (1, 8)]
    assert torch.equal(outs[0], outs[1])


def test_embed_halo_mesh_is_shard_count_invariant(rng):
    """embed(mesh, sharding='halo'): the halo base case (mesh_min_n=1:
    partition order, invariant sampling) and the sharded refinement on
    every level; 1 and 8 shards bitwise equal, as the JAX package pins
    them (test_halo.py:377, test_sharded_ml.py:90).  The halo step itself
    is held to JAX by test_halo_step_matches_jax."""
    _, g = _graphs(rng, 360, weighted=True)
    res = gp.partition_hierarchy(g, 0.25, emit_graphs=True)
    graphs = [g] + res.coarse_graphs
    kw = dict(device=CPU, base_iterations=6, refine_iterations=3,
              mesh_min_n=1, sharding="halo", seed=4)
    outs = [gp.embed(graphs, res.levels, 2,
                     mesh=make_mesh(ndev, device=CPU), **kw)
            for ndev in (1, 8)]
    assert outs[0].shape == (g.n, 2) and bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])
    # base_order: the same permutation as the internal pass, the same
    # layout (test_halo.py:397)
    perm = gp.partition_order(graphs[-1])
    flat = [gp.embed([graphs[-1]], [], 2, mesh=make_mesh(4, device=CPU),
                     **kw, **extra) for extra in ({}, {"base_order": perm})]
    assert torch.equal(flat[0], flat[1])


def test_embed_mesh_options(rng):
    """The JAX driver's ValueErrors (unknown sharding, a bad base_order);
    the default sharding runs the replicated base case, and linlog
    refinement with a mesh still raises where a level of at least
    mesh_min_n vertices would refine sharded (reference fault 8)."""
    _, g = _graphs(rng, 120)
    mesh = make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="sharding"):
        gp.embed([g], [], 2, device=CPU, mesh=mesh, sharding="Halo")
    out = gp.embed([g], [], 2, device=CPU, mesh=mesh, mesh_min_n=1,
                   base_iterations=3)
    assert out.shape == (g.n, 2) and bool(torch.isfinite(out).all())
    res = gp.partition_hierarchy(g, 0.25, emit_graphs=True)
    assert res.levels
    with pytest.raises(NotImplementedError, match="reference fault 8"):
        gp.embed([g] + res.coarse_graphs, res.levels, 2, device=CPU,
                 mesh=mesh, mesh_min_n=1,
                 refine_params=gp.MultilevelFAParams(linlog=True))
    with pytest.raises(ValueError, match="base_order"):
        gp.embed([g], [], 2, device=CPU, mesh=mesh, mesh_min_n=1,
                 sharding="halo", base_iterations=2,
                 base_order=np.arange(10))
    with pytest.raises(ValueError, match="sampled"):
        PH.halo_force_atlas(g, 2, mesh=mesh, device=CPU,
                            params=ForceAtlasParams(repulsion="gram"))


def test_embed_mesh_linlog_below_mesh_min_n():
    """A mesh with linlog refinement where no level reaches mesh_min_n:
    every level refines on the portable route (the log term), as the
    reference's driver does with its mesh (driver.py:257-278).  The port
    equals its embed without a mesh bit for bit, and JAX's embed with a
    mesh to 2e-3 of the extent (the class of
    test_torch_embed_options.py:test_portable_and_linlog_embeds_match_jax,
    same hierarchy and warm start, so neither side draws)."""
    from graph_embed_tpu.graph import synth as jsynth

    gj = jsynth.mesh3d(6)
    res = gt.partition_hierarchy(gj, 0.1, emit_graphs=True)
    coords0 = np.random.default_rng(5).uniform(
        -1, 1, (gj.n, 3)).astype(np.float32)
    linlog = dict(base_params=ForceAtlasParams(linlog=True),
                  refine_params=MultilevelFAParams(linlog=True))
    kw = dict(base_iterations=100, refine_iterations=5)
    want = np.asarray(gt.embed([gj] + res.coarse_graphs, res.levels, 3,
                               coords0=jnp.asarray(coords0),
                               refine_backend="portable", mesh=jmesh(2),
                               **linlog, **kw))
    graphs, parts = interop.hierarchy(
        [(*x.to_coo_numpy(), x.n) for x in [gj] + res.coarse_graphs],
        [(p.vertex_to_agg_numpy(), p.num_aggs) for p in res.levels])
    assert max(x.n for x in graphs) < 65536
    pkw = dict(device=CPU, coords0=torch.from_numpy(coords0),
               base_params=gp.ForceAtlasParams(linlog=True),
               refine_params=gp.MultilevelFAParams(linlog=True), **kw)
    metrics = gp.MetricsLogger()
    got = gp.embed(graphs, parts, 3, mesh=make_mesh(2, device=CPU),
                   metrics=metrics, **pkw)
    assert {r["route"] for r in metrics.records
            if r["phase"] == "refine"} == {"portable"}
    assert torch.equal(got, gp.embed(graphs, parts, 3, **pkw))
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-3 * np.abs(want).max(), err


def test_native_sources_live_in_the_port():
    """The port builds its native libraries from its own copies of the C++
    sources, byte-identical to the JAX package's (which keeps the two
    packages' hierarchies bit-identical, test_torch_core.py)."""
    from graph_embed_tpu_torch import native

    pkg = os.path.join(REPO, "graph_embed_tpu_torch")
    assert os.path.commonpath([native.SRC_DIR, pkg]) == pkg
    for name in ("coarsen.cpp", "sweep.cpp"):
        assert filecmp.cmp(os.path.join(native.SRC_DIR, name),
                           os.path.join(REPO, "graph_embed_tpu", "native",
                                        name), shallow=False), name


@pytest.mark.parametrize("entry", ["force_atlas", "force_atlas_tiled",
                                   "halo_force_atlas", "make_mesh",
                                   "force_atlas_multilevel",
                                   "embed_via_minimization",
                                   "sharded_force_atlas"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` the entry points run on CUDA; on a machine
    without a card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    g = gp.synth.ring_of_cliques(3, 4)
    calls = {
        "force_atlas": lambda: gp.force_atlas(g, 2, iterations=2),
        "force_atlas_tiled": lambda: gp.force_atlas_tiled(g, 2,
                                                          iterations=2),
        "halo_force_atlas": lambda: PH.halo_force_atlas(
            g, 2, mesh=make_mesh(2, device=CPU), iterations=2),
        "make_mesh": lambda: make_mesh(2),
        "force_atlas_multilevel": lambda: gp.force_atlas_multilevel(
            g, interop.partition(np.zeros(g.n, np.int32), 1),
            torch.zeros((1, 2)), torch.ones(1), 2, iterations=2),
        "embed_via_minimization": lambda: gp.embed_via_minimization(
            g, 2, iterations=2),
        "sharded_force_atlas": lambda: PP.sharded_force_atlas(
            g, 2, iterations=2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
