"""The embed options of the port built on the portable refinement:
``refine_backend="portable"``, linlog refinement, embedVia
(``any_to_multilevel``, ``embed_via``, ``final_block``), the minimization
embedder and checkpoint/resume, against the JAX package and the numpy
oracles on seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.embed import checkpoint as jckpt
from graph_embed_tpu.embed.minimization import (
    embed_via_minimization as jminimize)
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.graph.csr import from_edges as jfrom_edges

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.embed import checkpoint as pckpt
from graph_embed_tpu_torch.graph import synth as psynth

from conftest import random_graph
import oracle_min


def _extent_close(got, want, tol):
    """Every coordinate within ``tol`` of the layout's extent."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _fixed_layout(s, n, dim):
    """A flat 'embedder' that is a fixed function of the subgraph (its
    degrees and vertex ids), so both packages' blocks see the same
    output whatever seed or key they pass."""
    deg = np.bincount(s, minlength=n).astype(np.float64)
    i = np.arange(n, dtype=np.float64)
    return np.stack([deg - i, np.cos(i), deg * 0.5 + 1.0], axis=1)[:, :dim]


def test_any_to_multilevel_matches_jax(rng):
    """Per aggregate: the induced subgraph with unit weights, embedded by
    the same fixed function, scaled by its max norm without centring and
    placed in the parent ball; float64, equal bitwise."""
    gj = random_graph(rng, 50)
    v2a = rng.integers(0, 5, 50).astype(np.int32)
    v2a[:5] = np.arange(5)
    v2a[40] = 5            # an aggregate of one vertex
    coords_A = rng.uniform(-1, 1, (6, 2))
    r_A = rng.uniform(0.2, 0.6, 6)
    seen = []

    def flat_j(sub, dim, key=None):
        seen.append(sub.n)
        return jnp.asarray(_fixed_layout(sub.to_coo_numpy()[0], sub.n, dim))

    def flat_p(sub, dim, seed=0):
        assert sub.dtype == torch.float64
        return torch.from_numpy(_fixed_layout(sub.to_coo_numpy()[0], sub.n,
                                              dim))

    want = np.asarray(gt.any_to_multilevel(flat_j)(
        gj, gt.Partition(jnp.asarray(v2a), 6), jnp.asarray(coords_A),
        jnp.asarray(r_A), 2))
    g = interop.graph(*gj.to_coo_numpy(), 50, dtype=torch.float64)
    got = gp.any_to_multilevel(flat_p)(
        g, interop.partition(v2a, 6), torch.from_numpy(coords_A),
        torch.from_numpy(r_A), 2)
    assert 1 in seen
    np.testing.assert_array_equal(got.numpy(), want)


def _hierarchy(side=6):
    g = psynth.mesh3d(side)
    res = gp.partition_hierarchy(g, 0.1, emit_graphs=True)
    return g, [g] + res.coarse_graphs, res.levels


def _ball_check(excess):
    def check(level, coords, part, centres, radii):
        v2a = part.vertex_to_agg
        dist = torch.linalg.norm(coords - centres[v2a], dim=1)
        excess[level] = float((dist - radii[v2a]).max())
        assert bool(torch.isfinite(coords).all())
    return check


def test_final_block_places_level_zero_in_parent_balls():
    """embed(final_block=any_to_multilevel(force_atlas)): the block replaces
    level 0's refinement, each aggregate lies inside its parent ball, the
    block's seed comes from the level seeds (two runs equal), and
    embed_via runs the same hook; with no coarse level the whole graph is
    one aggregate in the unit ball."""
    g, graphs, parts = _hierarchy(5)

    def flat(sub, dim, seed=0):
        return gp.force_atlas(sub, dim, seed=seed, iterations=5,
                              device="cpu")

    block = gp.any_to_multilevel(flat)
    excess = {}
    metrics = gp.MetricsLogger()
    kw = dict(base_iterations=100, refine_iterations=5, seed=3)
    got = gp.embed(graphs, parts, 3, device="cpu", final_block=block,
                   on_level=_ball_check(excess), metrics=metrics, **kw)
    assert sorted(excess) == list(range(len(parts)))
    assert max(excess.values()) <= 1e-5
    routes = [r.get("route") for r in metrics.records
              if r["phase"] == "refine"]
    assert routes[-1] == "final_block" and "final_block" not in routes[:-1]
    again = gp.embed_via(graphs, parts, 3, block, device="cpu", **kw)
    assert torch.equal(got, again)
    alone = gp.embed_via([g], [], 3, block, device="cpu")
    assert float(torch.linalg.norm(alone, dim=1).max()) <= 1.0 + 1e-6


def _fixed_blocks():
    """The JAX and port building blocks over ``_fixed_layout``."""
    def flat_j(sub, dim, key=None):
        return jnp.asarray(_fixed_layout(sub.to_coo_numpy()[0], sub.n, dim))

    def flat_p(sub, dim, seed=0):
        return torch.from_numpy(_fixed_layout(sub.to_coo_numpy()[0], sub.n,
                                              dim)).to(sub.dtype)

    return gt.any_to_multilevel(flat_j), gp.any_to_multilevel(flat_p)


def _interop_hierarchy(gj, levels, coarse):
    return interop.hierarchy(
        [(*x.to_coo_numpy(), x.n) for x in [gj] + coarse],
        [(p.vertex_to_agg_numpy(), p.num_aggs) for p in levels])


def test_final_block_embed_matches_jax():
    """embed(final_block=any_to_multilevel(...)) against the JAX package
    on one hierarchy (carried across with interop) from one warm start,
    with a block that ignores its seed, so neither side draws: the coarse
    levels refine first (the portable refinement on both sides), then
    level 0 goes to the block with the renormalized parent centres and
    radii.  Per-vertex coordinates agree to 2e-3 of the extent, the class
    of test_portable_and_linlog_embeds_match_jax."""
    gj = jsynth.mesh3d(6)
    res = gt.partition_hierarchy(gj, 0.1, emit_graphs=True)
    assert len(res.levels) >= 2
    coords0 = np.random.default_rng(7).uniform(
        -1, 1, (gj.n, 3)).astype(np.float32)
    kw = dict(base_iterations=100, refine_iterations=5,
              refine_backend="portable")
    block_j, block_p = _fixed_blocks()
    want = np.asarray(gt.embed([gj] + res.coarse_graphs, res.levels, 3,
                               coords0=jnp.asarray(coords0),
                               final_block=block_j, **kw))
    graphs, parts = _interop_hierarchy(gj, res.levels, res.coarse_graphs)
    excess = {}
    got = gp.embed(graphs, parts, 3, device="cpu",
                   coords0=torch.from_numpy(coords0), final_block=block_p,
                   on_level=_ball_check(excess), **kw)
    assert max(excess.values()) <= 1e-5
    _extent_close(got.numpy(), want, 2e-3)


@pytest.mark.parametrize("coarse", ["none", "one vertex"])
def test_embed_via_matches_jax(coarse):
    """embed_via against the JAX package with a block that ignores its
    seed.  With no coarse level the whole graph is one aggregate in the
    unit ball (embed.cpp:121-138); with one coarse level of a single
    vertex the normalized base case puts it at the origin on both sides
    (no draw survives), and the driver hands level 0 to the block.  The
    coarse levels' refinement draws from each package's own generator,
    so it is held to JAX through embed(final_block) above."""
    gj = jsynth.mesh3d(4)
    block_j, block_p = _fixed_blocks()
    if coarse == "none":
        gjs, pjs = [gj], []
    else:
        one = jfrom_edges(np.array([0]), np.array([0]), np.array([1.0]),
                          n=1)
        gjs, pjs = [gj, one], [gt.Partition(jnp.zeros(gj.n, jnp.int32), 1)]
    kw = dict(base_iterations=50, refine_iterations=5)
    want = np.asarray(gt.embed_via(
        gjs, pjs, 3, block_j,
        base_params=gt.ForceAtlasParams(normalize=True), **kw))
    graphs, parts = _interop_hierarchy(gjs[0], pjs, gjs[1:])
    got = gp.embed_via(graphs, parts, 3, block_p, device="cpu",
                       base_params=gp.ForceAtlasParams(normalize=True), **kw)
    assert got.shape == want.shape == (gj.n, 3)
    _extent_close(got.numpy(), want, 2e-3)


def test_minimization_matches_jax_and_oracle(rng):
    """Two Gauss-Seidel sweeps from the same start, float64, against the
    JAX package and the literal transcription of src/embed.cpp:341-559 at
    the JAX suite's tolerance (rtol 1e-7, atol 1e-8)."""
    gj = random_graph(rng, 12, avg_deg=3)
    x0 = rng.uniform(-1, 1, size=(12, 2))
    want_o = oracle_min.minimize_sweeps(gj, x0, 2)
    want_j = np.asarray(jminimize(gj, 2, coords=jnp.asarray(x0),
                                  iterations=2))
    g = interop.graph(*gj.to_coo_numpy(), 12, dtype=torch.float64)
    got = gp.embed_via_minimization(g, 2, coords=torch.from_numpy(x0),
                                    iterations=2, device="cpu").numpy()
    np.testing.assert_allclose(got, want_j, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(got, want_o, rtol=1e-7, atol=1e-8)
    assert np.linalg.norm(got[1:], axis=1).max() == pytest.approx(1.0)


def test_embed_via_minimization_block():
    """The reference's generic path, anyToMultilevel over
    embedViaMinimization: finite [n, 2] coordinates, and two runs from one
    seed equal."""
    _, graphs, parts = _hierarchy(4)

    def flat(sub, dim, seed=0):
        return gp.embed_via_minimization(sub, dim, iterations=2, seed=seed,
                                         device="cpu")

    runs = [gp.embed_via(graphs, parts, 2, gp.any_to_multilevel(flat),
                         device="cpu", base_iterations=100,
                         refine_iterations=5, seed=1) for _ in range(2)]
    assert runs[0].shape == (graphs[0].n, 2)
    assert bool(torch.isfinite(runs[0]).all())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("backend,resume_at", [
    ("portable", "base"), ("portable", "middle"), ("auto", "base")])
def test_checkpoint_resume_equals_fresh(tmp_path, backend, resume_at):
    """A store holding the coarse levels of a run resumes from the finest
    of them; the per-level seeds are derived up front, so the resumed
    embed is torch.equal to the fresh one (tests/test_aux.py:15)."""
    _, graphs, parts = _hierarchy()
    k = len(parts)
    assert k >= 2
    kw = dict(base_iterations=200, refine_iterations=5, seed=11,
              refine_backend=backend)
    store_a = pckpt.CheckpointStore(str(tmp_path / "a"))
    fresh = pckpt.embed_resumable(graphs, parts, 3, store=store_a,
                                  device="cpu", **kw)
    assert store_a.last_completed(k) == 0
    store_b = pckpt.CheckpointStore(str(tmp_path / "b"))
    for lvl in ((k,) if resume_at == "base" else (k, k - 1)):
        store_b.save_level(lvl, **store_a.load_level(lvl))
    metrics = gp.MetricsLogger()
    resumed = gp.embed(graphs, parts, 3, device="cpu", store=store_b,
                       metrics=metrics, **kw)
    assert metrics.records[0] == {"phase": "resume",
                                  "level": k if resume_at == "base"
                                  else k - 1}
    assert torch.equal(resumed, fresh)


def test_checkpoint_reads_a_jax_written_store(tmp_path):
    """The on-disk format is the JAX package's: a store the JAX
    CheckpointStore wrote (its .npz and manifest) loads in the port, and
    resuming from its base level equals a fresh port embed."""
    _, graphs, parts = _hierarchy()
    k = len(parts)
    kw = dict(base_iterations=200, refine_iterations=5, seed=2,
              refine_backend="portable")
    mine = pckpt.CheckpointStore(str(tmp_path / "port"))
    fresh = gp.embed(graphs, parts, 3, device="cpu", store=mine, **kw)
    theirs = jckpt.CheckpointStore(str(tmp_path / "jax"))
    base = mine.load_level(k)["coords"]
    theirs.save_level(k, coords=jnp.asarray(base))
    theirs.save_level(k - 1, **{
        name: jnp.asarray(v) for name, v in mine.load_level(k - 1).items()})
    loaded = pckpt.CheckpointStore(str(tmp_path / "jax"))
    assert loaded.read_manifest() == {"completed": [k - 1, k]}
    assert loaded.last_completed(k) == k - 1
    for name, v in mine.load_level(k - 1).items():
        np.testing.assert_array_equal(loaded.load_level(k - 1)[name], v)
    assert torch.equal(gp.embed(graphs, parts, 3, device="cpu",
                                store=loaded, **kw), fresh)


LINLOG = dict(base_params=gp.ForceAtlasParams(linlog=True),
              refine_params=gp.MultilevelFAParams(linlog=True))


@pytest.mark.parametrize("case", ["portable", "linlog"])
def test_portable_and_linlog_embeds_match_jax(case):
    """The slice under the portable refinement: one hierarchy (carried
    across with interop) and one warm start, so neither side draws.  JAX
    refines with its portable path (every level under linlog), the port
    with force_atlas_multilevel (kernels A, and E under linlog, in their
    plain versions).  Per-vertex coordinates agree to 2e-3 of the extent
    (the whole-slice class of test_torch_embed.py), every level packs into
    its parent balls, and each level's refine span names the route."""
    gj = jsynth.mesh3d(6)
    res = gt.partition_hierarchy(gj, 0.1, emit_graphs=True)
    coords0 = np.random.default_rng(5).uniform(
        -1, 1, (gj.n, 3)).astype(np.float32)
    kw = dict(base_iterations=100, refine_iterations=5)
    jkw = dict(LINLOG) if case == "linlog" else {}
    want = np.asarray(gt.embed([gj] + res.coarse_graphs, res.levels, 3,
                               coords0=jnp.asarray(coords0),
                               refine_backend="portable", **jkw, **kw))
    graphs, parts = interop.hierarchy(
        [(*x.to_coo_numpy(), x.n) for x in [gj] + res.coarse_graphs],
        [(p.vertex_to_agg_numpy(), p.num_aggs) for p in res.levels])
    excess = {}
    metrics = gp.MetricsLogger()
    got = gp.embed(graphs, parts, 3, device="cpu",
                   coords0=torch.from_numpy(coords0),
                   refine_backend="portable" if case == "portable"
                   else "auto", on_level=_ball_check(excess),
                   metrics=metrics, **jkw, **kw)
    assert sorted(excess) == list(range(len(parts)))
    assert max(excess.values()) <= 1e-5
    assert {r["route"] for r in metrics.records
            if r["phase"] == "refine"} == {"portable"}
    _extent_close(got.numpy(), want, 2e-3)
