"""The port's base case, radii and whole embed slice against the JAX
package, and the port's ``embed`` CLI."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.embed import radii as jradii
from graph_embed_tpu.forceatlas import flat as jflat
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.harness.runtests import layout_stress

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.embed import radii as pradii
from graph_embed_tpu_torch.forceatlas import flat as pflat
from graph_embed_tpu_torch.graph import synth as psynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, tol):
    """Every entry within ``tol`` times the largest magnitude of ``want``:
    float32 rounding and the gram identity's cancellation both scale with
    the largest terms, not with each entry."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _graphs(rng, n=60, weighted=True):
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    w = rng.uniform(0.5, 2.0, keep.sum()) if weighted else None
    gj = gt.from_edges(s[keep], r[keep], w, n=n, symmetrize=True,
                       dtype=jnp.float32)
    return gj, interop.graph(*gj.to_coo_numpy(), n)


@pytest.mark.parametrize("repulsion,nohubs,delta", [
    ("gram", False, 1.0), ("exact", False, 1.0), ("exact", True, 0.5),
    ("gram", False, 0.0)])
def test_flat_forces_and_step_match_jax(rng, repulsion, nohubs, delta):
    """compute_forces and fa_step on the same coords, to 1e-4 of the
    largest force: float32 sums in another order (the port's attraction is
    A x - deg x over the folded weights, JAX's a per-edge segment sum)."""
    gj, g = _graphs(rng)
    params = gp.ForceAtlasParams(repulsion=repulsion, nohubs=nohubs,
                                 delta=delta)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    degj = gj.degrees(True)
    want_f = np.asarray(jflat.compute_forces(jnp.asarray(x), gj, degj,
                                             params))
    deg = g.degrees(True)
    got_f = pflat.compute_forces(torch.from_numpy(x), g, deg, params)
    _close(got_f.numpy(), want_f, 1e-4)
    want_x, _ = jflat.fa_step(jnp.asarray(x), jnp.asarray(fprev), gj, degj,
                              params)
    got_x, _ = pflat.fa_step(torch.from_numpy(x), torch.from_numpy(fprev), g,
                             deg, params)
    _close(got_x.numpy(), np.asarray(want_x), 1e-4)


def test_sampled_repulsion_matches_jax_on_same_samples(rng):
    """The JAX estimator's sample ids come from jax.random.randint with its
    key; the port takes the same ids.  Both use the gram form."""
    gj, g = _graphs(rng)
    params = gp.ForceAtlasParams(repulsion="sampled",
                                 num_negative_samples=32)
    x = rng.uniform(-1, 1, (g.n, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jflat.compute_forces(jnp.asarray(x), gj,
                                           gj.degrees(True), params, key))
    idx = torch.from_numpy(np.asarray(jax.random.randint(key, (32,), 0,
                                                         g.n)).astype(np.int64))
    got = pflat.compute_forces(torch.from_numpy(x), g, g.degrees(True),
                               params, sample_idx=idx).numpy()
    _close(got, want, 1e-4)


@pytest.mark.parametrize("repulsion", ["gram", "exact"])
def test_force_atlas_warm_start_matches_jax(rng, repulsion):
    """Ten flat iterations from the same start (no random draw on either
    side), to 1e-3 of the layout's extent.  The adaptive-speed iteration
    amplifies float32 rounding about tenfold per ten steps (measured on
    this graph: 4e-7 after one step, 4e-3 after twenty), so longer runs
    are compared through the whole-slice test, not per coordinate."""
    gj, g = _graphs(rng, n=40)
    x0 = rng.uniform(-1, 1, (g.n, 2)).astype(np.float32)
    params = gp.ForceAtlasParams(repulsion=repulsion)
    want = np.asarray(jflat.force_atlas(gj, 2, coords=jnp.asarray(x0),
                                        params=params, iterations=10))
    got = pflat.force_atlas(g, 2, coords=torch.from_numpy(x0), params=params,
                            iterations=10, device="cpu").numpy()
    _close(got, want, 1e-3)


def test_radii_and_renormalize_match_jax(rng):
    """Same centres: the top-level and inner sweeps are the same native
    heap on the same float32 taus, so radii agree exactly."""
    gj = jsynth.mesh3d(7)
    res = gt.partition_hierarchy(gj, 0.2, emit_graphs=True)
    assert len(res.levels) >= 2
    A1, A2 = res.coarse_graphs[0], res.coarse_graphs[1]
    m1, m2 = A1.n, A2.n
    c1 = rng.uniform(-1, 1, (m1, 3)).astype(np.float32)
    c2 = rng.uniform(-1, 1, (m2, 3)).astype(np.float32)
    gp1 = interop.partition(res.levels[1].vertex_to_agg_numpy(), m2)
    pA1 = interop.graph(*A1.to_coo_numpy(), m1)
    s, r, _ = A2.to_coo_numpy()

    r2 = pradii.radii_top_level(torch.from_numpy(c2), coarse_edges=(s, r))
    r2j = jradii.radii_top_level(jnp.asarray(c2), coarse_edges=(s, r))
    np.testing.assert_array_equal(r2.numpy(), np.asarray(r2j))
    for cap in (4, 512):     # edge candidates, then all pairs
        np.testing.assert_array_equal(
            pradii.radii_top_level(torch.from_numpy(c1), max_all_pairs=cap,
                                   coarse_edges=A1.to_coo_numpy()[:2]).numpy(),
            np.asarray(jradii.radii_top_level(
                jnp.asarray(c1), max_all_pairs=cap,
                coarse_edges=A1.to_coo_numpy()[:2])))

    r1 = pradii.radii_inner(torch.from_numpy(c1), r2, pA1, gp1)
    r1j = jradii.radii_inner(jnp.asarray(c1), r2j, None, A1, res.levels[1])
    np.testing.assert_array_equal(r1.numpy(), np.asarray(r1j))
    nc, nr = pradii.renormalize_into_parents(torch.from_numpy(c1), r1,
                                             torch.from_numpy(c2), r2, gp1)
    ncj, nrj = jradii.renormalize_into_parents(jnp.asarray(c1), r1j,
                                               jnp.asarray(c2), r2j,
                                               res.levels[1])
    np.testing.assert_allclose(nc.numpy(), np.asarray(ncj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nr.numpy(), np.asarray(nrj), rtol=1e-6)


def test_project_to_levels_matches_jax(rng):
    """The warm-start chain of aggregate means: each aggregate's members
    summed in vertex order (a segment CSR), so float32 rounding only."""
    from graph_embed_tpu.embed import driver as jdriver

    from graph_embed_tpu_torch.embed import driver as pdriver

    gj = jsynth.mesh3d(7)
    res = gt.partition_hierarchy(gj, 0.2)
    assert len(res.levels) >= 2
    parts = [interop.partition(p.vertex_to_agg_numpy(), p.num_aggs)
             for p in res.levels]
    x0 = rng.uniform(-1, 1, (gj.n, 3)).astype(np.float32)
    want = jdriver.project_to_levels(jnp.asarray(x0), res.levels)
    got = pdriver.project_to_levels(torch.from_numpy(x0), parts)
    assert len(got) == len(want) == len(parts) + 1
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_embed_slice_matches_jax():
    """The slice as a whole: one graph and hierarchy (carried across with
    interop) and one warm start, so neither side draws a random init;
    JAX's slot-space refinement runs its Pallas kernels in interpret mode.
    Per-vertex coordinates agree to 2e-3 of the layout's extent (the
    refine_forces class); the radii sweeps take the same discrete pops on
    these inputs, and the layout stress agrees to 1e-3."""
    gj = jsynth.mesh3d(8)
    res = gt.partition_hierarchy(gj, 0.1, emit_graphs=True)
    graphs_j = [gj] + res.coarse_graphs
    assert len(res.levels) >= 2
    rng = np.random.default_rng(5)
    coords0 = rng.uniform(-1, 1, (gj.n, 3)).astype(np.float32)
    kw = dict(base_iterations=100, refine_iterations=5)
    want = np.asarray(gt.embed(graphs_j, res.levels, 3,
                               coords0=jnp.asarray(coords0),
                               refine_backend="tiled", **kw))

    graphs, parts = interop.hierarchy(
        [(*x.to_coo_numpy(), x.n) for x in graphs_j],
        [(p.vertex_to_agg_numpy(), p.num_aggs) for p in res.levels])
    metrics = gp.MetricsLogger()
    got = gp.embed(graphs, parts, 3, device="cpu",
                   coords0=torch.from_numpy(coords0), metrics=metrics,
                   **kw).numpy()
    assert [r["phase"] for r in metrics.records] == (
        ["base"] + ["radii", "layout", "refine"] * len(parts))
    _close(got, want, 2e-3)
    np.testing.assert_allclose(layout_stress(gj, got),
                               layout_stress(gj, want), rtol=1e-3)


def test_embed_graph_packs_levels_into_parent_balls():
    g = psynth.mesh3d(7)
    seen = []

    def check(level, coords, part, centres, radii):
        v2a = part.vertex_to_agg
        assert part.n == parts[level].n
        dist = torch.linalg.norm(coords - centres[v2a], dim=1)
        seen.append(level)
        assert bool((dist <= radii[v2a] + 1e-5).all())

    res0 = gp.partition_hierarchy(g, 0.1)
    parts = res0.levels
    coords, res = gp.embed_graph(g, 3, device="cpu", base_iterations=300,
                                 refine_iterations=10, on_level=check)
    assert res.level_sizes == res0.level_sizes
    assert seen == list(range(len(parts) - 1, -1, -1))
    assert coords.shape == (g.n, 3) and bool(torch.isfinite(coords).all())
    again, _ = gp.embed_graph(g, 3, device="cpu", base_iterations=300,
                              refine_iterations=10)
    assert torch.equal(coords, again)


def test_unported_options_raise():
    """Only linlog refinement with a mesh raises, under either sharding,
    where a level of at least mesh_min_n vertices would refine sharded
    (it names reference fault 8: the reference's sharded refinement drops
    the log term), before any level runs; the default sharding with a
    mesh runs (the replicated design).  The slot-space and sharded
    refinements refuse linlog themselves."""
    g = psynth.ring_of_cliques(3, 4)
    from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
    from graph_embed_tpu_torch.parallel import sharded_ml as SM
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, device="cpu")
    linlog = gp.MultilevelFAParams(linlog=True)
    coords, _ = gp.embed_graph(g, 2, device="cpu", mesh=mesh, mesh_min_n=1,
                               base_iterations=20, refine_iterations=3)
    assert coords.shape == (g.n, 2) and bool(torch.isfinite(coords).all())
    for sharding in ("replicated", "halo"):
        with pytest.raises(NotImplementedError, match="reference fault 8"):
            gp.embed_graph(g, 2, device="cpu", mesh=mesh, sharding=sharding,
                           mesh_min_n=1, refine_params=linlog)
    part = gp.partition_hierarchy(g, 0.1).levels[0]
    cA, rA = torch.zeros((part.num_aggs, 2)), torch.ones(part.num_aggs)
    with pytest.raises(NotImplementedError, match="portable refinement"):
        MT.refine_level_tiled(g, part, cA, rA, 2, params=linlog)
    with pytest.raises(NotImplementedError, match="reference fault 8"):
        SM.refine_level_sharded(g, part, cA, rA, 2, mesh=mesh, params=linlog)
    # x_precision has no effect on the flat base case, as in the reference
    runs = [gp.force_atlas(g, 2, params=gp.ForceAtlasParams(x_precision=xp),
                           iterations=5, device="cpu")
            for xp in ("bf16", "f32")]
    assert torch.equal(runs[0], runs[1])


def test_cli_embed_writes_finite_rows(tmp_path):
    K, C = 5, 6
    i, j = np.triu_indices(K, 1)
    lines = []
    for c in range(C):
        lines += [f"{c * K + a} {c * K + b}" for a, b in zip(i, j)]
        lines.append(f"{c * K} {((c + 1) % C) * K}")
    src = tmp_path / "ring.txt"
    src.write_text("\n".join(lines) + "\n")
    out = tmp_path / "coords.txt"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "graph_embed_tpu_torch.cli", "embed",
         "-f", str(src), "-format", "adjlist", "-symmetric", "true",
         "-dimension", "3", "-o", str(out), "-device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = np.array([[float(v) for v in line.split()]
                     for line in out.read_text().splitlines()])
    assert rows.shape == (K * C, 3)
    assert np.isfinite(rows).all()
