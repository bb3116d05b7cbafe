"""The port's portable refinement (forceatlas/multilevel.py), centroids
repulsion (forceatlas/farfield.py) and the partition drivers and helpers
it stands on, against the JAX package and the numpy oracles.

Inputs are drawn with numpy from a seed and fed to both packages.  The
parity cases run in float64 (the JAX suite's 1e-9 class), where the
port's plain versions take the graph's dtype: the two packages then differ
only in summation order (kernel A's A x - x * rowsum against a per-entry
segment sum, batched matmuls in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import farfield as jff
from graph_embed_tpu.forceatlas import flat as jflat
from graph_embed_tpu.forceatlas import multilevel as jml
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.partition import hierarchy as jhier

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.forceatlas import farfield as pff
from graph_embed_tpu_torch.forceatlas import flat as pflat
from graph_embed_tpu_torch.forceatlas import forces as pforces
from graph_embed_tpu_torch.forceatlas import multilevel as pml
from graph_embed_tpu_torch.graph import synth as psynth
from graph_embed_tpu_torch.partition import hierarchy as phier

from conftest import random_graph
import oracle_ml

F64 = torch.float64


def _level(rng, n=40, m=6, d=2, weighted=True):
    """A random float64 graph in both packages, an assignment with every
    aggregate non-empty, coordinates and parent centres."""
    gj = random_graph(rng, n, weighted=weighted)
    v2a = rng.integers(0, m, size=n).astype(np.int32)
    v2a[:m] = np.arange(m)
    g = interop.graph(*gj.to_coo_numpy(), n, dtype=F64)
    return (gj, g, gt.Partition(jnp.asarray(v2a), m),
            interop.partition(v2a, m), v2a,
            rng.uniform(-1, 1, size=(n, d)), rng.uniform(-1, 1, size=(m, d)))


def _close(got, want, rtol):
    """Every entry within ``rtol`` of the largest magnitude of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _skewed_part(rng, n=300):
    """Aggregates of 1 to 40 members, so several size classes exist."""
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 41)))
    sizes[-1] -= sum(sizes) - n
    sizes = [s for s in sizes if s > 0]
    v2a = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    return v2a.astype(np.int32), len(sizes)


@pytest.mark.parametrize("pad", [8, 4])
def test_member_tables_match_jax(rng, pad):
    """The host tables, padding value n and size classes included, are the
    JAX package's element for element."""
    v2a, m = _skewed_part(rng)
    pj = gt.Partition(jnp.asarray(v2a), m)
    pp = interop.partition(v2a, m)
    np.testing.assert_array_equal(pml.build_members(pp, pad_multiple=pad),
                                  np.asarray(jml.build_members(
                                      pj, pad_multiple=pad)))
    got = pml.build_member_buckets(pp, pad_multiple=pad)
    want = jml.build_member_buckets(pj, pad_multiple=pad)
    assert len(got) == len(want) > 2
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("exact", [False, True])
def test_aggregate_repulsion_matches_jax(rng, exact):
    """Gram and per-pair forms over the size-class tables, float64: within
    1e-9 of the largest force (summation order only)."""
    assert torch.get_float32_matmul_precision() == "highest"
    v2a, m = _skewed_part(rng)
    n = v2a.size
    x = rng.uniform(-1, 1, (n, 3))
    w = rng.uniform(1, 4, n)
    pj = gt.Partition(jnp.asarray(v2a), m)
    want = jml.aggregate_repulsion(
        jnp.asarray(x), jml.build_member_buckets(pj), jnp.asarray(w), 1.3,
        1e-5, exact=exact)
    got = pml.aggregate_repulsion(
        torch.from_numpy(x), pml.build_member_buckets(
            interop.partition(v2a, m)), torch.from_numpy(w), 1.3, 1e-5,
        exact=exact)
    _close(got.numpy(), want, 1e-9)


def test_aggregate_repulsion_chunking_is_invisible(rng):
    """The pair budget only bounds memory: a budget of one aggregate per
    chunk gives the same forces, bitwise, as the default, in float32."""
    v2a, m = _skewed_part(rng)
    x = torch.from_numpy(rng.uniform(-1, 1, (v2a.size, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 4, v2a.size).astype(np.float32))
    tables = pml.build_member_buckets(interop.partition(v2a, m))
    for exact in (False, True):
        whole = pml.aggregate_repulsion(x, tables, w, 1.0, 1e-5, exact=exact)
        tiny = pml.aggregate_repulsion(x, tables, w, 1.0, 1e-5, exact=exact,
                                       max_pairs=1)
        assert torch.equal(whole, tiny)


ML_CASES = {
    "plain exact": dict(repulsion="exact"),
    "linlog nohubs unweighted": dict(repulsion="exact", linlog=True,
                                     nohubs=True, use_weights=False),
    "centroids is gram": dict(repulsion="centroids"),
}


@pytest.mark.parametrize("case", sorted(ML_CASES))
def test_ml_forces_match_jax_and_oracle(rng, case):
    """One force evaluation on the same level, float64: against JAX's
    ml_forces at 1e-9 of the largest force, and against the oracle's
    per-aggregate transcription at 1e-9 (exact repulsion) or 1e-6 (the
    gram form, whose identity cancels for near pairs)."""
    kw = ML_CASES[case]
    gj, g, pj, pp, v2a, coords, coords_A = _level(rng, n=36, m=5, d=3)
    params = gp.MultilevelFAParams(**kw)
    deg = oracle_ml.ml_local_degrees(gj, v2a, params.use_weights)
    want_o = oracle_ml.ml_forces(
        gj, v2a, coords, coords_A, deg, linlog=params.linlog,
        nohubs=params.nohubs, use_weights=params.use_weights)
    pull_j = jml.external_pull(gj, pj, jnp.asarray(coords_A),
                               pull=params.pull, eps=params.epsilon)
    want_j = jml.ml_forces(jnp.asarray(coords), gj, pj,
                           jml.build_member_buckets(pj), jnp.asarray(deg),
                           pull_j, params)
    layout = pml.prepare_multilevel(g, pp, params)
    np.testing.assert_allclose(layout.deg_loc.numpy(), deg, rtol=1e-12)
    # weighted or nohubs-folded weights (kernel A's exact mode), or linlog
    # (kernel E takes the weights)
    assert layout.intra.w is not None
    pull_p = pml.external_pull(g, pp, torch.from_numpy(coords_A),
                               pull=params.pull, eps=params.epsilon)
    got = pml.ml_forces(torch.from_numpy(coords), layout, pull_p,
                        params).numpy()
    _close(got, want_j, 1e-9)
    _close(got, want_o, 1e-6 if case == "centroids is gram" else 1e-9)


def test_intra_csr_takes_unit_mode_for_unit_weights(rng):
    """Plain FA on unit weights folds every weight to 1: the intra CSR
    carries no weights (kernel A's unit mode) and its row sums count the
    entries; the forces match JAX's."""
    gj = jsynth.mesh3d(4, dtype=jnp.float64)
    g = interop.graph(*gj.to_coo_numpy(), gj.n, dtype=F64)
    v2a = (np.arange(gj.n) // 8).astype(np.int32)
    pj, pp = gt.Partition(jnp.asarray(v2a), 8), interop.partition(v2a, 8)
    coords = rng.uniform(-1, 1, (gj.n, 3))
    coords_A = rng.uniform(-1, 1, (8, 3))
    params = gp.MultilevelFAParams(repulsion="exact")
    layout = pml.prepare_multilevel(g, pp, params)
    assert layout.intra.w is None and layout.intra.nnz > 0
    deg = jml.local_degrees(gj, pj, True)
    pull_j = jml.external_pull(gj, pj, jnp.asarray(coords_A),
                               pull=params.pull, eps=params.epsilon)
    want = jml.ml_forces(jnp.asarray(coords), gj, pj, jml.build_members(pj),
                         deg, pull_j, params)
    pull_p = pml.external_pull(g, pp, torch.from_numpy(coords_A),
                               pull=params.pull, eps=params.epsilon)
    got = pml.ml_forces(torch.from_numpy(coords), layout, pull_p, params)
    _close(got.numpy(), want, 1e-9)


def test_ml_iteration_and_epilogue_match_jax_and_oracle(rng):
    """One iteration plus the epilogue from injected coords0: JAX's
    _ml_loop and the oracle's ml_iteration/ml_epilogue, float64, 1e-8
    (the JAX suite's bound for this loop)."""
    gj, g, pj, pp, v2a, coords, coords_A = _level(rng, n=36, m=5, d=2)
    r_A = rng.uniform(0.5, 1.2, size=5)
    params = gp.MultilevelFAParams(repulsion="exact")
    deg_j = jml.local_degrees(gj, pj, True)
    pull_j = jml.external_pull(gj, pj, jnp.asarray(coords_A),
                               pull=params.pull, eps=params.epsilon)
    want_j = np.asarray(jml._ml_loop(
        jnp.asarray(coords), gj, pj, jml.build_members(pj), deg_j, pull_j,
        jnp.asarray(coords_A), jnp.asarray(r_A), params, 1))
    deg = oracle_ml.ml_local_degrees(gj, v2a)
    x1, _ = oracle_ml.ml_iteration(gj, v2a, coords, np.zeros_like(coords),
                                   coords_A, deg)
    want_o = oracle_ml.ml_epilogue(v2a, x1, coords_A, r_A)
    got = gp.force_atlas_multilevel(
        g, pp, torch.from_numpy(coords_A), torch.from_numpy(r_A), 2,
        iterations=1, params=params, coords0=torch.from_numpy(coords),
        device="cpu")
    assert got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want_j, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got.numpy(), want_o, rtol=1e-8, atol=1e-9)


def test_force_atlas_multilevel_packs_into_parent_balls(rng):
    """Random init from the seed, 20 iterations, float32: every vertex
    inside its parent ball, and the same seed gives the same layout."""
    gj, g, pj, pp, v2a, _, coords_A = _level(rng, n=60, m=6, d=3)
    g = interop.graph(*gj.to_coo_numpy(), gj.n)
    coords_A = torch.from_numpy(coords_A.astype(np.float32))
    r_A = torch.full((6,), 0.3)
    runs = [gp.force_atlas_multilevel(g, pp, coords_A, r_A, 3, seed=4,
                                      iterations=20, device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    dist = torch.linalg.norm(runs[0] - coords_A[pp.vertex_to_agg], dim=1)
    assert bool((dist <= 0.3 + 1e-6).all())


def test_centroid_repulsion_matches_jax(rng):
    """Eight blobs of 32 points in groups (test_forces_parity.py:181-203):
    the monopole far field and exact near field, float64, 1e-9 of the
    largest force; and the approximation holds against the exact sum as
    the JAX suite asks."""
    k, per = 8, 32
    n = k * per
    centers = rng.uniform(-10, 10, size=(k, 2))
    coords = np.repeat(centers, per, axis=0) + rng.normal(size=(n, 2)) * 0.3
    v2g = np.repeat(np.arange(k), per).astype(np.int32)
    deg_p1 = rng.uniform(1, 5, size=n)
    want = np.asarray(jff.centroid_repulsion(
        jnp.asarray(coords), jnp.asarray(deg_p1),
        gt.Partition(jnp.asarray(v2g), k), 1.0, 1e-5))
    got = pff.centroid_repulsion(
        torch.from_numpy(coords), torch.from_numpy(deg_p1),
        pff.Groups.build(interop.partition(v2g, k), "cpu"), 1.0,
        1e-5).numpy()
    _close(got, want, 1e-9)
    exact = pforces.repulsion_exact(
        torch.from_numpy(coords), torch.from_numpy(deg_p1), 1.0,
        1e-5).numpy()
    rel = np.linalg.norm(got - exact, axis=1) / (
        np.linalg.norm(exact, axis=1) + 1e-9)
    assert np.median(rel) < 0.05 and rel.mean() < 0.15


def test_centroids_flat_step_matches_jax(rng):
    """compute_forces and fa_step under repulsion='centroids' with the same
    groups, float64: 1e-9 of the largest force and coordinate."""
    gj, g, _, _, _, coords, _ = _level(rng, n=80, m=4, d=2)
    v2g, m = _skewed_part(rng, n=80)
    params = gp.ForceAtlasParams(repulsion="centroids")
    deg_j = gj.degrees(True)
    gj_groups = gt.Partition(jnp.asarray(v2g), m)
    want_f = jflat.compute_forces(jnp.asarray(coords), gj, deg_j, params,
                                  groups=gj_groups)
    want_x, _ = jflat.fa_step(jnp.asarray(coords), jnp.zeros_like(
        jnp.asarray(coords)), gj, deg_j, params, groups=gj_groups)
    x = torch.from_numpy(coords)
    groups = pff.Groups.build(interop.partition(v2g, m), "cpu")
    deg = g.degrees(True)
    got_f = pflat.compute_forces(x, g, deg, params, groups=groups)
    got_x, _ = pflat.fa_step(x, torch.zeros_like(x), g, deg, params,
                             groups=groups)
    _close(got_f.numpy(), want_f, 1e-9)
    _close(got_x.numpy(), want_x, 1e-9)
    with pytest.raises(ValueError, match="groups"):
        pflat.compute_forces(x, g, deg, params)


def test_force_atlas_centroids_builds_default_groups(rng):
    """Without groups, force_atlas partitions into max(32, n // 64) parts
    (flat.py:153-157) and runs; the same seed repeats bitwise."""
    g = psynth.mesh3d(6)
    params = gp.ForceAtlasParams(repulsion="centroids")
    runs = [gp.force_atlas(g, 2, params=params, iterations=5, seed=3,
                           device="cpu") for _ in range(2)]
    assert bool(torch.isfinite(runs[0]).all())
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("which", ["single", "num_parts"])
def test_partition_drivers_match_jax_native(which):
    """partition_single and partition_num_parts run the same native
    coarsener as the JAX package's native backend: equal assignments."""
    gj = jsynth.mesh3d(9)
    g = interop.graph(*gj.to_coo_numpy(), gj.n)
    if which == "single":
        want = jhier.partition_single(gj, backend="native")
        got = phier.partition_single(g)
    else:
        want = jhier.partition_num_parts(gj, 40, backend="native")
        got = gp.partition_num_parts(g, 40)
    assert got.num_aggs == want.num_aggs
    np.testing.assert_array_equal(got.vertex_to_agg_numpy(),
                                  want.vertex_to_agg_numpy())
    with pytest.raises(NotImplementedError, match="item 7"):
        phier.partition_single(g, backend="device")


def test_partition_helpers_match_jax(rng):
    """members_csr, restrict (P^T x), prolong (P y) and
    partition_from_labels against the JAX Partition's."""
    labels = rng.choice([3, 17, 4, 99, 250], size=50)
    pj = gt.partition_from_labels(labels)
    pp = gp.partition_from_labels(labels)
    assert pp.num_aggs == pj.num_aggs == 5
    np.testing.assert_array_equal(pp.vertex_to_agg_numpy(),
                                  pj.vertex_to_agg_numpy())
    for a, b in zip(pp.members_csr(), pj.members_csr()):
        np.testing.assert_array_equal(a, b)
    x = rng.uniform(-1, 1, (50, 3))
    np.testing.assert_allclose(pp.restrict(torch.from_numpy(x)).numpy(),
                               np.asarray(pj.restrict(jnp.asarray(x))),
                               rtol=1e-12)
    y = rng.uniform(-1, 1, (5, 2))
    np.testing.assert_array_equal(pp.prolong(torch.from_numpy(y)).numpy(),
                                  np.asarray(pj.prolong(jnp.asarray(y))))


@pytest.mark.parametrize("case", sorted(ML_CASES) + ["plain gram"])
def test_ml_forces_scale_bounds_float32_rounding(rng, case):
    """ml_forces(absolute=True) is the per-element scale the card is held
    to (chip_smoke.py, tests/test_torch_cuda.py): the float32 forces stay
    within 1e-5 of it from the float64 ones, the gram form's cancellation
    included."""
    kw = ML_CASES.get(case, {})
    params = gp.MultilevelFAParams(**kw)
    _, g, _, pp, _, coords, coords_A = _level(rng, n=60, m=4, d=3)
    out = {}
    for dtype in (torch.float64, torch.float32):
        gd = interop.graph(*g.to_coo_numpy(), g.n, dtype=dtype)
        layout = pml.prepare_multilevel(gd, pp, params)
        x = torch.from_numpy(coords).to(dtype)
        pull = pml.external_pull(gd, pp, torch.from_numpy(coords_A).to(dtype),
                                 pull=params.pull, eps=params.epsilon)
        out[dtype] = (pml.ml_forces(x, layout, pull, params),
                      pml.ml_forces(x, layout, pull, params, absolute=True))
    (f64, scale), (f32, _) = out[torch.float64], out[torch.float32]
    err = (f32.double() - f64).abs()
    assert bool((err <= 1e-5 * scale).all()), float((err / scale).max())
    assert bool((scale >= f64.abs() * (1 - 1e-12)).all())
