"""The port's flat tiled step against the JAX package's: the DIA plan, the
plain versions of kernels C (sampled repulsion), D (fused step) and E
(linlog attraction), one step and a short loop on injected sample ids, and
a whole layout compared through its stress.  The JAX step runs its Pallas
kernels in interpret mode on the CPU, as tests/test_tiled_step.py does;
the kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import tiled as JTL
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.harness.runtests import layout_stress
from graph_embed_tpu.ops import bsr as JBS
from graph_embed_tpu.ops import dia as JDIA
from graph_embed_tpu.ops.pallas import edge_spmm as JES
from graph_embed_tpu.ops.pallas import repulsion as JRP
from graph_embed_tpu.utils.params import ForceAtlasParams

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.forceatlas import tiled as PTL
from graph_embed_tpu_torch.ops import dia as PDIA
from graph_embed_tpu_torch.ops import edge_spmm as PES
from graph_embed_tpu_torch.ops import fused_step as PFS
from graph_embed_tpu_torch.ops import repulsion as PRP

S = 16  # samples per step in the step tests (test_tiled_step.py:382)


def _close(got, want, tol):
    """Every entry within ``tol`` times the largest magnitude of ``want``
    (as tests/test_torch_embed.py compares forces)."""
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _port(gj):
    return interop.graph(*gj.to_coo_numpy(), gj.n)


def _ids(key, s, n):
    """The sample ids the reference draws from ``key`` (prep_samples,
    repulsion.py:132), for the port to take."""
    return torch.from_numpy(np.asarray(
        jax.random.randint(key, (s,), 0, n)).astype(np.int32))


def _unit_random(rng, n):
    """A simple random graph with unit weights (no duplicate pairs)."""
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    s, r = s[keep], r[keep]
    key = np.unique(np.minimum(s, r) * n + np.maximum(s, r))
    return gt.from_edges(key // n, key % n, None, n=n, symmetrize=True,
                         dtype=jnp.float32)


def _weighted_random(rng, n):
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    return gt.from_edges(s[keep], r[keep], rng.uniform(0.5, 2.0, keep.sum()),
                         n=n, symmetrize=True, dtype=jnp.float32)


def _weighted_mesh():
    """mesh3d(6) plus 30% random extras with symmetric non-unit weights:
    DIA offsets carry exact float32 weights, the residual truncated ones."""
    s, r, _ = jsynth.mesh3d(6, extra_frac=0.3, seed=5).to_coo_numpy()
    lo, hi = np.minimum(s, r), np.maximum(s, r)
    w = 0.5 + ((lo * 7 + hi * 3) % 11) / 7.0
    return gt.from_edges(s, r, w, n=216, symmetrize=False, dtype=jnp.float32)


# (graph, JAX prepare_tiled keywords, linlog, whether the step is fused,
#  whether residual edges remain)
CASES = {
    "pure_dia": (lambda rng: jsynth.mesh3d(6), dict(dia_min_count=32),
                 False, True, False),
    "unit_residual": (lambda rng: _unit_random(rng, 600),
                      dict(spmv_mode="packed"), False, True, True),
    "weighted_dia_residual": (lambda rng: _weighted_mesh(),
                              dict(dia_min_count=32), False, True, True),
    "linlog": (lambda rng: _weighted_random(rng, 300),
               dict(spmv_mode="packed"), True, False, True),
}


def test_plan_dia_matches_jax(rng):
    """Same offsets, weights and residual mask; the port plans over n where
    the reference plans over n_pad, whose extra columns are all zero."""
    g = jsynth.mesh3d(8, extra_frac=0.2, seed=3)
    s, r, w = g.to_coo_numpy()
    w = w * rng.uniform(0.5, 2.0, w.size)
    n_pad = -(-g.n // 256) * 256
    want = JDIA.plan_dia(s, r, w, g.n, n_pad, min_count=32)
    got = PDIA.plan_dia(s, r, w, g.n, min_count=32)
    assert want is not None and len(got.offsets) >= 6
    assert got.offsets == want.offsets
    np.testing.assert_array_equal(got.weights, want.weights[:, :g.n])
    assert not want.weights[:, g.n:].any()
    np.testing.assert_array_equal(got.residual_mask, want.residual_mask)
    np.testing.assert_array_equal(PDIA.dia_row_sums(got.weights),
                                  JDIA.dia_row_sums(want.weights)[:g.n])
    # the plain DIA SpMV equals the reference's lane rolls
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    y = PDIA.dia_spmv(torch.from_numpy(x), torch.from_numpy(got.weights),
                      got.offsets)
    yT = JDIA.dia_spmv(JES.pad_coords_T(jnp.asarray(x), n_pad),
                       jnp.asarray(want.weights), want.offsets)
    np.testing.assert_allclose(y.numpy(), interop.from_transposed(yT, g.n, 3),
                               rtol=1e-6, atol=1e-6)
    # below the default count (max(2^16, n // 16)) neither plans an offset
    assert PDIA.plan_dia(s, r, w, g.n) is None
    assert JDIA.plan_dia(s, r, w, g.n, n_pad) is None


def test_plain_kernel_c_matches_jax(rng):
    """Both sides compute the diff-form estimator in float32 on the same
    ids; they differ only in summation order, so each element agrees to
    1e-5 of its own sum of |terms|."""
    n, d, s = 700, 3, 64
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    deg_p1 = rng.uniform(1, 5, n).astype(np.float32)
    key = jax.random.PRNGKey(42)
    n_pad = 1024
    deg_pad = jnp.zeros(n_pad, jnp.float32).at[:n].set(deg_p1)
    want = interop.from_transposed(JRP.repulsion_sampled_fused(
        jnp.asarray(interop.to_transposed(x, n_pad)), deg_pad, key, n=n,
        num_samples=s, repel=1.3, eps=1e-5, interpret=True), n, d)
    ids = _ids(key, s, n)
    xt, dt = torch.from_numpy(x), torch.from_numpy(deg_p1)
    got = PRP.repulsion_sampled(xt, dt, ids, repel=1.3, eps=1e-5).numpy()
    scale = PRP.repulsion_sampled_plain(xt, dt, ids, repel=1.3, eps=1e-5,
                                        absolute=True).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_step_matches_jax(rng, case):
    """One step of the port against fa_step_tiled_T on the same state and
    sample ids, to 1e-4 (test_tiled_step.py:40; the reference's residual
    SpMV carries a ~2^-16 relative bf16 hi/lo scatter error) and 1e-3
    under linlog (test_tiled_step.py:140): coordinates element by element,
    forces relative to the largest force (they reach ~5e3 here, where
    float32 sums in another order move an element by ~3e-4)."""
    make, kw, linlog, fused, residual = CASES[case]
    gj = make(rng)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S,
                              linlog=linlog)
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True, **kw)
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    assert PTL.fused_applies(tfa, params) == fused
    assert (tfa.csr is not None) == residual
    assert tfa.dia_offsets == tuple(tfa_j.dia_offsets)
    np.testing.assert_array_equal(tfa.deg_w_att.numpy(),
                                  np.asarray(tfa_j.deg_w_att)[:g.n])
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    xT, fT = JTL.fa_step_tiled_T(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)),
        jnp.asarray(interop.to_transposed(fprev, tfa_j.n_pad)), tfa_j,
        params, key)
    got_x, got_f = PTL.fa_step_tiled(torch.from_numpy(x),
                                     torch.from_numpy(fprev), tfa, params,
                                     sample_idx=_ids(key, S, g.n))
    tol = 1e-3 if linlog else 1e-4
    _close(got_f.numpy(), interop.from_transposed(fT, g.n, 3), tol)
    np.testing.assert_allclose(got_x.numpy(),
                               interop.from_transposed(xT, g.n, 3),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("repulsion", ["exact", "centroids"])
def test_tiled_step_exact_repulsion_matches_jax(rng, repulsion):
    """Every repulsion name but 'sampled' and 'gram' takes exact repulsion
    in the reference's tiled step (tiled.py:274-275), 'centroids'
    included: the port's tiled_forces and one fa_step_tiled equal the JAX
    package's on a small weighted graph from injected coordinates, to
    1e-4 (test_tiled_step.py:40), forces relative to the largest force.  A
    short layout under 'centroids' is the 'exact' one, bit for bit."""
    gj = _weighted_random(rng, 300)
    g = _port(gj)
    params = ForceAtlasParams(repulsion=repulsion)
    kw = dict(spmv_mode="packed")
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True, **kw)
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    assert not PTL.fused_applies(tfa, params)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    want_f = np.asarray(JTL.tiled_forces(jnp.asarray(x), tfa_j, params))
    got_f = PTL.tiled_forces(torch.from_numpy(x), tfa, params).numpy()
    _close(got_f, want_f, 1e-4)
    xj, fj = JTL.fa_step_tiled(jnp.asarray(x), jnp.asarray(fprev), tfa_j,
                               params)
    got_x, got_f = PTL.fa_step_tiled(torch.from_numpy(x),
                                     torch.from_numpy(fprev), tfa, params)
    _close(got_f.numpy(), np.asarray(fj), 1e-4)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(xj), rtol=1e-4,
                               atol=1e-4)
    runs = [gp.force_atlas_tiled(g, 3, params=ForceAtlasParams(repulsion=r),
                                 iterations=3, seed=4, device="cpu")
            for r in (repulsion, "exact")]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("case", ["pure_dia", "unit_residual"])
def test_tiled_loop_matches_jax(rng, case):
    """Five steps from one start, each on the ids the reference's loop
    draws (key, sub = split(key), tiled.py:389-391), to 1e-4."""
    make, kw, _, _, _ = CASES[case]
    gj = make(rng)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True, **kw)
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    x0 = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ids, k = [], key
    for _ in range(5):
        k, sub = jax.random.split(k)
        ids.append(_ids(sub, S, g.n))
    want = np.asarray(JTL._tiled_loop_T(
        jnp.asarray(interop.to_transposed(x0, tfa_j.n_pad)), tfa_j, key,
        params, 5))
    got = PTL.tiled_loop(torch.from_numpy(x0), tfa, params, 5,
                         sample_ids=ids).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["pure_dia", "weighted_dia_residual"])
def test_fused_step_matches_composed(rng, case):
    """Kernel D's plain version against the step composed term by term
    (tiled_forces + the speed update), to 1e-5 (test_tiled_step.py:396)."""
    make, kw, _, _, _ = CASES[case]
    g = _port(make(rng))
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    x = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    fprev = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, g.n, S).astype(np.int32))
    got_x, got_f = PTL.fa_step_tiled(x, fprev, tfa, params, sample_idx=ids)
    want_f = PTL.tiled_forces(x, tfa, params, sample_idx=ids)
    want_x = PFS.speed_update(x, want_f, fprev, params)
    torch.testing.assert_close(got_f, want_f, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_x, want_x, rtol=1e-5, atol=1e-5)


def test_plain_kernel_e_matches_jax_attraction(rng):
    """Kernel E's plain version against the Pallas per-edge kernel
    (interpret mode) on the folded float32 weights, to 1e-5 of each
    element's sum of |terms|."""
    gj = _weighted_random(rng, 300)
    g = _port(gj)
    params = ForceAtlasParams(linlog=True)
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True)
    tfa = PTL.prepare_tiled(g, 3, params)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    want = interop.from_transposed(JES.attraction_tiled(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)), tfa_j.tiles,
        attract=1.0, linlog=True, eps=params.epsilon, interpret=True),
        g.n, 3)
    xt = torch.from_numpy(x)
    got = PES.linlog(xt, tfa.csr, attract=1.0, eps=params.epsilon).numpy()
    scale = PES.linlog_plain(xt, tfa.csr, attract=1.0, eps=params.epsilon,
                             absolute=True).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-30)


def test_flat_linlog_forces_match_jax(rng):
    """The flat base case's linlog attraction now runs through kernel E's
    plain version (float32 folded weights); its forces match the JAX base
    case's per-edge segment sum to 1e-4 of the largest force."""
    from graph_embed_tpu.forceatlas import flat as jflat

    from graph_embed_tpu_torch.forceatlas import flat as pflat

    gj = _weighted_random(rng, 60)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="exact", linlog=True, nohubs=True)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    want = np.asarray(jflat.compute_forces(jnp.asarray(x), gj,
                                           gj.degrees(True), params))
    got = pflat.compute_forces(torch.from_numpy(x), g, g.degrees(True),
                               params).numpy()
    _close(got, want, 1e-4)


def test_force_atlas_tiled_stress_matches_jax():
    """A whole layout of a ring of cliques on each side.  The random
    streams differ (threefry vs Philox: init and samples), so the layouts
    are compared through their stress, to 25%: the reference's own stress
    over keys 0-2 spans 0.153-0.221 on this graph (the port's 0.164-0.189;
    key 0 gives 0.184 against the port's 0.164 at seed 0)."""
    gj = jsynth.ring_of_cliques(8, 6)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
    want = np.asarray(JTL.force_atlas_tiled(gj, 2, params=params,
                                            iterations=300,
                                            key=jax.random.PRNGKey(0)))
    got = gp.force_atlas_tiled(g, 2, params=params, iterations=300, seed=0,
                               device="cpu")
    assert got.shape == (g.n, 2) and bool(torch.isfinite(got).all())
    sj, sp = layout_stress(gj, want), layout_stress(gj, got.numpy())
    assert abs(sp - sj) <= 0.25 * sj, (sp, sj)


def test_prepare_tiled_modes():
    g = _port(jsynth.mesh3d(6))
    params = ForceAtlasParams(repulsion="sampled")
    for mode in ("packed", "bsr"):
        tfa = PTL.prepare_tiled(g, 3, params, spmv_mode=mode)
        assert tfa.dia_offsets == () and tfa.csr.nnz == g.num_edges
        assert tfa.csr.w is None  # unit weights: kernel A's unit mode
    tfa = PTL.prepare_tiled(g, 3, params, spmv_mode="dia", dia_min_count=32)
    assert tfa.csr is None and len(tfa.dia_offsets) == 6
    assert tfa.dia_off.tolist() == list(tfa.dia_offsets)
    # a one-tier tiling claims every edge; no DIA plan beside it
    tfa = PTL.prepare_tiled(g, 3, params, tiered_specs=((128, 128, 128),),
                            tiered_thresholds=())
    assert tfa.dia_offsets == () and tfa.csr.nnz == g.num_edges
    assert tfa.csr.kind == "unit"
    with pytest.raises(ValueError):
        PTL.prepare_tiled(g, 3, params, spmv_mode="windowed")
    with pytest.raises(ValueError, match="generator"):
        PTL.fa_step_tiled(torch.zeros((g.n, 3)), torch.zeros((g.n, 3)), tfa,
                          params)


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the wrappers of kernels C, D and E raise; only the
    dispatchers route CPU tensors to the plain versions."""
    g = _port(jsynth.mesh3d(4))
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=4)
    tfa = PTL.prepare_tiled(g, 3, params, dia_min_count=8)
    x = torch.zeros((g.n, 3))
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        PRP.repulsion_sampled_cuda(x, tfa.deg_p1, ids, repel=1.0, eps=1e-5)
    with pytest.raises(ValueError):
        PFS.fa_step_fused_cuda(x, x, tfa.dia_w, tfa.dia_off, None,
                               tfa.deg_w_att, tfa.deg_p1, ids, params)
    csr, _ = PES.build_csr(*g.to_coo_numpy(), g.n)
    with pytest.raises(ValueError):
        PES.linlog_cuda(x, csr, attract=1.0, eps=1e-5)


def test_transposed_state_roundtrip(rng):
    x = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    xT = interop.to_transposed(x, 128)
    assert xT.shape == (interop.D_PAD, 128) and not xT[3:].any()
    assert not xT[:, 10:].any()
    np.testing.assert_array_equal(interop.from_transposed(xT, 10, 3), x)
    np.testing.assert_array_equal(
        xT, np.asarray(JES.pad_coords_T(jnp.asarray(x), 128)))


# Repairs of the tiled plan against the reference's tile shape, DIA
# threshold, overflow weights and BSR weights.

class _Captured(Exception):
    pass


class _Shim:
    """A two-edge graph of ``n`` vertices, enough for the reference's
    prepare_tiled to resolve its tile shape."""

    def __init__(self, n, w):
        self.n = n
        self._coo = (np.array([0, 1]), np.array([1, 0]), np.array([w, w]))

    def to_coo_numpy(self):
        return self._coo

    def degrees_numpy(self, use_weights=True):
        return np.bincount(self._coo[0], weights=self._coo[2],
                           minlength=self.n)


@pytest.mark.parametrize("xprec", ["f32", "bf16"])
@pytest.mark.parametrize("unit", [True, False])
def test_reference_shape_is_the_reference_s(monkeypatch, unit, xprec):
    """(sender_block, window, tile, n_pad) exactly as the reference's
    prepare_tiled resolves them, captured at its DIA plan and tile build,
    on both sides of its 1.5M-vertex big-graph rule."""
    seen = {}

    def plan_dia(s, r, w, n, n_pad, **kw):
        seen["n_pad"] = n_pad

    def build_window_tiles(g, **kw):
        seen.update(kw)
        raise _Captured

    monkeypatch.setattr(JDIA, "plan_dia", plan_dia)
    monkeypatch.setattr(JES, "build_window_tiles", build_window_tiles)
    params = ForceAtlasParams(repulsion="sampled", x_precision=xprec)
    for n in (1000, 1_499_999, 1_500_000, 1_500_001, 1_600_001, 3_000_000):
        seen.clear()
        with pytest.raises(_Captured):
            JTL.prepare_tiled(_Shim(n, 1.0 if unit else 2.0), 3, params,
                              spmv_mode="dia", interpret=True)
        want = (seen["sender_block"], seen["window"], seen["tile"],
                seen["n_pad"])
        assert PTL.reference_shape(n, unit, xprec) == want, n


def test_dia_threshold_counts_n_pad():
    """One offset of 100,100 edges at n = 1,600,001: above n // 16 =
    100,000 but below the reference's n_pad // 16 = 100,352 (unit weights,
    4096-by-8192 tiles), so neither package plans it."""
    n = 1_600_001
    s = np.arange(100_100)
    r = s + 1
    w = np.ones(s.size)
    n_pad = PTL.reference_shape(n, True)[3]
    assert n // 16 < s.size < n_pad // 16
    assert JDIA.plan_dia(s, r, w, n, n_pad) is None
    assert PDIA.plan_dia(s, r, w, n, n_pad=n_pad) is None
    assert PDIA.plan_dia(s, r, w, n).offsets == (1,)  # n's own threshold
    ss = np.concatenate([s, r])
    rr = np.concatenate([r, s])
    order = np.lexsort((rr, ss))
    g = interop.graph(ss[order], rr[order], np.ones(ss.size), n)
    tfa = PTL.prepare_tiled(g, 3, ForceAtlasParams(repulsion="sampled"))
    assert tfa.dia_offsets == () and tfa.csr.nnz == ss.size


def _sparse_cells_graph(rng, n=2000):
    """Weighted, local edges dense in the diagonal (256, 256) cells plus a
    few scattered ones: most off-diagonal cells hold fewer than 8 edges."""
    s = rng.integers(0, n, 6000)
    r = np.clip(s + rng.integers(-60, 60, s.size), 0, n - 1)
    s = np.concatenate([s, rng.integers(0, n, 150)])
    r = np.concatenate([r, rng.integers(0, n, 150)])
    keep = s != r
    return gt.from_edges(s[keep], r[keep], rng.uniform(0.5, 2.0, keep.sum()),
                         n=n, symmetrize=True, dtype=jnp.float32)


def test_min_pair_edges_keeps_overflow_weights_exact(rng):
    """min_pair_edges=8: the edges of sparser cells keep their float32
    weight, as on the reference's overflow path; the row sums equal
    tiled_row_sums bitwise, and one step matches the reference's."""
    gj = _sparse_cells_graph(rng)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    kw = dict(spmv_mode="packed", min_pair_edges=8)
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True, **kw)
    assert 0 < tfa_j.tiles.num_overflow < g.num_edges
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    np.testing.assert_array_equal(tfa.deg_w_att.numpy(),
                                  np.asarray(tfa_j.deg_w_att)[:g.n])
    w = tfa.csr.w.numpy()
    assert (PES.truncate_bf16(w) != w).sum() == tfa_j.tiles.num_overflow
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = np.zeros_like(x)
    key = jax.random.PRNGKey(2)
    xT, fT = JTL.fa_step_tiled_T(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)),
        jnp.asarray(interop.to_transposed(fprev, tfa_j.n_pad)), tfa_j,
        params, key)
    got_x, got_f = PTL.fa_step_tiled(torch.from_numpy(x),
                                     torch.from_numpy(fprev), tfa, params,
                                     sample_idx=_ids(key, S, g.n))
    _close(got_f.numpy(), interop.from_transposed(fT, g.n, 3), 1e-4)


def _bsr_graph(rng, n=1024):
    """Weighted and locality-rich without DIA structure: dense random
    (256, 256) diagonal blocks (~500 edges each) and a few scattered edges
    whose pairs stay sparse."""
    s = rng.integers(0, n, 2000)
    r = (s // 256) * 256 + rng.integers(0, 256, s.size)
    s = np.concatenate([s, rng.integers(0, n, 60)])
    r = np.concatenate([r, rng.integers(0, n, 60)])
    keep = s != r
    return gt.from_edges(s[keep], r[keep], rng.uniform(0.5, 2.0, keep.sum()),
                         n=n, symmetrize=True, dtype=jnp.float32)


def test_bsr_weight_rule_matches_reference(rng):
    """Where the reference's 'auto' takes BSR blocks: dense-pair weights
    rounded to nearest bf16 and overflow weights exact, bitwise; row sums
    to float32 rounding (rtol 1e-6); the attraction to spmv_bsr's class
    (rtol 2e-4: its x runs through two bf16 passes)."""
    gj = _bsr_graph(rng)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True)
    blocks = tfa_j.tiles
    assert isinstance(blocks, JBS.BsrBlocks) and blocks.num_overflow > 0
    tfa = PTL.prepare_tiled(g, 3, params)
    assert tfa.dia_offsets == () and tfa.csr.kind == "weighted"
    # the reference's (s, r, w) from its dense blocks and overflow COO
    bl = np.asarray(blocks.blocks.astype(jnp.float32))
    p, i, j = np.nonzero(bl)
    s = np.asarray(blocks.sb)[p].astype(np.int64) * 256 + i
    r = np.asarray(blocks.rw)[p].astype(np.int64) * 256 + j
    s = np.concatenate([s, np.asarray(blocks.overflow_s)])
    r = np.concatenate([r, np.asarray(blocks.overflow_r)])
    w = np.concatenate([bl[p, i, j], np.asarray(blocks.overflow_w)])
    order = np.lexsort((r, s))
    counts = np.diff(tfa.csr.indptr.numpy())
    got_s = np.repeat(np.arange(g.n), counts)
    got_r = tfa.csr.col.numpy()
    got_order = np.lexsort((got_r, got_s))
    np.testing.assert_array_equal(got_s[got_order], s[order])
    np.testing.assert_array_equal(got_r[got_order], r[order])
    np.testing.assert_array_equal(tfa.csr.w.numpy()[got_order], w[order])
    np.testing.assert_allclose(tfa.deg_w_att.numpy(),
                               np.asarray(tfa_j.deg_w_att)[:g.n], rtol=1e-6)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    want = interop.from_transposed(JTL._attraction_T(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)), tfa_j, params),
        g.n, 3)
    got = PTL._attraction(torch.from_numpy(x), tfa, params).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
