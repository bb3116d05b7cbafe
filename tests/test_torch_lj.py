"""The LJ-scale flat step's slice of the port against the JAX package:
community graphs, the reorderings, the bf16-pair coordinate gather
(kernel A's bf16x mode, plain version), tiered tilings, and the bf16 slot
refinement.  The JAX side runs its Pallas kernels in interpret mode on
the CPU, as tests/test_edge_spmm.py does; the kernels themselves are held
to these plain versions on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import multilevel_tiled as jmlt
from graph_embed_tpu.forceatlas import tiled as JTL
from graph_embed_tpu.graph import reorder as jreorder
from graph_embed_tpu.graph import synth as jsynth
from graph_embed_tpu.ops.pallas import edge_spmm as JES
from graph_embed_tpu.parallel.sharded import _CooShim
from graph_embed_tpu.partition import interpolation as jinterp
from graph_embed_tpu.utils.params import ForceAtlasParams, MultilevelFAParams

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as pmlt
from graph_embed_tpu_torch.forceatlas import tiled as PTL
from graph_embed_tpu_torch.graph import reorder as preorder
from graph_embed_tpu_torch.graph import synth as psynth
from graph_embed_tpu_torch.ops import edge_spmm as PES
from graph_embed_tpu_torch.ops import fused_step as PFS

S = 16  # samples per step (test_tiled_step.py:382)
# the bf16 tier (8 + 8 index bits) and the wide tier (10 + 10) of one tiling
TIER_SPECS = ((256, 256, 128), (1024, 1024, 128))


def _port(gj):
    return interop.graph(*gj.to_coo_numpy(), gj.n)


def _ids(key, s, n):
    """The sample ids the reference draws from ``key`` (repulsion.py:132)."""
    return torch.from_numpy(np.asarray(
        jax.random.randint(key, (s,), 0, n)).astype(np.int32))


def _close(got, want, tol):
    """Every entry within ``tol`` times the largest magnitude of ``want``."""
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _within_scale(got, want, scale, rtol=1e-5):
    """Element by element within ``rtol`` of its own sum of |terms|."""
    err = np.abs(got - want)
    assert (err <= rtol * scale + 1e-30).all(), float((err / scale).max())


def _community(rng, weighted, k=4, m=640):
    """Dense community blocks plus a scattered residual (the bimodal shape
    tiers exist for, test_edge_spmm.py:147-166), unit or weighted."""
    n = k * m
    ss = [rng.integers(0, m, 4000) + c * m for c in range(k)]
    rr = [rng.integers(0, m, 4000) + c * m for c in range(k)]
    s = np.concatenate(ss + [rng.integers(0, n, 1500)])
    r = np.concatenate(rr + [rng.integers(0, n, 1500)])
    keep = s != r
    s, r = s[keep], r[keep]
    key = np.unique(np.minimum(s, r) * n + np.maximum(s, r))
    s, r = key // n, key % n
    w = rng.uniform(0.5, 2.0, s.size) if weighted else None
    return gt.from_edges(s, r, w, n=n, symmetrize=True, dtype=jnp.float32)


def test_community_rmat_coo_is_the_reference_s():
    gj = jsynth.community_rmat(8, 12, 8, seed=1)
    g = psynth.community_rmat(8, 12, 8, seed=1)
    assert g.n == gj.n == 4096
    for got, want in zip(g.to_coo_numpy(), gj.to_coo_numpy()):
        np.testing.assert_array_equal(got, want)
    assert gp.community_rmat is psynth.community_rmat


def test_compose_and_partition_order_match_reference():
    """One hierarchy (the port's native coarsener) handed to both packages:
    the composed assignments, the partition order and the relabelled graph
    are equal."""
    g = psynth.community_rmat(4, 10, 8, seed=3)
    levels = gp.partition_hierarchy(g, 0.1).levels
    assert len(levels) >= 2
    jlevels = [gt.Partition.from_numpy(p.vertex_to_agg_numpy(), p.num_aggs)
               for p in levels]
    for upto in range(1, len(levels) + 1):
        got = gp.compose(levels, upto)
        want = jinterp.compose(jlevels, upto)
        assert got.num_aggs == want.num_aggs
        np.testing.assert_array_equal(got.vertex_to_agg_numpy(),
                                      want.vertex_to_agg_numpy())
    gj = gt.from_edges(*g.to_coo_numpy(), n=g.n, symmetrize=False,
                       dtype=jnp.float32)
    perm = gp.partition_order(g, levels=levels)
    np.testing.assert_array_equal(
        perm, jreorder.partition_order(gj, levels=jlevels))
    got, inv = gp.apply_order(g, perm)
    want, inv_j = jreorder.apply_order(gj, perm)
    np.testing.assert_array_equal(inv, inv_j)
    for a, b in zip(got.to_coo_numpy(), want.to_coo_numpy()):
        np.testing.assert_array_equal(a, b)


def test_rcm_order_matches_reference():
    perm = preorder.rcm_order(psynth.mesh3d(6))
    np.testing.assert_array_equal(perm, jreorder.rcm_order(jsynth.mesh3d(6)))
    assert np.array_equal(np.sort(perm), np.arange(216))


@pytest.mark.parametrize("d", [2, 3, 4])
def test_pack_x_bf16_is_the_reference_layout(rng, d):
    """Word for word pack_gather_layout_bf16 (edge_spmm.py:1167) once its
    [8, 128]-vreg layout is undone; values halfway between two bf16 and
    signed zeros included (round to nearest even)."""
    n, n_pad = 1000, 1024
    x = rng.uniform(-3, 3, (n, d)).astype(np.float32)
    bits = x.view(np.int32)
    bits[:100] = (bits[:100] & np.int32(-65536)) | np.int32(0x8000)
    x[100:110] = -0.0
    xT = jnp.zeros((JES.D_PAD, n_pad), jnp.float32).at[:d, :n].set(x.T)
    d2 = (d + 1) // 2
    packed = np.asarray(JES.pack_gather_layout_bf16(xT, d))
    want = packed.reshape(8, n_pad // 1024, d2, 128).transpose(
        2, 1, 0, 3).reshape(d2, n_pad).T[:n]
    got = PES.pack_x_bf16(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PES.unpack_x_bf16(torch.from_numpy(got), d).numpy(),
        torch.from_numpy(x).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("B,W,k", [(2048, 2048, 4), (1024, 4096, 2)])
def test_plain_bf16x_spmv_matches_v12b(rng, B, W, k):
    """The shapes of test_edge_spmm.py:314-339.  Both sides gather the same
    bf16-rounded x and sum exact products in float32 (the reference's
    single scatter plane), so each element agrees to 1e-5 of its own sum
    of |terms|; the order of the sum alone differs."""
    n, E = 4000, 50000
    s = rng.integers(0, n, E)
    r = rng.integers(0, n, E)
    keep = s != r
    s, r = s[keep].astype(np.int64), r[keep].astype(np.int64)
    x0 = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    t = JES.build_window_tiles(_CooShim(s, r, np.ones(s.size, np.float32), n),
                               tile=1024, sender_block=B, window=W,
                               packing="unit")
    tk = JES.pair_window_tiles(t, k)
    xT = jnp.zeros((JES.D_PAD, t.n_pad), jnp.float32).at[:3, :n].set(
        jnp.asarray(x0).T)
    want = np.asarray(JES.spmv_windowed(xT, tk, dmax=4, variant=f"v12bp{k}",
                                        interpret=True)[:3, :n]).T
    csr, _ = PES.build_csr(s, r, None, n)
    x = torch.from_numpy(x0)
    got = PES.spmv_windowed(x, csr, variant=f"v12bp{k}").numpy()
    xb = x.to(torch.bfloat16).float()
    scale = PES.spmv_plain(xb.abs(), csr).numpy()
    _within_scale(got, want, scale)
    # and it is the quantized SpMV, not the float32 one
    np.testing.assert_array_equal(got, PES.spmv_plain(xb, csr).numpy())


def _reference_tier_coo(tiles):
    """(s, r, w) of every live slot and overflow edge of the reference's
    tiers, decoded from their packed words."""
    ss, rr, ww = [], [], []
    for t in tiles.tiers:
        B, W = t.sender_block, t.window
        bits_s = B.bit_length() - 1
        word = t.packed[:, 0, :]
        if t.packing == "unit":
            live = word < 0
            w = np.ones(word.shape, np.float32)
        elif t.packing == "wide":
            w = np.ascontiguousarray(t.packed[:, 1, :]).view(np.float32)
            live = w != 0
        else:
            w = (word & np.int32(-65536)).view(np.float32)
            live = word != 0
        sb = (t.sbf >> 1).astype(np.int64)[:, None]
        s = sb * B + (word & (B - 1))
        r = t.rw.astype(np.int64)[:, None] * W + ((word >> bits_s) & (W - 1))
        ss.append(s[live])
        rr.append(r[live])
        ww.append(w[live])
        ss.append(t.overflow_s)
        rr.append(t.overflow_r)
        ww.append(t.overflow_w)
    s, r, w = (np.concatenate(a) for a in (ss, rr, ww))
    order = np.lexsort((r, s))
    return s[order], r[order], w[order]


def _csr_coo(csr):
    counts = np.diff(csr.indptr.numpy())
    s = np.repeat(np.arange(csr.n_rows), counts)
    r = csr.col.numpy().astype(np.int64)
    w = (np.ones(s.size, np.float32) if csr.w is None else csr.w.numpy())
    order = np.lexsort((r, s))
    return s[order], r[order], w[order]


@pytest.mark.parametrize("weighted", [False, True])
def test_build_tiered_csr_matches_reference_tiers(rng, weighted):
    """Every edge carries the weight its reference tier stores (bitwise:
    truncated on the (256, 256) tier, exact on the wide (1024, 1024) one);
    the row sums agree to float32 rounding (the reference adds its tiers'
    float32 sums, edge_spmm.py:717-722)."""
    gj = _community(rng, weighted)
    s, r, w = gj.to_coo_numpy()
    tiles = JES.build_tiered_tiles(gj, specs=TIER_SPECS, thresholds=(32,),
                                   packing="bf16" if weighted else "unit")
    assert [t.packing for t in tiles.tiers] == (
        ["bf16", "wide"] if weighted else ["unit", "unit"])
    assert all(t.num_tiles > 1 for t in tiles.tiers)
    csr, deg_w = PES.build_tiered_csr(s, r, w, gj.n, specs=TIER_SPECS,
                                      thresholds=(32,),
                                      packing="bf16" if weighted else "unit")
    assert csr.kind == ("weighted" if weighted else "unit")
    for got, want in zip(_csr_coo(csr), _reference_tier_coo(tiles)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(deg_w.numpy(),
                               JES.tiered_row_sums(tiles)[:gj.n], rtol=1e-6)
    if weighted:
        # every weight of the bf16 tier truncated, some of the wide tier not
        trunc = PES.truncate_bf16(csr.w.numpy())
        assert (trunc != csr.w.numpy()).any()
        only_wide, _ = PES.build_tiered_csr(
            s, r, w, gj.n, specs=TIER_SPECS[1:], thresholds=(),
            packing="bf16")
        assert only_wide.kind == "exact"


@pytest.mark.parametrize("weighted", [False, True])
def test_tiered_forces_match_reference(rng, weighted):
    """The tiered plan's forces against the reference's unfused
    tiled_forces_T (its fused branch cannot take a tiered tiling), to 1e-4
    of the largest force (test_tiled_step.py:40); kernel D's plain version
    on the same plan equals the composed step to 1e-5."""
    gj = _community(rng, weighted, k=2, m=300)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    kw = dict(tiered_specs=TIER_SPECS, tiered_thresholds=(32,))
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True, **kw)
    tfa = PTL.prepare_tiled(g, 3, params, **kw)
    assert tfa.dia_offsets == () and tfa.csr.nnz == g.num_edges
    np.testing.assert_allclose(tfa.deg_w_att.numpy(),
                               np.asarray(tfa_j.deg_w_att)[:g.n], rtol=1e-6)
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    fT = JTL.tiled_forces_T(jnp.asarray(interop.to_transposed(x,
                                                              tfa_j.n_pad)),
                            tfa_j, params, key)
    ids = _ids(key, S, g.n)
    xt, ft = torch.from_numpy(x), torch.from_numpy(fprev)
    got = PTL.tiled_forces(xt, tfa, params, sample_idx=ids)
    _close(got.numpy(), interop.from_transposed(fT, g.n, 3), 1e-4)
    assert PTL.fused_applies(tfa, params)
    got_x, got_f = PTL.fa_step_tiled(xt, ft, tfa, params, sample_idx=ids)
    torch.testing.assert_close(got_f, got, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_x, PFS.speed_update(xt, got, ft, params),
                               rtol=1e-5, atol=1e-5)


def _unit_random(rng, n):
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    key = np.unique(np.minimum(s, r)[keep] * n + np.maximum(s, r)[keep])
    return gt.from_edges(key // n, key % n, None, n=n, symmetrize=True,
                         dtype=jnp.float32)


def test_bf16_step_matches_reference(rng):
    """One x_precision='bf16' step against fa_step_tiled_T with the same
    option (v12bp4 in interpret mode), to 1e-4; its attraction term to
    1e-5 of each element's sum of |terms|, a bound the float32 gather
    misses."""
    gj = _unit_random(rng, 600)
    g = _port(gj)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=S,
                              x_precision="bf16")
    tfa_j = JTL.prepare_tiled(gj, 3, params, interpret=True,
                              spmv_mode="packed")
    assert tfa_j.tiles.group > 1 and tfa_j.tiles.window % 1024 == 0
    tfa = PTL.prepare_tiled(g, 3, params, spmv_mode="packed")
    assert tfa.csr.kind == "unit" and tfa.csr.bf16_gather
    x = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    fprev = rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    xT, fT = JTL.fa_step_tiled_T(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)),
        jnp.asarray(interop.to_transposed(fprev, tfa_j.n_pad)), tfa_j,
        params, key)
    want_f = interop.from_transposed(fT, g.n, 3)
    ids = _ids(key, S, g.n)
    got_x, got_f = PTL.fa_step_tiled(torch.from_numpy(x),
                                     torch.from_numpy(fprev), tfa, params,
                                     sample_idx=ids)
    _close(got_f.numpy(), want_f, 1e-4)
    np.testing.assert_allclose(got_x.numpy(),
                               interop.from_transposed(xT, g.n, 3),
                               rtol=1e-4, atol=1e-4)
    # the attraction alone: to 1e-5 of each element's sum of |terms|,
    # which the float32 gather misses
    want_a = interop.from_transposed(JTL._attraction_T(
        jnp.asarray(interop.to_transposed(x, tfa_j.n_pad)), tfa_j, params),
        g.n, 3)
    xt = torch.from_numpy(x)
    xb = xt.to(torch.bfloat16).float()
    scale = (PES.spmv_plain(xb.abs(), tfa.csr)
             + xt.abs() * tfa.deg_w_att[:, None]).numpy()
    _within_scale(PTL._attraction(xt, tfa, params).numpy(), want_a, scale)
    f32 = ForceAtlasParams(repulsion="sampled", num_negative_samples=S)
    err = np.abs(PTL._attraction(xt, tfa, f32).numpy() - want_a)
    assert (err > 1e-5 * scale).any()


def _unit_level(rng, n=400, m=12):
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    pairs = np.unique(np.stack([np.minimum(s, r), np.maximum(s, r)]), axis=1)
    s, r = pairs[:, pairs[0] != pairs[1]]
    gj = gt.from_edges(s, r, None, n=n, symmetrize=True, dtype=jnp.float32)
    v2a = rng.integers(0, m, n).astype(np.int32)
    v2a[:m] = np.arange(m)
    v2a[m: m + 60] = 0
    return (gj, gt.Partition.from_numpy(v2a, m),
            interop.graph(*gj.to_coo_numpy(), n), interop.partition(v2a, m))


def test_bf16_slot_refine_matches_reference(rng):
    """Unit intra weights and an unchunked slot tiling: the reference
    refines with the bf16-pair gather and so does the port.  The slot
    attraction agrees to 1e-5 of each element's sum of |terms| (vertex
    space; the slot layouts differ), a refined level to the 2e-3 class of
    test_torch_refine.py."""
    gj, pj, g, p = _unit_level(rng)
    d = 3
    params = MultilevelFAParams(x_precision="bf16")
    lj = jmlt.prepare_refine(gj, pj, params)
    assert lj.tiles.packing == "unit" and lj.tiles.group > 1
    lp = pmlt.prepare_refine(g, p, params)
    assert lp.csr.kind == "unit" and lp.csr.bf16_gather
    assert not pmlt.prepare_refine(g, p, MultilevelFAParams()).csr.bf16_gather
    x_v = rng.uniform(-1, 1, (g.n, d)).astype(np.float32)
    sj = np.asarray(lj.slot_of_vertex)
    xs = np.zeros((JES.D_PAD, lj.tiles.n_pad), np.float32)
    xs[:d, sj] = x_v.T
    want = np.asarray(JES.attraction_spmv(
        jnp.asarray(xs), lj.tiles, lj.deg_w_att, interpret=True, dmax=4,
        x_precision="bf16"))[:d, sj].T
    sp = lp.slot_of_vertex
    x = torch.zeros((lp.n_slots, d))
    x[sp] = torch.from_numpy(x_v)
    got = PES.attraction_spmv(x, lp.csr, lp.deg_w,
                              x_precision="bf16")[sp].numpy()
    xb = x.to(torch.bfloat16).float()
    scale = (PES.spmv_plain(xb.abs(), lp.csr)
             + x.abs() * lp.deg_w[:, None])[sp].numpy()
    _within_scale(got, want, scale)

    coords_A = rng.uniform(-1, 1, (12, d)).astype(np.float32)
    r_A = rng.uniform(0.5, 1.0, 12).astype(np.float32)
    local0 = rng.uniform(-1, 1, (g.n, d)).astype(np.float32)
    want = np.asarray(jmlt.refine_level_tiled(
        gj, pj, jnp.asarray(coords_A), jnp.asarray(r_A), d,
        key=jax.random.PRNGKey(0), iterations=5, interpret=True,
        params=params, coords0=jnp.asarray(local0)))
    got = pmlt.refine_level_tiled(g, p, torch.from_numpy(coords_A),
                                  torch.from_numpy(r_A), d, iterations=5,
                                  params=params,
                                  coords0=torch.from_numpy(local0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _slab_graphs(rng):
    """(s, r, n, sender_block, window, tile): a scattered unit graph at the
    v9 shape, community blocks at the bf16 shape, and a graph whose edges
    leave most sender blocks empty up to the lcm padding."""
    n = 2500
    s = rng.integers(0, n, 9000)
    r = rng.integers(0, n, 9000)
    keep = s != r
    yield s[keep], r[keep], n, 2048, 2048, 128
    s, r, _ = _community(rng, False).to_coo_numpy()
    yield s, r, 2560, 256, 256, 128
    s = rng.integers(0, 300, 2000)
    r = rng.integers(0, 300, 2000)
    yield s, r, 5000, 1024, 4096, 256


def test_slab_count_matches_reference(rng):
    for s, r, n, B, W, T in _slab_graphs(rng):
        s, r = np.asarray(s, np.int64), np.asarray(r, np.int64)
        want = JES.build_window_tiles(
            _CooShim(s, r, np.ones(s.size, np.float32), n), tile=T,
            sender_block=B, window=W, packing="unit").num_tiles
        assert PES.slab_count(s, r, n, B, W, T) == want


def test_spmv_windowed_routes_and_refusals(rng):
    """Every accepted name computes the same y = A x on its CSR's kind
    (the bf16 names on the quantized x); unknown names and precisions and
    v11 beyond dmax 4 raise the reference's messages."""
    n = 300
    s = rng.integers(0, n, 2000)
    r = rng.integers(0, n, 2000)
    w = rng.uniform(0.5, 2.0, s.size)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32))
    unit, _ = PES.build_csr(s, r, None, n)
    trunc, _ = PES.build_csr(s, r, PES.truncate_bf16(w), n)
    exact, _ = PES.build_csr(s, r, w, n, exact=True)
    y = PES.spmv_plain(x, unit)
    yb = PES.spmv_plain(x.to(torch.bfloat16).float(), unit)
    for v in PES.UNIT_VARIANTS:
        got = PES.spmv_windowed(x, unit, variant=v)
        want = (torch.zeros_like(y) if v == "vnull"
                else yb if v.startswith("v12b") else y)
        assert torch.equal(got, want), v
    for v in ("auto",) + PES.WEIGHTED_VARIANTS:
        assert torch.equal(PES.spmv_windowed(x, trunc, variant=v),
                           PES.spmv_plain(x, trunc))
    assert torch.equal(PES.spmv_windowed_v5(x, trunc),
                       PES.spmv_plain(x, trunc))
    assert torch.equal(PES.spmv_windowed(x, exact, variant="anything"),
                       PES.spmv_plain(x, exact))
    # 'auto' quantizes only a bf16_gather CSR, and only under bf16
    paired, _ = PES.build_csr(s, r, None, n, bf16_gather=True)
    assert torch.equal(PES.spmv_windowed(x, paired, x_precision="bf16"), yb)
    assert torch.equal(PES.spmv_windowed(x, unit, x_precision="bf16"), y)
    assert torch.equal(PES.spmv_windowed(x, paired), y)
    with pytest.raises(ValueError, match="x_precision"):
        PES.spmv_windowed(x, unit, x_precision="fp16")
    with pytest.raises(ValueError, match="unknown spmv_windowed variant"):
        PES.spmv_windowed(x, unit, variant="v9p16")
    with pytest.raises(ValueError, match="for bf16 packing"):
        PES.spmv_windowed(x, trunc, variant="v12")
    with pytest.raises(ValueError, match="v11"):
        PES.spmv_windowed(x, unit, variant="v11", dmax=8)
    with pytest.raises(ValueError, match="v5"):
        PES.spmv_windowed_v5(x, unit)
    for fn in (lambda: PES.spmv_bf16x(PES.pack_x_bf16(x), trunc, 3),
               lambda: PES.spmv_null(x, trunc)):
        with pytest.raises(ValueError, match="unit-weight"):
            fn()
