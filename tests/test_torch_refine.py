"""The port's slot-space refinement against the JAX package: kernel B's
plain version against every Pallas bucket body (interpret mode) and the
XLA gram batch, the sampled bucket on an injected draw, refine_forces and
a refined level (kernel B itself is held to its plain version on the card
by tests/test_torch_cuda.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import graph_embed_tpu as gt
from graph_embed_tpu.forceatlas import multilevel as jml
from graph_embed_tpu.forceatlas import multilevel_tiled as jmlt
from graph_embed_tpu.utils.params import MultilevelFAParams

from graph_embed_tpu_torch import interop
from graph_embed_tpu_torch.forceatlas import multilevel as pml
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as pmlt

D_PAD = jmlt.ES.D_PAD
REPEL, EPS = 1.3, 1e-5


def _bucket(rng, m_b, S, dim):
    """[D_PAD, m_b, S] JAX slot block with random member counts, deg_loc
    on members and -1 on ghosts; and the port's ([m_b, S, dim], w)."""
    x3 = np.zeros((D_PAD, m_b, S), np.float32)
    for b in range(m_b):
        c = int(rng.integers(1, S + 1))
        x3[:dim, b, :c] = rng.uniform(-1, 1, size=(dim, c))
        x3[D_PAD - 1, b, :c] = rng.integers(0, 5, size=c)
        x3[D_PAD - 1, b, c:] = -1.0
    dval = x3[D_PAD - 1]
    w = np.where(dval >= 0, dval + 1.0, 0.0).astype(np.float32)
    return x3, np.moveaxis(x3[:dim], 0, -1).copy(), w


def _roll(x3, S, dim):
    m_b = x3.shape[1]
    C = max(8, 128 // S) * 2
    kernel = partial(jmlt._bucket_repulsion_roll_kernel, S=S, dim=dim,
                     repel=REPEL, eps=EPS)
    spec = pl.BlockSpec((D_PAD, C * S), lambda i: (0, i))
    return pl.pallas_call(
        kernel, grid=(m_b // C,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((D_PAD, m_b * S), jnp.float32),
        interpret=True)(jnp.asarray(x3.reshape(D_PAD, m_b * S)))


def _chunk(x3, S, dim, mxu):
    m_b = x3.shape[1]
    width, bw = m_b * S, 512
    x2 = jnp.asarray(x3.reshape(D_PAD, width))
    xcols = x2.reshape(D_PAD, width // 128, 128).transpose(1, 2, 0)
    kernel = partial(jmlt._bucket_repulsion_chunk_kernel, S=S, dim=dim,
                     repel=REPEL, eps=EPS, use_mxu=mxu)
    return pl.pallas_call(
        kernel, grid=(width // bw,),
        in_specs=[pl.BlockSpec((D_PAD, bw), lambda i: (0, i)),
                  pl.BlockSpec((bw // 128, 128, D_PAD), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((D_PAD, bw), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((D_PAD, width), jnp.float32),
        interpret=True)(x2, xcols)


def _gram_kernel(x3, S, dim):
    m_b = x3.shape[1]
    C = 8
    kernel = partial(jmlt._bucket_repulsion_kernel, C=C, S=S, dim=dim,
                     repel=REPEL, eps=EPS)
    spec = pl.BlockSpec((D_PAD, C, S), lambda i: (0, i, 0))
    return pl.pallas_call(
        kernel, grid=(m_b // C,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((D_PAD, m_b, S), jnp.float32),
        interpret=True)(jnp.asarray(x3))


@pytest.mark.parametrize("S", [8, 16, 32, 64, 128, 256])
def test_plain_bucket_repulsion_matches_pallas_bodies(rng, S):
    """Tolerance 5e-3 (test_refine_tiled.py:143-146): the gram-form
    oracle's d^2 = |x|^2 + |y|^2 - 2 x.y cancels for near pairs; the
    port's diff-form d^2 is exact."""
    dim = 3 if S != 8 else 2
    m_b = max(8, 1024 // S)   # whole grid steps for every body's tiling
    x3, x, w = _bucket(rng, m_b, S, dim)
    got = pmlt.bucket_repulsion_plain(torch.from_numpy(x),
                                      torch.from_numpy(w), REPEL,
                                      EPS).numpy()

    def check(out):
        want = np.moveaxis(np.asarray(out).reshape(D_PAD, m_b, S)[:dim],
                           0, -1)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)

    check(jmlt._gram_batch_xla(jnp.asarray(x3), REPEL, EPS))
    check(_gram_kernel(x3, S, dim))
    if S <= 64:
        check(_roll(x3, S, dim))
        check(_chunk(x3, S, dim, mxu=S >= 64))


@pytest.mark.parametrize("S", [8, 64, 256])
def test_absolute_sums_bound_each_force(rng, S):
    """``absolute=True`` gives each slot the scale against which kernel B
    is held to its plain version on the card (1e-5 of it per element).
    It bounds every force (up to its own float32 rounding, 1e-6), and on
    the members of aggregates with partners 1e-5 of it stays below the
    force in all but 0.1% of elements, so a slot whose force the kernel
    loses or gets wrong fails that check."""
    m_b = max(8, 1024 // S)
    _, x, w = _bucket(rng, m_b, S, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    f = pmlt.bucket_repulsion_plain(xt, wt, REPEL, EPS).abs()
    scale = pmlt.bucket_repulsion_plain(xt, wt, REPEL, EPS, absolute=True)
    assert bool((f <= scale * (1 + 1e-6)).all())
    partnered = (w > 0) & ((w > 0).sum(axis=1, keepdims=True) >= 2)
    sel = torch.from_numpy(partnered)
    assert float((f[sel] > 1e-5 * scale[sel]).float().mean()) >= 0.999


def test_sampled_bucket_matches_jax_on_same_draw(rng):
    """Feed both estimators the uniforms jax.random.uniform draws inside
    _bucket_repulsion_sampled; tolerance as for the exact buckets (the
    JAX estimator uses the gram form, the port the diff form)."""
    m_b, S, dim, K = 5, 64, 3, 48
    x3, x, w = _bucket(rng, m_b, S, dim)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jmlt._bucket_repulsion_sampled(
        jnp.asarray(x3), key, K, REPEL, EPS, dim))
    want = np.moveaxis(want[:dim], 0, -1)
    u = np.asarray(jax.random.uniform(key, (m_b, K)), np.float32)
    counts = torch.from_numpy((x3[D_PAD - 1] >= 0).sum(1).astype(np.int64))
    got = pmlt.bucket_repulsion_sampled(
        torch.from_numpy(x), torch.from_numpy(w), counts,
        torch.from_numpy(u), REPEL, EPS).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)


def _level(rng, n=160, m=12, d=3, weighted=True):
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    # distinct undirected pairs, so unweighted levels take the unit path
    pairs = np.unique(np.stack([np.minimum(s, r), np.maximum(s, r)]), axis=1)
    s, r = pairs[:, pairs[0] != pairs[1]]
    w = rng.uniform(0.5, 2.0, s.size) if weighted else None
    gj = gt.from_edges(s, r, w, n=n, symmetrize=True, dtype=jnp.float32)
    v2a = rng.integers(0, m, n).astype(np.int32)
    v2a[:m] = np.arange(m)
    v2a[m: m + 40] = 0          # one larger aggregate: a second size class
    pj = gt.Partition.from_numpy(v2a, m)
    g = interop.graph(*gj.to_coo_numpy(), n)
    p = interop.partition(v2a, m)
    coords_A = rng.uniform(-1, 1, size=(m, d)).astype(np.float32)
    return gj, pj, g, p, coords_A


def test_local_degrees_and_external_pull_match_jax(rng):
    gj, pj, g, p, coords_A = _level(rng)
    np.testing.assert_allclose(
        pml.local_degrees(g, p, True).numpy(),
        np.asarray(jml.local_degrees(gj, pj, True)), rtol=1e-6)
    np.testing.assert_allclose(
        pml.external_pull(g, p, torch.from_numpy(coords_A), pull=100.0,
                          eps=1e-5).numpy(),
        np.asarray(jml.external_pull(gj, pj, jnp.asarray(coords_A),
                                     pull=100.0, eps=1e-5)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [0, 3, 6])
def test_segment_sum_is_a_row_owned_sum(rng, d):
    """ops.segment sums each segment's values in position order (kernel
    A's unit mode on the card): the same float64 sums as numpy's bincount
    up to float32 rounding, for flat values (d = 0) and rows of d."""
    from graph_embed_tpu_torch.ops import segment

    e, m = 500, 37
    seg = rng.integers(0, m, e)
    seg[:5] = 3  # one segment with repeats, and some left empty
    vals = rng.uniform(-1, 1, (e,) if d == 0 else (e, d)).astype(np.float32)
    csr = segment.segment_csr(seg, m)
    got = segment.segment_sum(torch.from_numpy(vals), csr).numpy()
    cols = vals[:, None] if d == 0 else vals
    want = np.stack([np.bincount(seg, weights=cols[:, k].astype(np.float64),
                                 minlength=m) for k in range(cols.shape[1])],
                    axis=1)
    np.testing.assert_allclose(got, want[:, 0] if d == 0 else want,
                               rtol=1e-5, atol=1e-5)
    # the sender CSR of a graph needs no host sort: entry e is column e
    gj, pj, g, p, _ = _level(rng)
    scsr = pml.sender_csr(g)
    assert scsr.nnz == g.num_edges and scsr.n_rows == g.n
    np.testing.assert_allclose(
        segment.segment_sum(g.weights, scsr).numpy(),
        g.degrees(True).numpy(), rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_refine_forces_match_jax(rng, weighted):
    """Compared in vertex space (the two slot layouts differ: the port
    packs buckets without the TPU's chunk alignment).  2e-3 as in
    test_refine_tiled.py:53: JAX's interpret path is the gram-form XLA
    batch with its cancellation."""
    gj, pj, g, p, coords_A = _level(rng, weighted=weighted)
    d = 3
    params = MultilevelFAParams()
    coords_v = rng.uniform(-1, 1, size=(g.n, d)).astype(np.float32)

    lj = jmlt.prepare_refine(gj, pj, params)
    sj = np.asarray(lj.slot_of_vertex)
    pull_v = np.asarray(jml.external_pull(gj, pj, jnp.asarray(coords_A),
                                          pull=params.pull,
                                          eps=params.epsilon))
    xs = np.zeros((lj.n_slots, d), np.float32)
    xs[sj] = coords_v
    ps = np.zeros((lj.n_slots, d), np.float32)
    ps[sj] = pull_v
    want = np.asarray(jmlt.refine_forces(jnp.asarray(xs), lj,
                                         jnp.asarray(ps), params, d,
                                         interpret=True))[sj]

    lp = pmlt.prepare_refine(g, p, params)
    assert len(lp.buckets) >= 2 and not any(b.sampled for b in lp.buckets)
    assert (lp.csr.w is None) == (not weighted)
    sp = lp.slot_of_vertex
    x = torch.zeros((lp.n_slots, d))
    x[sp] = torch.from_numpy(coords_v)
    pull = torch.zeros((lp.n_slots, d))
    pull[sp] = pml.external_pull(g, p, torch.from_numpy(coords_A),
                                 pull=params.pull, eps=params.epsilon)
    got = pmlt.refine_forces(x, lp, pull, params)[sp].numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # ghost slots carry no force
    assert not pmlt.refine_forces(x, lp, pull, params)[~lp.valid_slot].any()


def test_refine_level_matches_jax_from_warm_start(rng):
    """Five iterations plus the epilogue from the same local warm start
    (no random init on either side): the slot-space loop and the packing
    into parent balls agree within the refine_forces class."""
    gj, pj, g, p, coords_A = _level(rng, n=120, m=10)
    d = 3
    r_A = rng.uniform(0.5, 1.0, size=10).astype(np.float32)
    local0 = rng.uniform(-1, 1, size=(g.n, d)).astype(np.float32)
    want = np.asarray(jmlt.refine_level_tiled(
        gj, pj, jnp.asarray(coords_A), jnp.asarray(r_A), d,
        key=jax.random.PRNGKey(0), iterations=5, interpret=True,
        coords0=jnp.asarray(local0)))
    got = pmlt.refine_level_tiled(g, p, torch.from_numpy(coords_A),
                                  torch.from_numpy(r_A), d, iterations=5,
                                  coords0=torch.from_numpy(local0)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    v2a = p.vertex_to_agg_numpy()
    dist = np.linalg.norm(got - coords_A[v2a], axis=1)
    assert (dist <= r_A[v2a] + 1e-5).all()


def test_refine_level_sampled_bucket_packs(rng):
    """An aggregate whose class reaches sampled_slots_threshold takes the
    sampled estimator: finite output, members inside the parent ball."""
    n, m = 700, 8
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = interop.graph(*gt.from_edges(s[keep], r[keep], None, n=n,
                                     symmetrize=True,
                                     dtype=jnp.float32).to_coo_numpy(), n)
    v2a = np.zeros(n, np.int32)
    v2a[:m] = np.arange(m)
    v2a[m:100] = rng.integers(1, m, size=100 - m)
    p = interop.partition(v2a, m)
    params = MultilevelFAParams(sampled_slots_threshold=1024)
    layout = pmlt.prepare_refine(g, p, params)
    assert any(b.sampled and b.S >= 1024 for b in layout.buckets)
    coords_A = rng.uniform(-1, 1, size=(m, 2)).astype(np.float32)
    r_A = rng.uniform(0.5, 1.0, size=m).astype(np.float32)
    out = pmlt.refine_level_tiled(g, p, torch.from_numpy(coords_A),
                                  torch.from_numpy(r_A), 2, iterations=4,
                                  params=params, layout=layout).numpy()
    assert np.isfinite(out).all()
    d = np.linalg.norm(out - coords_A[v2a], axis=1)
    assert np.all(d <= r_A[v2a] + 1e-4)

