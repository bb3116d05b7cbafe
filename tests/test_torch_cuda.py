"""Kernels A to F against their plain PyTorch versions on a CUDA card,
and the bitwise repeatability of whole runs there.

Every test here needs the card and skips elsewhere.  The file imports
neither JAX nor the JAX package, so the GPU host runs it without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import from_edges
from graph_embed_tpu_torch.forceatlas import multilevel as PML
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.forceatlas import tiled as TL
from graph_embed_tpu_torch.graph import synth
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.ops import edge_spmm as ES
from graph_embed_tpu_torch.ops import fused_step as FS
from graph_embed_tpu_torch.ops import repulsion as RP
from graph_embed_tpu_torch.ops import segment
from graph_embed_tpu_torch.partition.interpolation import Partition
from graph_embed_tpu_torch.utils.params import (ForceAtlasParams,
                                                MultilevelFAParams)

REPEL, EPS = 1.3, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


def _hub_coo(rng, n, e):
    """A random COO whose rows 0, 7 and 4000 are hubs of 33, 1000 and 5000
    entries: rows of more than 32 entries are shared by a warp."""
    s = np.concatenate([rng.integers(8, n, e), np.zeros(33, np.int64),
                        np.full(1000, 7), np.full(5000, 4000)])
    return s, rng.integers(0, n, s.size)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kernel_a_matches_plain(rng, dev, weighted, d):
    """Kernel A sums each row in a fixed order with FMAs, the plain version
    with index_add_; float32 rounding only, so each element within 1e-5 of
    its own sum of |terms|."""
    n, e = 5000, 40000
    s, r = _hub_coo(rng, n, e)
    e = s.size
    w = rng.uniform(0.5, 2.0, e) if weighted else None
    csr, _ = ES.build_csr(s, r, w, n, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32)).to(
        dev)
    before = cuda.LAUNCHES.copy()
    got = ES.spmv(x, csr)
    assert sum((cuda.LAUNCHES - before).values()) == 1
    want = ES.spmv_plain(x, csr)
    scale = ES.spmv_plain(x.abs(), csr)  # weights are positive
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    # deterministic: no atomics, so a second launch is bitwise equal
    assert torch.equal(ES.spmv(x, csr), got)


@pytest.mark.cuda
def test_kernel_a_rejects_what_it_does_not_take(dev):
    csr, _ = ES.build_csr(np.array([0, 1]), np.array([1, 0]), None, 2,
                          device=dev)
    for bad in (torch.zeros((2, 5), device=dev),
                torch.zeros((2, 3), device=dev, dtype=torch.float64),
                torch.zeros((3, 2), device=dev).T):
        with pytest.raises(ValueError):
            ES.spmv(bad, csr)


def _layout(rng, dev, n=4000):
    """A level whose aggregates span every size class 8..1024."""
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True, device=dev)
    sizes = np.repeat(2 ** np.arange(3, 11), 1 + np.arange(8)[::-1] // 2)
    v2a = np.repeat(np.arange(sizes.size), sizes)[:n]
    v2a = np.concatenate([v2a, sizes.size + np.arange(n - v2a.size) % 50])
    part = Partition.from_numpy(v2a, int(v2a.max()) + 1, device=dev)
    return MT.prepare_refine(g, part, MultilevelFAParams())


def _assert_within_scale(got, want, scale, rtol=1e-5):
    """Element by element, |got - want| <= rtol * scale, where ``scale``
    is the element's sum of |terms|: summing in another order moves an
    element by a small multiple of 2^-24 of its scale."""
    err = (got - want).abs()
    bad = err > rtol * scale
    assert not bad.any(), (
        f"{int(bad.sum())} elements off, worst {float(err.max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_kernel_b_matches_plain(rng, dev, d):
    """One launch over every exact size class; the kernel accumulates
    partners in order with FMAs, the plain version with torch.sum, so each
    slot differs by float32 rounding of its own sum."""
    layout = _layout(rng, dev)
    assert {b.S for b in layout.buckets} >= {8, 16, 256, 512, 1024}
    x = torch.rand((layout.n_slots, d), device=dev) * 2 - 1
    x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
    before = cuda.LAUNCHES["bucket_repulsion"]
    got = MT.exact_repulsion_cuda(x, layout, REPEL, EPS)
    assert cuda.LAUNCHES["bucket_repulsion"] == before + 1
    want = MT.exact_repulsion_plain(x, layout, REPEL, EPS)
    scale = MT.exact_repulsion_plain(x, layout, REPEL, EPS, absolute=True)
    torch.cuda.synchronize()
    for b in layout.buckets:
        _assert_within_scale(got[b.slots], want[b.slots], scale[b.slots])
    assert not got[~layout.valid_slot].any()
    assert torch.equal(MT.exact_repulsion_cuda(x, layout, REPEL, EPS), got)


@pytest.mark.cuda
def test_refine_forces_on_card_match_cpu(rng, dev):
    """One refinement force evaluation on the same slot coordinates:
    kernels on the card, plain versions on the CPU; each element within
    1e-5 of the sum of |terms| of its repulsion, attraction and gravity."""
    layout_cpu = _layout(np.random.default_rng(1), torch.device("cpu"))
    layout_dev = _layout(np.random.default_rng(1), dev)
    assert layout_cpu.n_slots == layout_dev.n_slots
    # the folded attraction weights are positive, so A |x| sums |terms|
    assert layout_cpu.csr.w is None or bool((layout_cpu.csr.w > 0).all())
    n, d = layout_cpu.n, 3
    x0 = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    params = MultilevelFAParams()
    outs = []
    for layout in (layout_cpu, layout_dev):
        x = torch.zeros((layout.n_slots, d), device=layout.deg_w.device)
        x[layout.slot_of_vertex] = torch.from_numpy(x0).to(x.device)
        pull = torch.zeros_like(x)
        f = MT.refine_forces(x, layout, pull, params)
        outs.append(f.cpu())
    x = torch.zeros((layout_cpu.n_slots, d))
    x[layout_cpu.slot_of_vertex] = torch.from_numpy(x0)
    mag = torch.clamp(torch.linalg.norm(x, dim=1), min=params.epsilon)
    scale = (MT.exact_repulsion_plain(x, layout_cpu, params.repel,
                                      params.epsilon, absolute=True)
             + params.attract * (ES.spmv_plain(x.abs(), layout_cpu.csr)
                                 + x.abs() * layout_cpu.deg_w[:, None])
             + params.gravity * ((layout_cpu.deg_loc + 1.0)
                                 / mag)[:, None] * x.abs())
    _assert_within_scale(outs[1], outs[0], scale)


def _portable_level(rng, n=3000):
    """A weighted level on the CPU whose aggregates span the size classes
    8..512, for the portable refinement."""
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], rng.uniform(0.5, 2.0, keep.sum()),
                   n=n, symmetrize=True)
    sizes = np.repeat(2 ** np.arange(3, 10), 2)
    v2a = np.repeat(np.arange(sizes.size), sizes)[:n]
    v2a = np.concatenate([v2a, sizes.size + np.arange(n - v2a.size) % 40])
    return g, Partition.from_numpy(v2a, int(v2a.max()) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("repulsion,linlog,kernel", [
    ("exact", False, "edge_spmm[exact]"), ("gram", False, "edge_spmm[exact]"),
    ("exact", True, "edge_linlog")])
def test_portable_ml_forces_on_card_match_cpu(rng, dev, repulsion, linlog,
                                              kernel):
    """One portable force evaluation (member tables; kernel A's exact mode,
    or kernel E under linlog) on the same coordinates and pull: the card
    against the plain versions on the CPU, each element within 1e-5 of
    its rounding scale (``ml_forces(absolute=True)``: the sum of |terms|,
    and for the gram form the identity's cancellation)."""
    g, part = _portable_level(rng)
    params = MultilevelFAParams(repulsion=repulsion, linlog=linlog)
    x = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    cA = torch.from_numpy(rng.uniform(-1, 1, (part.num_aggs, 3)).astype(
        np.float32))
    lay_cpu = PML.prepare_multilevel(g, part, params)
    pull = PML.external_pull(g, part, cA, pull=params.pull,
                             eps=params.epsilon)
    want = PML.ml_forces(x, lay_cpu, pull, params)
    scale = PML.ml_forces(x, lay_cpu, pull, params, absolute=True)
    lay = PML.prepare_multilevel(g.to(dev), part.to(dev), params)
    before = cuda.LAUNCHES[kernel]
    got = PML.ml_forces(x.to(dev), lay, pull.to(dev), params)
    assert cuda.LAUNCHES[kernel] == before + 1
    _assert_within_scale(got.cpu(), want, scale)
    assert torch.equal(PML.ml_forces(x.to(dev), lay, pull.to(dev), params),
                       got)


@pytest.mark.cuda
def test_portable_refinement_on_card_packs_and_repeats(rng, dev):
    """force_atlas_multilevel on the card: every vertex inside its parent
    ball, and two runs from one seed torch.equal."""
    g, part = _portable_level(rng)
    cA = torch.from_numpy(rng.uniform(-5, 5, (part.num_aggs, 3)).astype(
        np.float32)).to(dev)
    rA = torch.full((part.num_aggs,), 0.25, device=dev)
    g, part = g.to(dev), part.to(dev)
    runs = [gp.force_atlas_multilevel(g, part, cA, rA, 3, seed=2,
                                      iterations=10, device=dev)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    dist = torch.linalg.norm(runs[0] - cA[part.vertex_to_agg], dim=1)
    assert bool((dist <= 0.25 + 1e-5).all())


@pytest.mark.cuda
def test_sampled_bucket_refines_on_card(rng, dev):
    """A snowballed aggregate (class >= sampled_slots_threshold) takes the
    sampled estimator beside kernel B: finite output, every member inside
    its parent ball."""
    n, m = 3000, 8
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True, device=dev)
    v2a = np.zeros(n, np.int64)
    v2a[:m] = np.arange(m)
    v2a[m:200] = rng.integers(1, m, size=200 - m)
    part = Partition.from_numpy(v2a, m, device=dev)
    params = MultilevelFAParams()
    layout = MT.prepare_refine(g, part, params)
    assert any(b.sampled for b in layout.buckets)
    assert any(not b.sampled for b in layout.buckets)
    coords_A = torch.rand((m, 3), device=dev) * 2 - 1
    r_A = torch.full((m,), 0.05, device=dev)
    before = cuda.LAUNCHES["bucket_repulsion"]
    out = MT.refine_level_tiled(g, part, coords_A, r_A, 3, iterations=10,
                                params=params, layout=layout)
    assert cuda.LAUNCHES["bucket_repulsion"] == before + 10
    assert bool(torch.isfinite(out).all())
    dist = torch.linalg.norm(out - coords_A[part.vertex_to_agg], dim=1)
    assert bool((dist <= 0.05 * (1 + 1e-4)).all())


def _tiled_case(dev, L, extra, weighted):
    """A mesh whose DIA plan leaves residual edges (``extra`` > 0), with
    unit or non-unit symmetric weights, planned on ``dev``."""
    g = synth.mesh3d(L, extra_frac=extra, seed=3)
    if weighted:
        s, r, _ = g.to_coo_numpy()
        w = 0.5 + ((np.minimum(s, r) * 7 + np.maximum(s, r) * 3) % 11) / 7.0
        g = from_edges(s, r, w, n=g.n)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    return g, params, TL.prepare_tiled(g.to(dev), 3, params,
                                       dia_min_count=32)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 64, 300])
def test_kernel_c_matches_plain(rng, dev, s):
    """Sample counts below, at and above one shared-memory tile (256); ids
    repeat and include the vertex itself.  Each element within 1e-5 of
    its own sum of |terms|."""
    n = 5000
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(
        dev)
    deg_p1 = torch.from_numpy(rng.uniform(1, 9, n).astype(np.float32)).to(
        dev)
    idx = torch.from_numpy(rng.integers(0, n, s).astype(np.int32)).to(dev)
    before = cuda.LAUNCHES["sampled_repulsion"]
    got = RP.repulsion_sampled(x, deg_p1, idx, repel=REPEL, eps=EPS)
    assert cuda.LAUNCHES["sampled_repulsion"] == before + 1
    want = RP.repulsion_sampled_plain(x, deg_p1, idx, repel=REPEL, eps=EPS)
    scale = RP.repulsion_sampled_plain(x, deg_p1, idx, repel=REPEL, eps=EPS,
                                       absolute=True)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert torch.equal(RP.repulsion_sampled(x, deg_p1, idx, repel=REPEL,
                                            eps=EPS), got)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 256, 300, 513])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [3, 4097])
def test_kernel_c_tails_and_self_pairs(rng, dev, n, d, s):
    """Kernel C's 4 vertices per thread: n = 3 (one partial group) and
    4097 (one vertex past four 1024-vertex tiles), d = 1-4, s below, at
    and above one 256-sample staging pass; the samples hold vertices at
    each of a thread's four positions (8, 13, 18, 23; all three at n = 3)
    and the last vertex.  Each element within 1e-5 of its own sum of
    |terms|, bitwise repeatable."""
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32)).to(
        dev)
    deg_p1 = torch.from_numpy(rng.uniform(1, 9, n).astype(np.float32)).to(
        dev)
    ids = rng.integers(0, n, s)
    own = np.arange(n) if n < 4 else np.array([8, 13, 18, 23, n - 1])
    ids[: own.size] = own
    idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
    before = cuda.LAUNCHES["sampled_repulsion"]
    got = RP.repulsion_sampled(x, deg_p1, idx, repel=REPEL, eps=EPS)
    assert cuda.LAUNCHES["sampled_repulsion"] == before + 1
    want = RP.repulsion_sampled_plain(x, deg_p1, idx, repel=REPEL, eps=EPS)
    scale = RP.repulsion_sampled_plain(x, deg_p1, idx, repel=REPEL, eps=EPS,
                                       absolute=True)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert torch.equal(RP.repulsion_sampled(x, deg_p1, idx, repel=REPEL,
                                            eps=EPS), got)


@pytest.mark.cuda
@pytest.mark.parametrize("extra,weighted", [(0.0, False), (0.3, False),
                                            (0.3, True)])
def test_kernel_d_matches_plain(rng, dev, extra, weighted):
    """Pure DIA, DIA + unit residual, DIA + weighted residual: f within
    1e-5 of its own sum of |terms|, x' against the plain update applied
    to the kernel's own f."""
    g, params, tfa = _tiled_case(dev, 14, extra, weighted)
    assert (tfa.csr is None) == (extra == 0.0) and tfa.dia_offsets
    x = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32)).to(
        dev)
    fprev = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(
        np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, g.n, 64).astype(np.int32)).to(dev)
    y_res = None if tfa.csr is None else ES.spmv(x, tfa.csr)
    args = (tfa.dia_w, tfa.dia_offsets, tfa.dia_off, y_res, tfa.deg_w_att,
            tfa.deg_p1, idx, params)
    before = cuda.LAUNCHES["fused_step"]
    got_x, got_f = FS.fa_step_fused(x, fprev, *args)
    assert cuda.LAUNCHES["fused_step"] == before + 1
    plain = (tfa.dia_w, tfa.dia_offsets, y_res, tfa.deg_w_att, tfa.deg_p1,
             idx, params)
    want_f = FS.step_forces_plain(x, *plain)
    scale = FS.step_forces_plain(x, *plain, absolute=True)
    want_x = FS.speed_update(x, got_f, fprev, params)
    torch.cuda.synchronize()
    _assert_within_scale(got_f, want_f, scale)
    _assert_within_scale(got_x, want_x, x.abs() + (want_x - x).abs())
    again = FS.fa_step_fused(x, fprev, *args)
    assert torch.equal(again[0], got_x) and torch.equal(again[1], got_f)


@pytest.mark.cuda
def test_kernel_e_matches_plain(rng, dev):
    n, e = 5000, 40000
    s, r = _hub_coo(rng, n, e)
    e = s.size
    csr, _ = ES.build_csr(s, r, rng.uniform(0.5, 2.0, e), n, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(
        dev)
    x[:10] = x[10:20]  # coincident pairs: d clamps at eps
    before = cuda.LAUNCHES["edge_linlog"]
    got = ES.linlog(x, csr, attract=1.3, eps=EPS)
    assert cuda.LAUNCHES["edge_linlog"] == before + 1
    want = ES.linlog_plain(x, csr, attract=1.3, eps=EPS)
    scale = ES.linlog_plain(x, csr, attract=1.3, eps=EPS, absolute=True)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert torch.equal(ES.linlog(x, csr, attract=1.3, eps=EPS), got)


@pytest.mark.cuda
def test_flat_linlog_base_case_runs_kernel_e(rng, dev):
    """The flat base case under linlog: kernel E once per iteration, and
    the card's layout matches the CPU's from one start (exact repulsion,
    no random draw) to 1e-4 of its extent."""
    g = synth.ring_of_cliques(6, 5)
    params = ForceAtlasParams(repulsion="exact", linlog=True)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (g.n, 3)).astype(np.float32))
    before = cuda.LAUNCHES["edge_linlog"]
    card = gp.force_atlas(g, 3, coords=x0, params=params, iterations=10,
                          device=dev).cpu()
    assert cuda.LAUNCHES["edge_linlog"] == before + 10
    cpu = gp.force_atlas(g, 3, coords=x0, params=params, iterations=10,
                         device="cpu")
    assert float((card - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())


@pytest.mark.cuda
def test_new_wrappers_refuse_what_they_do_not_take(dev):
    g, params, tfa = _tiled_case(dev, 6, 0.3, False)
    n = g.n
    idx = torch.zeros(4, dtype=torch.int32, device=dev)
    good = torch.zeros((n, 3), device=dev)
    csr, _ = ES.build_csr(*g.to_coo_numpy(), n, device=dev)  # f32 weights
    bad_x = (torch.zeros((3, n), device=dev).T,          # not contiguous
             torch.zeros((n, 5), device=dev),            # too wide
             torch.zeros((n, 3), device=dev, dtype=torch.float64),
             torch.zeros((n, 3)))                        # on the CPU
    for x in bad_x:
        with pytest.raises(ValueError):
            RP.repulsion_sampled_cuda(x, tfa.deg_p1, idx, repel=1.0,
                                      eps=EPS)
        with pytest.raises(ValueError):
            FS.fa_step_fused_cuda(x, x, tfa.dia_w, tfa.dia_off, None,
                                  tfa.deg_w_att, tfa.deg_p1, idx, params)
        with pytest.raises(ValueError):
            ES.linlog_cuda(x, csr, attract=1.0, eps=EPS)
    for ids in (idx.long(), idx[:0], torch.zeros((2, 2), dtype=torch.int32,
                                                 device=dev)):
        with pytest.raises(ValueError):
            RP.repulsion_sampled_cuda(good, tfa.deg_p1, ids, repel=1.0,
                                      eps=EPS)
    with pytest.raises(ValueError):
        FS.fa_step_fused_cuda(good, good, tfa.dia_w[:, :-1].contiguous(),
                              tfa.dia_off, None, tfa.deg_w_att, tfa.deg_p1,
                              idx, params)


@pytest.mark.cuda
def test_segment_sum_launches_kernel_a(rng, dev):
    seg = rng.integers(0, 50, 3000)
    vals = torch.from_numpy(rng.uniform(-1, 1, (3000, 3)).astype(
        np.float32)).to(dev)
    csr = segment.segment_csr(seg, 50, device=dev)
    before = cuda.LAUNCHES["edge_spmm[unit]"]
    got = segment.segment_sum(vals, csr)
    assert cuda.LAUNCHES["edge_spmm[unit]"] == before + 1
    want = segment.segment_sum(vals.cpu(), segment.segment_csr(seg, 50))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_runs_on_card_are_bitwise_repeatable(dev):
    """Two embeds and two flat tiled runs from one seed: every per-vertex
    sum on the card is row-owned, so the results are torch.equal."""
    g = synth.mesh3d(10)
    kw = dict(device=dev, base_iterations=200, refine_iterations=10,
              seed=3)
    a, _ = gp.embed_graph(g, 3, **kw)
    b, _ = gp.embed_graph(g, 3, **kw)
    assert torch.equal(a, b)
    coords0 = torch.rand((g.n, 3), generator=torch.Generator().manual_seed(
        1)) * 2 - 1
    kw = dict(coords=coords0, seed=4, iterations=20,
              params=ForceAtlasParams(repulsion="sampled",
                                      num_negative_samples=64))
    for graph in (g, synth.mesh3d(10, extra_frac=0.3, seed=1)):
        graph = graph.to(dev)
        assert torch.equal(gp.force_atlas_tiled(graph, 3, device=dev, **kw),
                           gp.force_atlas_tiled(graph, 3, device=dev, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kernel_a_bf16x_matches_plain(rng, dev, d):
    """Kernel A's bf16x mode on packed bf16 pairs, hub rows included: each
    element within 1e-5 of its own sum of |terms| from the plain version
    (the same exact bf16 products, summed in another order)."""
    n, e = 5000, 40000
    s, r = _hub_coo(rng, n, e)
    csr, _ = ES.build_csr(s, r, None, n, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32)).to(
        dev)
    xp = ES.pack_x_bf16(x)
    before = cuda.LAUNCHES["edge_spmm[bf16x]"]
    got = ES.spmv_bf16x(xp, csr, d)
    assert cuda.LAUNCHES["edge_spmm[bf16x]"] == before + 1
    want = ES.spmv_bf16x_plain(xp, csr, d)
    scale = ES.spmv_plain(ES.unpack_x_bf16(xp, d).abs(), csr)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert torch.equal(ES.spmv_bf16x(xp, csr, d), got)


@pytest.mark.cuda
def test_kernel_a_exact_and_null_modes(rng, dev):
    """The 'wide' route is the weighted mode on untruncated float32 weights,
    counted apart; the stream-only mode launches and writes zeros."""
    n, e = 5000, 40000
    s, r = _hub_coo(rng, n, e)
    w = rng.uniform(0.5, 2.0, s.size)
    exact, _ = ES.build_csr(s, r, w, n, device=dev, exact=True)
    unit, _ = ES.build_csr(s, r, None, n, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(
        dev)
    before = cuda.LAUNCHES.copy()
    got = ES.spmv(x, exact)
    null = ES.spmv_null(x, unit)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["edge_spmm[exact]"] == before["edge_spmm[exact]"] + 1
    assert cuda.LAUNCHES["edge_spmm[vnull]"] == before["edge_spmm[vnull]"] + 1
    _assert_within_scale(got, ES.spmv_plain(x, exact),
                         ES.spmv_plain(x.abs(), exact))
    assert not null.any()


@pytest.mark.cuda
def test_every_variant_name_matches_plain(rng, dev):
    """spmv_windowed under each of the reference's variant names (and
    spmv_windowed_v5) against the plain version of the mode it routes to."""
    n = 5000
    s, r = _hub_coo(rng, n, 20000)
    w = rng.uniform(0.5, 2.0, s.size)
    unit, _ = ES.build_csr(s, r, None, n, device=dev)
    trunc, _ = ES.build_csr(s, r, ES.truncate_bf16(w), n, device=dev)
    exact, _ = ES.build_csr(s, r, w, n, device=dev, exact=True)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)).to(
        dev)
    xb = ES.unpack_x_bf16(ES.pack_x_bf16(x), 3)
    cases = [(v, unit) for v in ES.UNIT_VARIANTS]
    cases += [(v, trunc) for v in ES.WEIGHTED_VARIANTS] + [("auto", exact)]
    for v, csr in cases:
        got = ES.spmv_windowed(x, csr, variant=v)
        if v == "vnull":
            assert not got.any()
            continue
        xin = xb if v.startswith("v12b") else x
        wabs = csr if csr.w is None else dataclasses.replace(
            csr, w=csr.w.abs())
        torch.cuda.synchronize()
        _assert_within_scale(got, ES.spmv_plain(xin, csr),
                             ES.spmv_plain(xin.abs(), wabs))
    _assert_within_scale(ES.spmv_windowed_v5(x, trunc),
                         ES.spmv_plain(x, trunc),
                         ES.spmv_plain(x.abs(), trunc))


@pytest.mark.cuda
def test_bf16x_wrapper_refuses_what_it_does_not_take(rng, dev):
    n = 100
    s, r = rng.integers(0, n, 500), rng.integers(0, n, 500)
    unit, _ = ES.build_csr(s, r, None, n, device=dev)
    weighted, _ = ES.build_csr(s, r, rng.uniform(0.5, 2, 500), n,
                               device=dev)
    xp = ES.pack_x_bf16(torch.zeros((n, 3), device=dev))
    for bad in (xp.cpu(),                              # on the CPU
                torch.zeros((2, n), dtype=torch.int32, device=dev).T,
                xp[:-1],                               # wrong rows
                xp.float()):                           # wrong type
        with pytest.raises(ValueError):
            ES.spmv_bf16x_cuda(bad, unit, 3)
    with pytest.raises(ValueError):
        ES.spmv_bf16x_cuda(xp, unit, 5)                # d > 4
    with pytest.raises(ValueError):
        ES.spmv_bf16x(xp, weighted, 3)                 # weights
    with pytest.raises(ValueError):
        ES.spmv_null_cuda(torch.zeros((n, 3)), unit)   # on the CPU


@pytest.mark.cuda
def test_bf16_flat_runs_are_bitwise_repeatable(dev):
    """Two x_precision='bf16' flat runs from one seed on a unit residual
    the reference would pair: kernel A's bf16x mode every step, equal
    results."""
    g = synth.rmat(12, 8, seed=2)
    s, r, _ = g.to_coo_numpy()
    g = gp.from_canonical_coo(s, r, np.ones(s.size), g.n).to(dev)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64,
                              x_precision="bf16")
    tfa = TL.prepare_tiled(g, 3, params, spmv_mode="packed")
    assert tfa.csr.bf16_gather
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=dev).manual_seed(5)
        x0 = torch.rand((g.n, 3), generator=gen, device=dev) * 2 - 1
        before = cuda.LAUNCHES["edge_spmm[bf16x]"]
        runs.append(TL.tiled_loop(x0, tfa, params, 10, generator=gen))
        assert cuda.LAUNCHES["edge_spmm[bf16x]"] == before + 10
    assert torch.equal(runs[0], runs[1])


def _ring_case(rng, dev, ndev, n, weighted=True, avg_deg=6, d=3):
    """A random graph's halo plan (B_max rounded to 128) and its ring
    groups on ``dev``, with random stacked [ndev * blk, d] coordinates."""
    from graph_embed_tpu_torch.parallel import halo as PH
    from graph_embed_tpu_torch.parallel import overlap as OV

    m = n * avg_deg // 2
    s, r = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = s != r
    w = rng.uniform(0.5, 2.0, keep.sum()) if weighted else None
    g = from_edges(s[keep], r[keep], w, n=n, symmetrize=True)
    plan = PH.build_halo_plan(g, ndev, boundary_multiple=128)
    ring = OV.ring_groups(OV.build_overlap_groups(plan), plan, dev)
    x = torch.zeros((ndev * plan.blk, d), device=dev)
    x[:n] = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(
        np.float32)).to(dev)
    deg_p1 = torch.from_numpy(plan.deg.reshape(-1).astype(
        np.float32)).to(dev) + 1.0
    return g, plan, ring, x, deg_p1


@pytest.mark.cuda
@pytest.mark.parametrize("ndev,n", [(1, 300), (4, 500), (8, 3000)])
@pytest.mark.parametrize("linlog,nohubs,delta", [(False, False, 1.0),
                                                 (True, True, 0.5)])
def test_kernel_f_matches_plain(rng, dev, ndev, n, linlog, nohubs, delta):
    """The whole ring on the card (kernel F per slot, forwards on a side
    stream) against its plain version (the copies in order) on the same
    tensors: every per-edge element within 1e-5 of its |diff| * |coef|,
    Ec_max padding and the empty slot 0 exact zeros, one launch per slot;
    the summed cross forces match too."""
    from graph_embed_tpu_torch.parallel import overlap as OV

    _, plan, ring, x, deg_p1 = _ring_case(rng, dev, ndev, n)
    params = ForceAtlasParams(repulsion="sampled", linlog=linlog,
                              nohubs=nohubs, delta=delta)
    before = cuda.LAUNCHES["ring_attraction"]
    got = OV.ring_cross_forces(x, deg_p1, ring, params)
    assert cuda.LAUNCHES["ring_attraction"] == before + ndev
    want = OV.ring_cross_forces_plain(x, deg_p1, ring, params)
    torch.cuda.synchronize()
    # each element is one term, diff * coef: its own size is its scale
    _assert_within_scale(got, want, want.abs())
    dead = (ring.mask == 0)[..., None].expand_as(got)
    assert not got[dead].any()
    assert not got[0].any()                          # slot 0 is empty
    summed = segment.segment_sum(got.view(-1, 3), ring.csr)
    torch.testing.assert_close(
        summed, segment.segment_sum(want.view(-1, 3), ring.csr),
        rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_f_refuses_what_it_does_not_take(rng, dev):
    """The public per-slot wrapper, and a ring (checked once before its
    unchecked launches), refuse operands of the wrong type, shape or
    device: live counts and outputs included."""
    from graph_embed_tpu_torch.parallel import overlap as OV

    _, plan, ring, x, deg_p1 = _ring_case(rng, dev, 4, 400)
    params = ForceAtlasParams(repulsion="sampled")
    block = x[ring.bidx].view(4, plan.B_max, 3)
    args = [block, x, deg_p1, ring.cs[1], ring.cr[1], ring.cw[1],
            ring.live[1]]
    OV.slot_forces_cuda(*args, blk=plan.blk, params=params)
    for i, bad in ((1, x.cpu()), (1, x.double()), (1, x[:, :2].T),
                   (3, ring.cs[1].long()), (4, ring.cr[1][:, :-1]),
                   (5, ring.cw[1].double()), (2, deg_p1[:-1]),
                   (0, block[:, :, :2]), (6, ring.live[1].long()),
                   (6, ring.live[1][:-1]), (6, ring.live[1].cpu())):
        with pytest.raises(ValueError):
            OV.slot_forces_cuda(*args[:i], bad, *args[i + 1:], blk=plan.blk,
                                params=params)
    for out in (torch.empty((4, ring.ec, 2), device=dev),
                torch.empty((4, ring.ec, 3), device=dev).double(),
                torch.empty((4, 3, ring.ec), device=dev).transpose(1, 2)):
        with pytest.raises(ValueError):
            OV.slot_forces_cuda(*args, blk=plan.blk, params=params, out=out)

    buf = torch.stack([torch.roll(block, k, 0) for k in range(4)])
    OV.ring_slot_forces(buf, x, deg_p1, ring, params)
    for bad in (dataclasses.replace(ring, live=ring.live.long()),
                dataclasses.replace(ring, live=ring.live[:, :-1]),
                dataclasses.replace(ring, live=ring.live.t()),
                dataclasses.replace(ring, cw=ring.cw.double())):
        before = cuda.LAUNCHES["ring_attraction"]
        for call in (lambda: OV.ring_cross_forces(x, deg_p1, bad, params),
                     lambda: OV.ring_slot_forces(buf, x, deg_p1, bad,
                                                 params)):
            with pytest.raises(ValueError):
                call()
        assert cuda.LAUNCHES["ring_attraction"] == before
    for out in (torch.empty((4, 4, ring.ec, 2), device=dev),
                torch.empty((3, 4, ring.ec, 3), device=dev),
                torch.empty((4, 4, ring.ec, 3), device=dev).double()):
        with pytest.raises(ValueError):
            OV.ring_slot_forces(buf, x, deg_p1, ring, params, out=out)
    with pytest.raises(ValueError):
        OV.ring_slot_forces(buf[:, :, :-1].contiguous(), x, deg_p1, ring,
                            params)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kernel_f_reads_only_the_live_prefixes(rng, dev, d):
    """Kernel F with the ring's live counts, on groups whose counts end
    inside a block of threads: within 1e-5 of the plain version,
    torch.equal over the ring, over a filled slot buffer and through the
    public per-slot wrapper, and unmoved when the padding past the counts
    is overwritten with live-looking entries and the live entries' masks
    with 0.5 (neither is read: a live prefix has mask 1 by the plan)."""
    from graph_embed_tpu_torch.parallel import overlap as OV

    _, plan, ring, x, deg_p1 = _ring_case(rng, dev, 4, 500, d=d)
    live = ring.live.cpu().numpy()
    assert (live[1:] % 256 != 0).all() and not live[0].any()
    params = ForceAtlasParams(repulsion="sampled")
    got = OV.ring_cross_forces(x, deg_p1, ring, params)
    want = OV.ring_cross_forces_plain(x, deg_p1, ring, params)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, want.abs())
    buf = torch.stack([torch.roll(x[ring.bidx].view(4, plan.B_max, d), k, 0)
                       for k in range(4)])
    every = torch.stack([OV.slot_forces_cuda(
        buf[k], x, deg_p1, ring.cs[k], ring.cr[k], ring.cw[k], ring.live[k],
        blk=plan.blk, params=params) for k in range(4)])
    assert torch.equal(OV.ring_slot_forces(buf, x, deg_p1, ring, params),
                       got)
    assert torch.equal(every, got)
    pad = ring.mask == 0
    poisoned = dataclasses.replace(
        ring, cs=ring.cs.masked_fill(pad, 0), cr=ring.cr.masked_fill(pad, 1),
        cw=ring.cw.masked_fill(pad, 2.0),
        mask=torch.where(pad, 1.0, 0.5).to(torch.float32))
    assert torch.equal(OV.ring_slot_forces(buf, x, deg_p1, poisoned, params),
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("tiled", [False, True])
def test_halo_overlap_matches_collective_on_card(rng, dev, tiled):
    """The halo step on the card with the ring (kernel F) against the
    boundary gather, from one start with the same samples, three steps:
    within 2e-5 of the extent on the segment path (test_halo.py:206),
    2e-3 tiled on weights (the tiles truncate to bf16, the ring does not:
    test_halo.py:243)."""
    from graph_embed_tpu_torch.parallel import halo as PH
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    g, plan, _, _, _ = _ring_case(rng, dev, 8, 4000)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    c0 = torch.rand((g.n, 3), generator=torch.Generator().manual_seed(2))
    ids = [torch.randint(0, plan.blk // 2, (8, 8), device=dev)
           for _ in range(3)]
    kw = dict(mesh=make_mesh(8, device=dev), params=params, iterations=3,
              coords0=c0, plan=plan, sample_ids=ids, tiled=tiled,
              device=dev)
    before = cuda.LAUNCHES["ring_attraction"]
    a = PH.halo_force_atlas(g, 3, **kw)
    b = PH.halo_force_atlas(g, 3, overlap=True, **kw)
    assert cuda.LAUNCHES["ring_attraction"] == before + 3 * 8
    err = float((a - b).abs().max())
    assert err <= (2e-3 if tiled else 2e-5) * float(a.abs().max()), err


@pytest.mark.cuda
def test_shard_counts_give_equal_layouts_on_card(rng, dev):
    """Invariant halo sampling and the sharded embed: 1 and 8 shards give
    torch.equal layouts on the card (tiled halo: kernel A; the sharded
    refinement: kernels A and B)."""
    from graph_embed_tpu_torch.parallel import halo as PH
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    g, _, _, _, _ = _ring_case(rng, dev, 1, 3000)
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    outs = [PH.halo_force_atlas(g, 3, mesh=make_mesh(k, device=dev),
                                params=params, iterations=10, seed=1,
                                sample_mode="invariant", tiled=True,
                                device=dev) for k in (1, 8)]
    assert torch.equal(outs[0], outs[1])
    m3 = synth.mesh3d(12)
    outs = [gp.embed_graph(m3, 3, device=dev, base_iterations=200,
                           refine_iterations=10, seed=3, mesh_min_n=1,
                           sharding="halo", mesh=make_mesh(k, device=dev))[0]
            for k in (1, 8)]
    assert torch.equal(outs[0], outs[1])


# kernel A's walk: rows longer than a chunk are hubs, gathered a chunk at
# a time by a block each
CHUNK = cuda.SPMV_HUB_ROW
A_MODES = ("unit", "weighted", "exact", "bf16x", "null")
# row lengths: empty rows, rows that straddle a chunk's length of the CSR
# (the 69th row of 30 entries crosses entry 2048, the row of 120 crosses
# 4096), warp-summed rows, hubs back to back that straddle a chunk, a hub
# longer than several chunks
STRADDLE = ([30] * 69 + [32] * 60 + [120] + [0] * 3 + [CHUNK + 1] * 2
            + [40] * 10 + [0] + [3 * CHUNK + 17] + [7] * 5)
A_SHAPES = {
    "one empty row": [0],
    "one short row": [17],
    "one row of several chunks": [3 * CHUNK + 17],
    "a block plus one": [(0, 5, 31, 32, 33, 100, CHUNK, CHUNK + 1)[i % 8]
                         for i in range(257)],
    "rows across chunks": STRADDLE,
}


def _lengths_csr(rng, lengths, n_cols, mode, dev, cols=None):
    """A CSR with the given row lengths and random columns (or ``cols``)
    in the kind ``mode`` runs on; returns (csr, cols, weights)."""
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    if cols is None:
        cols = rng.integers(0, n_cols, rows.size)
    w = None
    if mode in ("weighted", "exact"):
        w = ES.truncate_bf16(0.5 + (cols % 13) / 8.0)
    csr, _ = ES.build_csr(rows, cols, w, lengths.size, n_cols, device=dev,
                          exact=mode == "exact")
    return csr, cols, w


def _run_mode(mode, x, csr):
    """(kernel A's output in ``mode``, the plain version's, each element's
    sum of |terms|)."""
    d = x.shape[1]
    if mode == "bf16x":
        xp = ES.pack_x_bf16(x)
        xf = ES.unpack_x_bf16(xp, d)
        return (ES.spmv_bf16x(xp, csr, d), ES.spmv_plain(xf, csr),
                ES.spmv_plain(xf.abs(), csr))
    if mode == "null":
        return (ES.spmv_null(x, csr), ES.spmv_null_plain(x, csr),
                torch.zeros((csr.n_rows, d), device=x.device))
    wabs = csr if csr.w is None else dataclasses.replace(csr, w=csr.w.abs())
    return ES.spmv(x, csr), ES.spmv_plain(x, csr), ES.spmv_plain(x.abs(),
                                                                 wabs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(A_SHAPES))
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", A_MODES)
def test_kernel_a_walk_matches_plain(rng, dev, mode, d, shape):
    """Every mode of kernel A on empty rows, rows that straddle a chunk,
    a row of several chunks, one row and a block of rows plus one, against
    its plain version: each element within 1e-5 of its own sum of |terms|
    (zeros in the stream-only mode), one launch, bitwise repeatable."""
    n_cols = 3000
    csr, _, _ = _lengths_csr(rng, A_SHAPES[shape], n_cols,
                             "unit" if mode in ("bf16x", "null") else mode,
                             dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n_cols, d)).astype(
        np.float32)).to(dev)
    name = f"edge_spmm[{'vnull' if mode == 'null' else mode}]"
    before = cuda.LAUNCHES[name]
    got, want, scale = _run_mode(mode, x, csr)
    assert cuda.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    if mode == "null":
        assert not got.any()
    else:
        _assert_within_scale(got, want, scale)
    assert torch.equal(_run_mode(mode, x, csr)[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("unit", "weighted", "bf16x"))
def test_kernel_a_sums_do_not_depend_on_where_a_row_starts(rng, dev, mode):
    """The same rows at different offsets of two CSRs (77 rows, a hub among
    them, prepended to the second) give torch.equal sums: a row's sum
    depends on its own entries alone, not on its tile or chunk."""
    n_cols, d = 3000, 3
    base = "unit" if mode == "bf16x" else mode
    csr, cols, _ = _lengths_csr(rng, STRADDLE, n_cols, base, dev)
    head = [int(v) for v in rng.integers(0, 60, 77)]
    head[40] = CHUNK + 333
    pre = rng.integers(0, n_cols, sum(head))
    shifted, _, _ = _lengths_csr(rng, head + STRADDLE, n_cols, base, dev,
                                 cols=np.concatenate([pre, cols]))
    assert int(shifted.hub_rows.shape[0]) == int(csr.hub_rows.shape[0]) + 1
    x = torch.from_numpy(rng.uniform(-1, 1, (n_cols, d)).astype(
        np.float32)).to(dev)
    a = _run_mode(mode, x, csr)[0]
    b = _run_mode(mode, x, shifted)[0]
    assert torch.equal(b[len(head):], a)


@pytest.mark.cuda
def test_kernel_a_plan_from_device_row_pointers(rng, dev):
    """``segment.sorted_csr`` builds the hub list on the device from
    device row pointers: the same list as the host build, and the same
    segment sums."""
    lengths = np.asarray(STRADDLE, np.int64)
    seg = np.repeat(np.arange(lengths.size), lengths)
    host = segment.segment_csr(seg, lengths.size, device=dev)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]))
    sorted_ = segment.sorted_csr(indptr.to(dev), seg.size)
    assert sorted_.hub_rows.device == host.hub_rows.device
    assert torch.equal(sorted_.hub_rows, host.hub_rows)
    vals = torch.from_numpy(rng.uniform(-1, 1, (seg.size, 2)).astype(
        np.float32)).to(dev)
    assert torch.equal(segment.segment_sum(vals, sorted_),
                       segment.segment_sum(vals, host))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [7, 64, 300])
@pytest.mark.parametrize("k", [0, 32])
def test_kernel_d_tiles_offsets_and_samples(rng, dev, s, k):
    """Kernel D on n = 2 * 1024 + 37 vertices (not a multiple of its
    1024-vertex tile), K = 0 or 32 DIA offsets, s = 7, 64 or 300 samples
    (one staging pass or two), ids that hit the vertex itself: f within
    1e-5 of its own sum of |terms|, x' against the plain update on the
    kernel's own f, bitwise repeatable."""
    n, d = 2 * 1024 + 37, 3
    params = ForceAtlasParams(repulsion="sampled", num_negative_samples=s)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(
            np.float32)).to(dev)

    x, fprev, y_res = rand(n, d), rand(n, d), rand(n, d)
    deg_w, deg_p1 = rand(n, lo=0.5, hi=4.0), rand(n, lo=1.0, hi=9.0)
    offsets = tuple(int(o) for o in rng.choice(
        np.concatenate([np.arange(-n + 1, 0), np.arange(1, n)]), k,
        replace=False))
    dia_w = rand(k, n, lo=0.5, hi=2.0) if k else None
    dia_off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    ids = rng.integers(0, n, s)
    ids[: min(s, 4)] = [0, n - 1, 1024, 5][: min(s, 4)]
    idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
    rest = (deg_w, deg_p1, idx, params)
    before = cuda.LAUNCHES["fused_step"]
    got_x, got_f = FS.fa_step_fused_cuda(x, fprev, dia_w, dia_off, y_res,
                                         *rest)
    assert cuda.LAUNCHES["fused_step"] == before + 1
    plain = (dia_w, offsets, y_res, *rest)
    want_f = FS.step_forces_plain(x, *plain)
    scale = FS.step_forces_plain(x, *plain, absolute=True)
    want_x = FS.speed_update(x, got_f, fprev, params)
    torch.cuda.synchronize()
    _assert_within_scale(got_f, want_f, scale)
    _assert_within_scale(got_x, want_x, x.abs() + (want_x - x).abs())
    again = FS.fa_step_fused_cuda(x, fprev, dia_w, dia_off, y_res, *rest)
    assert torch.equal(again[0], got_x) and torch.equal(again[1], got_f)


# kernel E on kernel A's walk: thread, warp and hub rows
E_SHAPES = {
    "at the hub threshold": [CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 17],
    "hubs back to back": [5, CHUNK + 1, 3 * CHUNK + 17, CHUNK + 5, 2],
    "rows across chunks": STRADDLE,
}


def _linlog_csr(rng, lengths, n_cols, dev, cols=None):
    """A CSR with the given row lengths, random columns (or ``cols``) and
    float32 weights (not truncated) for kernel E; rows are the first of
    the n_cols columns."""
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    if cols is None:
        cols = rng.integers(0, n_cols, rows.size)
    w = 0.25 + np.sin(cols * 0.37) ** 2
    csr, _ = ES.build_csr(rows, cols, w, lengths.size, n_cols, device=dev)
    return csr, cols


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(E_SHAPES))
@pytest.mark.parametrize("d", [1, 3, 4])
def test_kernel_e_walk_matches_plain(rng, dev, d, shape):
    """Kernel E on rows of 2047, 2048 and 2049 entries, a row of several
    chunks, hubs back to back and rows that straddle a chunk, against its
    plain version: each element within 1e-5 of its own sum of |terms|,
    one launch, bitwise repeatable."""
    n_cols = 3000
    csr, _ = _linlog_csr(rng, E_SHAPES[shape], n_cols, dev)
    assert csr.hub_rows.numel() > 0
    x = torch.from_numpy(rng.uniform(-1, 1, (n_cols, d)).astype(
        np.float32)).to(dev)
    x[:5] = x[100:105]  # coincident pairs: d clamps at eps
    kw = dict(attract=1.3, eps=EPS)
    before = cuda.LAUNCHES["edge_linlog"]
    got = ES.linlog(x, csr, **kw)
    assert cuda.LAUNCHES["edge_linlog"] == before + 1
    want = ES.linlog_plain(x, csr, **kw)
    scale = ES.linlog_plain(x, csr, absolute=True, **kw)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert torch.equal(ES.linlog(x, csr, **kw), got)


@pytest.mark.cuda
def test_kernel_e_sums_do_not_depend_on_where_a_row_starts(rng, dev):
    """The same rows at different offsets of two CSRs (77 rows, a hub among
    them, prepended to the second) give torch.equal sums; each row's own
    coordinates move with it (the rows are the first columns of x)."""
    n_cols, d = 3000, 3
    csr, cols = _linlog_csr(rng, STRADDLE, n_cols, dev)
    head = [int(v) for v in rng.integers(0, 60, 77)]
    head[40] = CHUNK + 333
    pre = rng.integers(0, n_cols, sum(head))
    shifted, _ = _linlog_csr(rng, head + STRADDLE, n_cols + len(head), dev,
                             cols=np.concatenate([pre, cols + len(head)]))
    assert int(shifted.hub_rows.shape[0]) == int(csr.hub_rows.shape[0]) + 1
    x = torch.from_numpy(rng.uniform(-1, 1, (n_cols, d)).astype(
        np.float32)).to(dev)
    xs = torch.cat([torch.from_numpy(rng.uniform(-1, 1, (len(head), d))
                                     .astype(np.float32)).to(dev), x])
    kw = dict(attract=0.7, eps=EPS)
    # the weights follow the columns, which moved by len(head): use the
    # first CSR's weights in the second's tail
    w = shifted.w.clone()
    w[int(shifted.indptr[len(head)]):] = csr.w
    shifted = dataclasses.replace(shifted, w=w)
    a = ES.linlog(x, csr, **kw)
    b = ES.linlog(xs, shifted, **kw)
    assert torch.equal(b[len(head):], a)


# kernel B's warp tasks: member counts that leave partial aggregates in
# every class 8..1024
B_COUNTS = [1, 5, 8, 8, 9, 12, 16, 17, 30, 32, 33, 64, 65, 100, 128, 129,
            256, 300, 512, 513, 1000, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [1, 3])
@pytest.mark.parametrize("d", [1, 3, 4])
def test_kernel_b_partial_aggregates_match_plain(rng, dev, d, ndev):
    """Kernel B on partial aggregates of every class 8..1024 (one shard, or
    three with ghost aggregates): members within 1e-5 of their own sum of
    |terms|, ghost rows exactly zero, one launch, bitwise repeatable."""
    from graph_embed_tpu_torch.parallel import sharded_ml as SML

    counts = np.asarray(B_COUNTS)
    v2a = rng.permutation(np.repeat(np.arange(counts.size), counts))
    n = v2a.size
    s = rng.integers(0, n, 3 * n)
    r = rng.integers(0, n, 3 * n)
    keep = s != r
    g = from_edges(s[keep], r[keep], None, n=n, symmetrize=True, device=dev)
    part = Partition.from_numpy(v2a, counts.size, device=dev)
    params = MultilevelFAParams(sampled_slots_threshold=0)
    layout = (MT.prepare_refine(g, part, params) if ndev == 1 else
              SML.prepare_refine_sharded(g, part, params, ndev).layout)
    x = torch.rand((layout.n_slots, d), device=dev) * 2 - 1
    x = torch.where(layout.valid_slot[:, None], x, torch.zeros_like(x))
    x[9] = x[8]   # two members of one aggregate coincide: d clamps at eps
    before = cuda.LAUNCHES["bucket_repulsion"]
    got = MT.exact_repulsion_cuda(x, layout, REPEL, EPS)
    assert cuda.LAUNCHES["bucket_repulsion"] == before + 1
    want = MT.exact_repulsion_plain(x, layout, REPEL, EPS)
    scale = MT.exact_repulsion_plain(x, layout, REPEL, EPS, absolute=True)
    torch.cuda.synchronize()
    _assert_within_scale(got, want, scale)
    assert not got[~layout.valid_slot].any()
    assert torch.equal(MT.exact_repulsion_cuda(x, layout, REPEL, EPS), got)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_device_coarsener_and_modularity_card_equal_cpu(rng, dev, weighted):
    """The device coarsener on a 2,000-vertex graph without a host COO,
    on the card and on the CPU: the same hierarchy (every float it decides
    on is summed in one fixed order, kernel A's in-order rows on the card);
    the native one too; kernel A launched; modularity within 1e-6."""
    n = 2000
    s = rng.integers(0, n, 4 * n)
    r = rng.integers(0, n, 4 * n)
    keep = s != r
    w = rng.uniform(0.5, 2.0, keep.sum()) if weighted else None
    g = from_edges(s[keep], r[keep], w, n=n, symmetrize=True)
    cpu = gp.partition_hierarchy(dataclasses.replace(g, host_coo=None), 0.1)
    nat = gp.partition_hierarchy(g, 0.1, backend="native")
    cuda.LAUNCHES.clear()
    card = gp.partition_hierarchy(
        dataclasses.replace(g.to(dev), host_coo=None), 0.1)
    assert cuda.LAUNCHES["edge_spmm[unit]"] > 0
    assert card.level_sizes == cpu.level_sizes == nat.level_sizes
    for a, b, c in zip(card.levels, cpu.levels, nat.levels):
        assert a.vertex_to_agg.is_cuda
        assert torch.equal(a.vertex_to_agg.cpu(), b.vertex_to_agg)
        assert torch.equal(b.vertex_to_agg, c.vertex_to_agg)
    q_card = float(gp.modularity(g.to(dev), card.levels[0]))
    q_cpu = float(gp.modularity(g, cpu.levels[0]))
    assert abs(q_card - q_cpu) < 1e-6
