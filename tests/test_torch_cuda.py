"""Kernels A to E against their plain PyTorch versions on a CUDA card,
and the bitwise repeatability of whole runs there.

Every test here needs the card and skips elsewhere.  The file imports
neither JAX nor the JAX package, so the GPU host runs it without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch import from_edges
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
    card = gp.force_atlas(g.to(dev), 3, coords=x0, params=params,
                          iterations=10).cpu()
    assert cuda.LAUNCHES["edge_linlog"] == before + 10
    cpu = gp.force_atlas(g, 3, coords=x0, params=params, iterations=10)
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
        assert torch.equal(gp.force_atlas_tiled(graph, 3, **kw),
                           gp.force_atlas_tiled(graph, 3, **kw))
