"""Kernels A and B against their plain PyTorch versions on a CUDA card.

Every test here needs the card and skips elsewhere.  The file imports
neither JAX nor the JAX package, so the GPU host runs it without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from graph_embed_tpu_torch import from_edges
from graph_embed_tpu_torch.forceatlas import multilevel_tiled as MT
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.ops import edge_spmm as ES
from graph_embed_tpu_torch.partition.interpolation import Partition
from graph_embed_tpu_torch.utils.params import MultilevelFAParams

REPEL, EPS = 1.3, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(2024)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_kernel_a_matches_plain(rng, dev, weighted, d):
    """Kernel A sums each row in CSR order with FMAs, the plain version
    with index_add_; float32 rounding only, so 1e-5."""
    n, e = 5000, 40000
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.uniform(0.5, 2.0, e) if weighted else None
    csr, _ = ES.build_csr(s, r, w, n, device=dev)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32)).to(
        dev)
    before = cuda.LAUNCHES.copy()
    got = ES.spmv(x, csr)
    assert sum((cuda.LAUNCHES - before).values()) == 1
    want = ES.spmv_plain(x, csr)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
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
