"""The flat ForceAtlas loop (``forceatlas/flat.force_atlas``): on the CPU
the eager loop of ``fa_step``, with no graph counters; on a CUDA card
(marker ``cuda``) the replayed CUDA graph held bit for bit to a plain
Python loop of ``fa_step`` from the same start and generator, with its
counters and kernel launches.  The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_base_graph.py
"""

import collections

import pytest
import torch

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.forceatlas import farfield as FF
from graph_embed_tpu_torch.forceatlas import flat
from graph_embed_tpu_torch.ops import cuda
from graph_embed_tpu_torch.partition.hierarchy import partition_num_parts
from graph_embed_tpu_torch.utils import timing
from graph_embed_tpu_torch.utils.params import ForceAtlasParams

SEED = 2147483659
REPULSIONS = {
    "gram": ForceAtlasParams(),
    "exact": ForceAtlasParams(repulsion="exact"),
    "centroids": ForceAtlasParams(repulsion="centroids"),
    "linlog": ForceAtlasParams(linlog=True),
    "sampled": ForceAtlasParams(repulsion="sampled",
                                num_negative_samples=7),
}
GRAPH_COUNTS = ("base_graph_iterations", "base_graph_replays")


def coarsest_mesh16():
    """The coarsest level of mesh3d(16) at the embed's coarsening factor
    0.1 (16 vertices)."""
    g = gp.synth.mesh3d(16)
    return gp.partition_hierarchy(g, 0.1, emit_graphs=True).coarse_graphs[-1]


GRAPHS = {"mesh16_coarsest": coarsest_mesh16,
          # 1,331 vertices: the gram repulsion's two row blocks
          "mesh11": lambda: gp.synth.mesh3d(11)}


def step_loop(g, dim, params, iterations, seed, device):
    """``force_atlas``'s set-up, then a plain Python loop of ``fa_step``."""
    g = g.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    coords = torch.rand((g.n, dim), generator=gen, dtype=g.dtype,
                        device=device) * 2.0 - 1.0
    deg = g.degrees(params.use_weights)
    attraction = flat.FlatAttraction.build(g, params)
    groups = None
    if params.repulsion == "centroids":
        groups = FF.Groups.build(
            partition_num_parts(g, max(32, g.n // 64)), device)
    forces = torch.zeros_like(coords)
    for _ in range(iterations):
        coords, forces = gp.fa_step(coords, forces, g, deg, params,
                                    attraction=attraction, generator=gen,
                                    groups=groups)
    return coords


def traced(g, dim, params, iterations, seed, device):
    """``force_atlas`` inside a phase of a logger: (coords, the base.loop
    sub-span, the phase's launches)."""
    metrics = gp.MetricsLogger()
    with timing.use(metrics), metrics.span("base", device):
        coords = gp.force_atlas(g, dim, seed=seed, params=params,
                                iterations=iterations, device=device)
    (rec,) = metrics.records
    (loop,) = rec["sub"]
    assert (loop["name"], loop["iterations"]) == ("base.loop", iterations)
    return coords, loop, rec.get("launches", {})


@pytest.mark.parametrize("repulsion", sorted(REPULSIONS))
def test_cpu_loop_stays_eager(repulsion):
    """On the CPU the loop is the eager loop of ``fa_step`` at any
    iteration count, and counts no graph iterations or replays."""
    params = REPULSIONS[repulsion]
    g = coarsest_mesh16()
    iterations = flat.GRAPH_MIN_ITERATIONS + 3
    coords, loop, _ = traced(g, 3, params, iterations, SEED, "cpu")
    assert not set(loop.get("counts", {})) & set(GRAPH_COUNTS)
    assert torch.equal(coords, step_loop(g, 3, params, iterations, SEED,
                                         "cpu"))


# -- on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("repulsion", sorted(REPULSIONS))
@pytest.mark.parametrize("count", ["below", "above"])
def test_card_replay_is_the_step_loop(dev, graph, repulsion, count):
    """The replayed loop equals the eager loop bit for bit, below the
    capture minimum and above it at a count that is no multiple of the
    chunk; its counters add up, and its launches count the kernels the
    card ran."""
    assert torch.get_float32_matmul_precision() == "highest"
    params = REPULSIONS[repulsion]
    g = GRAPHS[graph]()
    iterations = (flat.GRAPH_MIN_ITERATIONS - 1 if count == "below"
                  else 9 * flat.GRAPH_MIN_ITERATIONS + 1)
    if count == "above":
        assert (iterations - flat.GRAPH_WARMUP) % flat.GRAPH_CHUNK
    coords, loop, launches = traced(g, 3, params, iterations, SEED, dev)
    before = collections.Counter(cuda.LAUNCHES)
    want = step_loop(g, 3, params, iterations, SEED, dev)
    assert torch.equal(coords, want)
    assert launches == dict(cuda.LAUNCHES - before)
    assert launches[("edge_linlog" if params.linlog
                     else "edge_spmm[weighted]")] == iterations
    counts = loop.get("counts", {})
    if count == "below":
        assert not set(counts) & set(GRAPH_COUNTS)
    else:
        replays, tail = divmod(iterations - flat.GRAPH_WARMUP,
                               flat.GRAPH_CHUNK)
        assert counts["base_graph_replays"] == replays >= 2
        assert counts["base_graph_iterations"] == replays * flat.GRAPH_CHUNK
        assert counts["base_graph_iterations"] + flat.GRAPH_WARMUP + tail \
            == iterations


@pytest.mark.cuda
def test_card_base_loop_ends_after_its_kernels(dev):
    """Replays return long before the card finishes them; ``base.loop``
    waits, so under a CUDA-only profiler every kernel-A interval of the
    loop ends inside the sub-span's stamps (50 us for the two clocks)."""
    g = gp.synth.mesh3d(11)
    iterations = 4 * flat.GRAPH_MIN_ITERATIONS
    gp.force_atlas(g, 3, seed=SEED, iterations=iterations, device=dev)
    metrics = gp.MetricsLogger()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with timing.use(metrics), metrics.span("base", dev):
            gp.force_atlas(g, 3, seed=SEED, iterations=iterations,
                           device=dev)
    (loop,) = metrics.records[0]["sub"]
    assert loop["counts"]["base_graph_replays"] >= 4
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and "spmv_kernel" in e.name()]
    assert len(spans) == iterations
    assert all(loop["t0_ns"] <= t0 and t1 <= loop["t1_ns"] + 50_000
               for t0, t1 in spans)
