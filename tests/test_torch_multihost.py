"""One block of shards per process (``parallel/multihost.py``) over
``torch.distributed`` with gloo on the CPU: 2 processes x 4 shards
against the stacked 1 x 8 mesh (``make_mesh(8)``), bit for bit, for the
replicated step (portable, tiled, linlog), the halo step (the ring under
overlap, the boundary gather with invariant samples) and both
``embed(mesh=...)`` pipelines, with every rank returning the same
coordinates.

The stacked port is held to JAX by tests/test_torch_sharded.py and
tests/test_torch_halo.py, so this closes the chain to the JAX package's
two-process tests (tests/test_aux.py:290-410, which hold 2 processes to 1
at rtol=1e-5 and skip where their workers fail; gloo is here, so these
do not skip).  The workers run ``WORKER`` with ``python -c`` and meet
through a ``file://`` rendezvous under the test's own directory.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: world, rank, init URL, output .npz; the results of every case
WORKER = r"""
import sys

import numpy as np
import torch

world, rank, url, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         sys.argv[4])
torch.set_num_threads(1)

import graph_embed_tpu_torch as gp
from graph_embed_tpu_torch.parallel import halo as PH
from graph_embed_tpu_torch.parallel import multihost as MH
from graph_embed_tpu_torch.parallel import sharded as PSH
from graph_embed_tpu_torch.parallel.mesh import (edge_sharding, make_mesh,
                                                 replicated)

MH.init_distributed(url, world, rank, backend="gloo")
mesh = MH.global_mesh(shards_per_process=8 // world, device="cpu")
assert mesh == make_mesh(8, device="cpu")
assert (mesh.process_count, mesh.process_index) == (world, rank)
res = {}

# the replicated step on the graph of tests/_dist_worker.py: two steps
rng = np.random.default_rng(7)
n, m = 96, 400
s, r = rng.integers(0, n, m), rng.integers(0, n, m)
keep = s != r
g = gp.from_edges(s[keep], r[keep], None, n=n, symmetrize=True)
params = gp.ForceAtlasParams(repulsion="gram")
sp, rp, wp, n_pad = PSH.pad_graph_for_mesh(g, 8, edge_multiple=8)
sp, rp, wp = PSH.align_shards(sp, rp, wp, n_pad, 8, edge_multiple=8)
lo, hi = MH.process_local_edge_slice(sp.size)
own = MH.shard_edges_global((sp,), mesh)[0]
assert torch.equal(own, torch.from_numpy(sp[lo:hi]))
step = PSH.make_sharded_fa_step(mesh, n_pad, sp.size, 3, params, n)
edges = step.shard_edges(sp, rp, wp)
coords = replicated(mesh).put(torch.from_numpy(np.random.default_rng(
    0).uniform(-1, 1, (n_pad, 3)).astype(np.float32)))
fprev = edge_sharding(mesh).put(torch.zeros((n_pad, 3)))
deg = torch.zeros(n_pad)
deg[:n] = g.degrees()
for _ in range(2):
    coords, fprev = step(coords, fprev, edges, deg)
res["replicated_step"] = coords[:n]

# the tiled replicated step: sampled repulsion, then linlog (kernel E)
for name, p in (("replicated_tiled", gp.ForceAtlasParams(
        repulsion="sampled", num_negative_samples=16)),
                ("replicated_linlog", gp.ForceAtlasParams(linlog=True))):
    res[name] = PSH.sharded_force_atlas(g, 3, mesh=mesh, params=p,
                                        iterations=4, seed=3, tiled=True,
                                        device="cpu")

# the ring of cliques of tests/_dist_embed_worker.py
rng = np.random.default_rng(11)
k, c = 24, 10
ss, rr = [], []
for a in range(k):
    for i in range(c):
        for j in range(i + 1, c):
            if rng.random() < 0.6:
                ss.append(a * c + i)
                rr.append(a * c + j)
    ss.append(a * c + c - 1)
    rr.append(((a + 1) % k) * c)
ring = gp.from_edges(np.array(ss), np.array(rr), None, n=k * c,
                     symmetrize=True)
hier = gp.partition_hierarchy(ring, 0.3)
graphs = gp.build_galerkin_chain(ring, hier.levels)
for sharding, min_n in (("replicated", 64), ("halo", 16)):
    res[f"embed_{sharding}"] = gp.embed(
        graphs, hier.levels, 2, device="cpu", seed=5, base_iterations=20,
        refine_iterations=5, mesh=mesh, mesh_min_n=min_n, sharding=sharding)

# the halo step: the ring (overlap) on its tiled CSR, the boundary
# gather on the per-edge path with invariant samples
sampled = gp.ForceAtlasParams(repulsion="sampled", num_negative_samples=32)
order = gp.partition_order(ring)
ordered, _ = gp.apply_order(ring, order)
for name, kw in (("halo_overlap", dict(overlap=True, tiled=True)),
                 ("halo_collective", dict(tiled=False,
                                          sample_mode="invariant"))):
    res[name] = PH.halo_force_atlas(ordered, 3, mesh=mesh, params=sampled,
                                    iterations=5, seed=9, device="cpu", **kw)

np.savez(out, **{key: v.numpy() for key, v in res.items()})
"""

CASES = ("replicated_step", "replicated_tiled", "replicated_linlog",
         "embed_replicated", "embed_halo", "halo_overlap", "halo_collective")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(world, rank): results} of one process x 8 shards and of two
    processes x 4 shards, the three workers run at once."""
    tmp = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    url = f"file://{tmp / 'rendezvous'}"
    jobs = {(world, rank): str(tmp / f"out_{world}_{rank}.npz")
            for world, rank in ((1, 0), (2, 0), (2, 1))}
    procs = {key: subprocess.Popen(
        [sys.executable, "-c", WORKER, str(key[0]), str(key[1]), url, out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for key, out in jobs.items()}
    errs = {}
    try:
        for key, p in procs.items():
            _, err = p.communicate(timeout=240)
            if p.returncode != 0:
                errs[key] = err[-2000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not errs, errs
    return {key: dict(np.load(out)) for key, out in jobs.items()}


def test_multihost_helpers():
    """tests/test_sharded.py:291-297 in one process: init_distributed is a
    no-op, the global mesh is every shard here, and this process owns the
    whole edge axis."""
    from graph_embed_tpu_torch.parallel import multihost
    from graph_embed_tpu_torch.parallel.mesh import make_mesh

    multihost.init_distributed()
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh(device="cpu")
    assert mesh == make_mesh(1, device="cpu") and mesh.comm is None
    assert multihost.global_mesh(shards_per_process=4,
                                 device="cpu").local_shards == range(4)
    assert multihost.process_local_edge_slice(1024) == (0, 1024)
    s = np.arange(16)
    (got,) = multihost.shard_edges_global((s,), make_mesh(4, device="cpu"))
    assert torch.equal(got, torch.from_numpy(s))


@pytest.mark.parametrize("case", CASES)
def test_two_processes_equal_one(runs, case):
    """2 processes x 4 shards give the stacked 1 x 8 result bit for bit,
    on both ranks."""
    want = runs[(1, 0)][case]
    assert np.isfinite(want).all()
    for rank in (0, 1):
        np.testing.assert_array_equal(runs[(2, rank)][case], want)


def test_import_leaves_jax_and_groups_out():
    """Importing the port, its multihost and profiling modules loads no
    JAX and starts no process group."""
    code = ("import sys, graph_embed_tpu_torch, "
            "graph_embed_tpu_torch.parallel.multihost, "
            "graph_embed_tpu_torch.utils.profiling, torch.distributed as d; "
            "print('jax' in sys.modules, d.is_initialized())")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
