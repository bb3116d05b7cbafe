"""Staged milestone configs from BASELINE.md on the PyTorch port, end to end.

The counterpart of examples/staged_configs.py: the same graphs (built with
numpy from the same seeds), the same calls of the port and the same
records.

  python examples/staged_configs_torch.py 1   # ~1k-vertex flat FA, 2D,
                                              # gram repulsion
  python examples/staged_configs_torch.py 2   # 50k-vertex mesh, hierarchy
                                              # cf=1/8, multilevel embed, 2D
  python examples/staged_configs_torch.py 3   # ~1M-edge graph, sampled
                                              # repulsion, 3D, tiled step
                                              # (kernel D, kernel A on the
                                              # residual edges)
  python examples/staged_configs_torch.py 4   # 1M-vertex power-law graph,
                                              # edge-sharded over the cards

Configs 2-4 take an edge-list path (coolist: ``s r w`` per line) as the
second argument in place of their synthetic graph.  ``--device`` defaults
to ``cuda``: without a card the script raises (``--device cpu`` runs the
plain PyTorch versions on the CPU).  Config 4 takes one shard per card
(``torch.cuda.device_count()``), or ``--shards k`` shards stacked on the
device.  Each config prints one JSON record, and ends with one line on
standard error, ``kernel launches:`` and a JSON object of the port's kernel
launches in the run.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mesh2d(L):
    import graph_embed_tpu_torch as gp

    n = L * L
    idx = np.arange(n)
    x, y = idx % L, idx // L
    s_list, r_list = [], []
    for dx, dy in ((1, 0), (0, 1), (1, 1)):
        m = (x + dx < L) & (y + dy < L)
        s_list.append(idx[m])
        r_list.append(idx[m] + dx + dy * L)
    return gp.from_edges(np.concatenate(s_list), np.concatenate(r_list),
                         None, n=n, symmetrize=True)


def powerlaw(n, e, seed=0):
    import graph_embed_tpu_torch as gp

    rng = np.random.default_rng(seed)
    u = rng.random(e)
    s = (u * u * n).astype(np.int64)
    r = rng.integers(0, n, e)
    keep = s != r
    return gp.from_edges(s[keep], r[keep], None, n=n, symmetrize=True)


def read(path):
    import graph_embed_tpu_torch as gp

    return gp.read_graph(path, "coolist", symmetric=True)


def finite(coords) -> bool:
    import torch

    return bool(torch.isfinite(coords).all())


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config1(device):
    import graph_embed_tpu_torch as gp

    g = powerlaw(1000, 4000, seed=1)
    t0 = time.time()
    coords = gp.force_atlas(g, 2, params=gp.ForceAtlasParams(repulsion="gram"),
                            iterations=1000, seed=0, device=device)
    synchronize(device)
    return {"config": 1, "n": g.n, "edges": g.num_edges,
            "seconds": time.time() - t0, "finite": finite(coords)}


def config2(device, path=None):
    import graph_embed_tpu_torch as gp

    g = read(path) if path else mesh2d(224)
    t0 = time.time()
    res = gp.partition_hierarchy(g, 1.0 / 8.0)
    t_part = time.time() - t0
    graphs = gp.build_galerkin_chain(g, res.levels)
    t0 = time.time()
    coords = gp.embed(graphs, res.levels, 2, base_iterations=2000,
                      refine_iterations=100, seed=0, device=device)
    synchronize(device)
    t_embed = time.time() - t0
    q = float(gp.modularity(g, res.levels[0]))
    return {"config": 2, "n": g.n, "edges": g.num_edges,
            "levels": res.level_sizes, "partition_seconds": t_part,
            "embed_seconds": t_embed, "modularity_l1": q,
            "finite": finite(coords)}


def config3(device, path=None):
    import graph_embed_tpu_torch as gp

    g = read(path) if path else powerlaw(200_000, 1_000_000, seed=3)
    params = gp.ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    t0 = time.time()
    coords = gp.force_atlas_tiled(g, 3, params=params, iterations=200,
                                  seed=0, device=device)
    synchronize(device)
    return {"config": 3, "n": g.n, "edges": g.num_edges,
            "seconds": time.time() - t0, "finite": finite(coords)}


def config4(device, path=None, shards=None):
    import torch

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.parallel import make_mesh, sharded_force_atlas

    # com-LiveJournal stand-in: 4M vertices / ~35M stored entries scaled
    # down; pass a real edge list to override
    g = read(path) if path else powerlaw(1_000_000, 8_000_000, seed=4)
    if shards is None:
        shards = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = make_mesh(shards, device=device)
    params = gp.ForceAtlasParams(repulsion="sampled", num_negative_samples=64)
    t0 = time.time()
    coords = sharded_force_atlas(g, 3, mesh=mesh, params=params,
                                 iterations=50, device=device)
    synchronize(device)
    return {"config": 4, "n": g.n, "edges": g.num_edges,
            "devices": mesh.ndev, "seconds": time.time() - t0,
            "finite": finite(coords)}


def parse_args(argv):
    """(config, path, device, shards) from ``[config] [path]`` and the
    options ``--device d`` and ``--shards k`` anywhere."""
    args, opts = [], {"--device": "cuda", "--shards": None}
    it = iter(argv[1:])
    for a in it:
        if a in opts:
            opts[a] = next(it)
        else:
            args.append(a)
    which = int(args[0]) if args else 1
    path = args[1] if len(args) > 1 else None
    shards = opts["--shards"]
    return which, path, opts["--device"], (int(shards) if shards else None)


def main(argv=None):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.device import resolve

    which, path, device, shards = parse_args(argv or sys.argv)
    device = resolve(device)
    if which == 1:
        rec = config1(device)
    elif which == 4:
        rec = config4(device, path, shards)
    else:
        rec = {2: config2, 3: config3}[which](device, path)
    print(json.dumps(rec))
    print("kernel launches: " + json.dumps(dict(cuda.LAUNCHES)),
          file=sys.stderr)


if __name__ == "__main__":
    main()
