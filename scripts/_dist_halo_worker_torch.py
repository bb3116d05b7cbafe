"""Worker of scripts/dist_halo_record_torch.py: one process of the
multi-process halo pipeline record (the PyTorch port).

The counterpart of scripts/_dist_halo_worker.py.  Every process builds
rmat(scale, 8, seed=1) (its weights count duplicate draws, as the JAX
worker keeps them), its hierarchy (coarsening 0.1) and Galerkin chain,
and the comm model of the halo plan on the partition-ordered fine graph at
the mesh's shard count; then the halo pipeline ``embed(..., seed=5,
base_iterations=200, refine_iterations=20, mesh=mesh, mesh_min_n=64,
sharding="halo")`` over ``global_mesh(shards_per_process=8 // nprocs)``
(every level takes the mesh).  Rank 0 prints the record, with the kernel
launches of its embed, and appends it to ``out.jsonl``; its spans go to
``<out.jsonl>.metrics.p0.jsonl``.

  python scripts/_dist_halo_worker_torch.py <rank> <nprocs> <rendezvous> \\
      <out.jsonl> [--device d]

``rendezvous`` is ``init_distributed``'s address (``file:///path`` or
``host:port``; unused with one process).  The scale is
``DIST_HALO_SCALE`` (default 17).  ``--device`` defaults to ``cuda`` and
raises without a card.
"""
import json
import os
import sys
import time

SHARDS = 8


def main(argv):
    rank, nprocs, rendezvous, out_path = (int(argv[1]), int(argv[2]),
                                          argv[3], argv[4])
    device = argv[argv.index("--device") + 1] if "--device" in argv \
        else "cuda"
    scripts = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(scripts), scripts]
    import numpy as np

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.graph.reorder import (apply_order,
                                                     partition_order)
    from graph_embed_tpu_torch.graph.synth import rmat
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.parallel import multihost
    from graph_embed_tpu_torch.parallel.halo import build_halo_plan
    from graph_embed_tpu_torch.utils.device import resolve
    from graph_embed_tpu_torch.utils.timing import MetricsLogger
    from lj_scale_run_torch import card_label

    device = resolve(device)
    t_boot = time.perf_counter()
    multihost.init_distributed(rendezvous, nprocs, rank, backend="gloo")
    boot_s = time.perf_counter() - t_boot
    mesh = multihost.global_mesh(shards_per_process=SHARDS // nprocs,
                                 device=device)

    scale = int(os.environ.get("DIST_HALO_SCALE", "17"))
    t0 = time.perf_counter()
    g = rmat(scale, 8, seed=1)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = gp.partition_hierarchy(g, 0.1)
    part_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs = gp.build_galerkin_chain(g, res.levels)
    gal_s = time.perf_counter() - t0

    # the comm model on the partition-ordered fine level (the plan the
    # halo base case would build at this size): boundary pool against
    # the replicated design
    perm = partition_order(g, levels=res.levels)
    g_ord, _ = apply_order(g, perm)
    plan = build_halo_plan(g_ord, mesh.ndev)
    dim, samp = 3, 64
    comm = {"ndev": mesh.ndev, "B_max": plan.B_max,
            "boundary_fraction": round(plan.boundary_fraction, 4),
            "halo_floats_per_step": plan.comm_floats_per_step(dim, samp),
            "replicated_floats_per_step": 2 * mesh.ndev * plan.blk * dim}

    metrics = MetricsLogger()
    cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    coords = gp.embed(graphs, res.levels, dim, device=device, seed=5,
                      base_iterations=200, refine_iterations=20, mesh=mesh,
                      mesh_min_n=64, sharding="halo", metrics=metrics)
    out = coords.cpu().numpy()
    embed_s = time.perf_counter() - t0
    if not np.isfinite(out).all():
        raise FloatingPointError("non-finite coordinates")

    if rank == 0:
        with open(out_path + ".metrics.p0.jsonl", "a") as f:
            for span in metrics.records:
                f.write(json.dumps(dict(span, nprocs=nprocs)) + "\n")
        rec = {"workload": f"rmat({scale},8) 2-process halo pipeline",
               "nprocs": nprocs, "ndev_local": SHARDS // nprocs,
               "n": g.n, "edges": g.num_edges,
               "levels": len(res.levels) + 1,
               "boot_seconds": round(boot_s, 1),
               "gen_seconds": round(gen_s, 1),
               "partition_seconds": round(part_s, 1),
               "galerkin_seconds": round(gal_s, 1),
               "embed_seconds": round(embed_s, 1),
               "comm_model": comm,
               "coords_checksum": float(np.abs(out).sum()),
               "device": card_label(device),
               "launches": dict(cuda.LAUNCHES)}
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
