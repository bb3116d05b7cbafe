"""Quickstart on the PyTorch port: partition + embed + plot a small
community graph.

  python examples/quickstart_torch.py [out.html] [--device cuda|cpu]

The counterpart of examples/quickstart.py: the same graph and the same
``embed_graph`` arguments, with ``seed=0`` for the random streams.  Writes
an interactive HTML layout coloured by the partition hierarchy and prints
a JSON quality record, then ``kernel launches:`` and a JSON object of the
port's kernel launches on standard error.  ``--device`` defaults to
``cuda``: without a card the script raises (``--device cpu`` runs the
plain PyTorch versions).
"""

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def community_graph():
    """6 planted blobs of 40 vertices plus sparse inter edges, from
    ``default_rng(0)``."""
    import graph_embed_tpu_torch as gp

    rng = np.random.default_rng(0)
    n, k = 240, 6
    size = n // k
    s_list, r_list = [], []
    for c in range(k):
        off = c * size
        for i in range(size):
            for j in range(i + 1, size):
                if rng.random() < 0.3:
                    s_list.append(off + i)
                    r_list.append(off + j)
    for _ in range(80):
        a, b = rng.integers(0, n, 2)
        if a != b:
            s_list.append(int(a))
            r_list.append(int(b))
    return gp.from_edges(s_list, r_list, None, n=n, symmetrize=True)


def main(argv=None):
    sys.path.insert(0, ROOT)
    import torch

    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import layout_stress
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.device import resolve
    from graph_embed_tpu_torch.viz import write_embedding_html

    argv = list(argv or sys.argv)[1:]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    device = resolve(device)
    out = argv[0] if argv else "quickstart.html"

    g = community_graph()
    coords, hierarchy = gp.embed_graph(
        g, dim=3, coarsening_factor=0.15, base_iterations=1000,
        refine_iterations=100, seed=0, device=device)

    s, r, _ = g.to_coo_numpy()
    write_embedding_html(
        coords, (s, r), out,
        level_assignments=[p.vertex_to_agg_numpy() for p in hierarchy.levels])
    print(json.dumps({
        "n": g.n, "edges": g.num_edges,
        "levels": hierarchy.level_sizes,
        "modularity_l1": float(gp.modularity(g, hierarchy.levels[0])),
        "stress": layout_stress(g, coords),
        "finite": bool(torch.isfinite(coords).all()),
        "html": out,
    }))
    print("kernel launches: " + json.dumps(dict(cuda.LAUNCHES)),
          file=sys.stderr)


if __name__ == "__main__":
    main()
