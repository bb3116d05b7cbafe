"""Command-line driver of the port.

``embed`` keeps the reference CLI contract (examples/embed.cpp:37,47-67;
graph_embed_tpu/cli.py:44-74):

    python -m graph_embed_tpu_torch.cli embed -f <input> -format
        {adjlist,coolist,table,csr,mtx} -o <output> [-dimension d]
        [-symmetric true|false] [-coarsening c] [-device cuda|cpu]

``embedder`` is the batch pipeline of examples/embedder.cpp:140-295
(largest component, hierarchy, Galerkin chain, embed, the temp dumps and
the HTML plot; graph_embed_tpu/cli.py:77-140):

    python -m graph_embed_tpu_torch.cli embedder -f <adjlist> [-outdir d]
        [-dimension d] [-coarsening c] [-plot true|false] [-device cuda|cpu]

``run-tests`` is the quality harness (harness/runtests.py):

    python -m graph_embed_tpu_torch.cli run-tests <prefix|synth:...> ...
        [-communities] [-heuristics] [-louvain <bin>] [-louvain-nx]
        [-format f] [-device cuda|cpu]

``-device`` (default ``cuda``) names where the work runs; there is no
silent move to the CPU when no GPU is present.  ``embedder`` and
``run-tests`` end with one line on standard error, ``kernel launches:``
and a JSON object of the port's kernel launches in the run.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _parse_kv(argv):
    opts = {}
    i = 0
    while i < len(argv) - 1:
        if argv[i].startswith("-"):
            opts[argv[i]] = argv[i + 1]
            i += 2
        else:
            i += 1
    if argv and argv[-1].startswith("-") and argv[-1] not in opts:
        opts[argv[-1]] = ""
    return opts


def cmd_embed(argv) -> int:
    from .embed.driver import embed_graph
    from .graph.io import FORMATS, read_graph, write_coords

    opts = _parse_kv(argv)
    inputpath = opts.get("-f", "")
    outputpath = opts.get("-o", "")
    fmt = opts.get("-format", "")
    dimension = int(opts.get("-dimension", "3"))
    symmetric = opts.get("-symmetric", "false") == "true"
    coarsening = float(opts.get("-coarsening", "0.1"))
    device = opts.get("-device", "cuda")

    if fmt and fmt not in FORMATS:
        print("-format must be from [adjlist coolist table csr mtx]",
              file=sys.stderr)
        return 1
    if not inputpath:
        print("-f must be present with one argument", file=sys.stderr)
        return 1
    if not outputpath:
        print("-o must be present with one argument", file=sys.stderr)
        return 1
    if not fmt:
        print("--inputformat must be present with one argument",
              file=sys.stderr)
        return 1

    g = read_graph(inputpath, fmt, symmetric=symmetric)
    coords, _ = embed_graph(g, dimension, device=device,
                            coarsening_factor=coarsening)
    write_coords(coords, outputpath)
    return 0


def _print_launches() -> None:
    from .ops import cuda

    print("kernel launches: " + json.dumps(dict(cuda.LAUNCHES)),
          file=sys.stderr)


def cmd_embedder(argv) -> int:
    """Batch pipeline (examples/embedder.cpp:140-295)."""
    import numpy as np

    from .embed.driver import build_galerkin_chain, embed
    from .graph.components import largest_component
    from .graph.io import (PARSES, read_adjlist, write_coords,
                           write_multilevel_partition)
    from .partition.hierarchy import partition_hierarchy
    from .utils.device import resolve
    from .utils.params import PartitionParams
    from .viz import plot_graph_html

    opts = _parse_kv(argv)
    inputpath = opts.get("-f", "")
    outdir = opts.get("-outdir", "temp")
    dimension = int(opts.get("-dimension", "3"))
    coarsening = float(opts.get("-coarsening", str(1.0 / 10.0)))
    do_plot = opts.get("-plot", "true") == "true"
    device = resolve(opts.get("-device", "cuda"))
    if not inputpath:
        print("-f must be present", file=sys.stderr)
        return 1

    os.makedirs(outdir, exist_ok=True)
    print(f"doing: {inputpath}")
    t0 = time.perf_counter()
    g = read_adjlist(inputpath, symmetric=True).to(device)
    route = "native" if PARSES["native"] else "loadtxt"
    print(f"read in time {time.perf_counter() - t0}s ({route} parser)")
    print(f"before: {g.n}")
    g, _ = largest_component(g)
    print(f"after: {g.n}")
    print(f"{g.n} {g.n} {g.num_edges}")
    print("input read")

    # embedder.cpp:186-187: partition(A, 1/10, false, true, 1.0, 1, false)
    t0 = time.perf_counter()
    res = partition_hierarchy(g, coarsening, PartitionParams(
        printing=False, positive_merging=True, stall_stop_threshold=1.0,
        matching_iterations=1, merge_leaves=False), emit_graphs=True)
    print(f"partitioned! in time {time.perf_counter() - t0}s")
    print(" ".join(str(s) for s in res.level_sizes))

    # the native backend emits the Galerkin chain with the hierarchy;
    # otherwise build_galerkin_chain builds it where g lives (a graph read
    # from a file keeps its host COO, so on the host)
    graphs = ([g] + res.coarse_graphs if res.coarse_graphs is not None
              else build_galerkin_chain(g, res.levels))
    print("starting embedding: ")
    t0 = time.perf_counter()
    coords = embed(graphs, res.levels, dimension, device=device)
    coords = coords.cpu().numpy()
    print(f"embedded! in time {time.perf_counter() - t0}s")
    if not np.isfinite(coords).all():       # embedder.cpp:224-228
        print("embedding has non-finite coordinates", file=sys.stderr)
        return 1

    partpath = f"{outdir}/part.temp"
    coordspath = f"{outdir}/coords.temp"
    plotpath = f"{outdir}/plot.html"
    matpath = f"{outdir}/mat.temp"
    t0 = time.perf_counter()
    write_multilevel_partition(
        [p.vertex_to_agg_numpy() for p in res.levels], partpath)
    c3 = coords if dimension == 3 else np.concatenate(
        [coords, np.zeros((coords.shape[0], 3 - dimension))], axis=1)
    write_coords(c3, coordspath)
    s, r, _ = g.to_coo_numpy()
    with open(matpath, "w") as f:
        f.writelines(map("{} {}\n".format, s.tolist(), r.tolist()))
    print(f"written in time {time.perf_counter() - t0}s")
    if do_plot:
        plot_graph_html(matpath, partpath, coordspath, plotpath)
        print(f"wrote {plotpath}")
    _print_launches()
    return 0


def cmd_run_tests(argv) -> int:
    from .harness.runtests import main as harness_main

    rc = harness_main(argv)
    _print_launches()
    return rc


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "embed":
        return cmd_embed(rest)
    if cmd == "embedder":
        return cmd_embedder(rest)
    if cmd in ("run-tests", "runtests"):
        return cmd_run_tests(rest)
    print(f"unknown command {cmd!r}; the port has 'embed', 'embedder' and "
          "'run-tests'", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
