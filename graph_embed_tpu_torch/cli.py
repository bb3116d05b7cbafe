"""Command-line driver of the port.

``embed`` keeps the reference CLI contract (examples/embed.cpp:37,47-67;
graph_embed_tpu/cli.py:44-74):

    python -m graph_embed_tpu_torch.cli embed -f <input> -format
        {adjlist,coolist,table,csr,mtx} -o <output> [-dimension d]
        [-symmetric true|false] [-coarsening c] [-device cuda|cpu]

``-device`` (default ``cuda``) names where the embedding runs; there is no
silent move to the CPU when no GPU is present.
"""

from __future__ import annotations

import sys


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


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "embed":
        return cmd_embed(rest)
    print(f"unknown command {cmd!r}; the port has 'embed'", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
