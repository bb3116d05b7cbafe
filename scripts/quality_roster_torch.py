"""Quality roster at scale (the PyTorch port).

The counterpart of scripts/quality_roster.py, with its ``ROSTER``, flags
and record keys.  It runs the run-tests-style quality suite on 100k-1M
vertex synthetic stand-ins of the reference roster's families
(run-tests.cpp:361-400) and records per graph:

  * partition_base (the one-sided greedy, native, on the host) and
    partition_test (the mutual-best coarsener), each with its seconds and
    its modularity on the card (kernel A), after the reference harness's
    +-0.1% random vertex reweighting (run-tests.cpp:162-181);
  * the modularity of networkx's Louvain (the comparison oracle,
    run-tests.cpp:204-227) up to ``--louvain-max-n`` vertices, where
    networkx can be imported; else ``"louvain": "networkx not
    installed"``: the oracle is not the device path;
  * the ground-truth pair-counting similarity of planted graphs;
  * the hierarchy's level sizes and per-level modularity, and for planted
    graphs the level nearest the true community count with its
    similarity;
  * with ``--embed``, the Galerkin chain, the multilevel embed's seconds
    and its layout stress.

One JSON line per entry on standard output, and all of them written to
``--out`` (default ``bench_quality_torch.jsonl``); last, on standard
error, ``kernel launches: {...}``.  An entry that raises
is recorded as ``{"graph": spec, "error": ...}``, the roster goes on, and
the script exits 1 at the end.

  python scripts/quality_roster_torch.py [--embed] [--only SUBSTRING] \\
      [--louvain-max-n N] [--embed-max-n N] [--device d | --cpu] [-o out]

``--device`` defaults to ``cuda`` and raises without a card; ``--cpu``
is ``--device cpu`` (the plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import ROOT, card_label  # noqa: E402

OUT = "bench_quality_torch.jsonl"

# the JAX roster's entries, families and sizes of run-tests.cpp:361-400
ROSTER = [
    # email-Eu-core role (ground truth), scaled to 100k and 1M
    "synth:planted:200:500:0.05:0.0001",        # 100k V, ~2.4M intra + inter
    "synth:planted:1000:1000:0.012:0.000002",   # 1M V, ~6M intra + ~1M inter
    # com-youtube / com-lj role (power-law)
    "synth:rmat:17:16",                          # ~128k V, ~2M stored
    "synth:rmat:20:8",                           # ~1M V, ~8M stored
    # roadNet / delaunay / mat_* role (mesh)
    "synth:mesh3d:48",                           # 110k V, 650k stored
    "synth:mesh3d:100",                          # 1M V, 6M stored
]


def rounded_similarity(sim):
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in sim.items()}


def reweighted(g, device):
    """The harness's +-0.1% random vertex reweighting (the one-sided
    greedy degenerates on exact ties; run-tests.cpp:162-181)."""
    import graph_embed_tpu_torch as gp

    rng = np.random.default_rng(0)
    s, r, w = g.to_coo_numpy()
    vw = rng.uniform(1 - 0.001, 1 + 0.001, size=g.n)
    return gp.from_edges(s, r, w * vw[s] * vw[r], n=g.n, symmetrize=False,
                         dtype=g.dtype, device=device)


def nearest_level(hier, k_true):
    """The hierarchy level whose aggregate count is nearest ``k_true`` on
    a log scale."""
    return min(range(1, len(hier.levels) + 1),
               key=lambda u: abs(np.log(hier.levels[u - 1].num_aggs
                                        / k_true)))


def run_entry(spec, *, louvain_max_n, do_embed, embed_max_n, out_records,
              device):
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import (
        _load_roster_graph, layout_stress, louvain_networkx,
        pair_counting_similarity)

    g, truth = _load_roster_graph(spec, "coolist", device=device)
    rec = {"graph": spec, "n": g.n, "edges": g.num_edges}
    print(f"== {spec}: n={g.n} stored={g.num_edges}", file=sys.stderr,
          flush=True)
    g = reweighted(g, device)
    rec["randomized"] = True

    # greedy benchmark variant (partitionBase role, run-tests.cpp:199)
    t0 = time.perf_counter()
    part = gp.partition_base(g, 0.999)
    rec["partition_seconds"] = round(time.perf_counter() - t0, 3)
    rec["aggregates"] = part.num_aggs
    rec["modularity"] = round(float(gp.modularity(g, part)), 4)

    # mutual-best variant (partitionTest role; the A/B of :285-300)
    t0 = time.perf_counter()
    part2 = gp.partition_test(g, 0.999)
    rec["variant_seconds"] = round(time.perf_counter() - t0, 3)
    rec["variant_modularity"] = round(float(gp.modularity(g, part2)), 4)

    # the Louvain oracle where tractable (networkx is pure Python)
    if g.n <= louvain_max_n:
        if importlib.util.find_spec("networkx") is None:
            rec["louvain"] = "networkx not installed"
        else:
            t0 = time.perf_counter()
            nx_assign = louvain_networkx(g)
            rec["louvain_seconds"] = round(time.perf_counter() - t0, 1)
            lp = gp.partition_from_labels(nx_assign, device=device)
            rec["louvain_modularity"] = round(float(gp.modularity(g, lp)),
                                              4)

    if truth is not None:
        truth = np.asarray(truth)
        rec["ground_truth_similarity"] = rounded_similarity(
            pair_counting_similarity(part.vertex_to_agg_numpy(), truth))

    # the whole hierarchy: level sizes and per-level modularity
    t0 = time.perf_counter()
    hier = gp.partition_hierarchy(g, 0.1)
    rec["hierarchy_seconds"] = round(time.perf_counter() - t0, 3)
    rec["level_sizes"] = hier.level_sizes
    rec["level_modularity"] = [
        round(float(gp.modularity(g, gp.compose(hier.levels, upto))), 4)
        for upto in range(1, len(hier.levels) + 1)]

    if truth is not None:
        # the greedy single level stalls early at scale (the reference's
        # behaviour), so the hierarchy is the recovery to compare
        upto = nearest_level(hier, int(np.unique(truth).size))
        hp = gp.compose(hier.levels, upto)
        rec["hierarchy_truth_level"] = [upto, hp.num_aggs]
        rec["hierarchy_truth_similarity"] = rounded_similarity(
            pair_counting_similarity(hp.vertex_to_agg_numpy(), truth))

    if do_embed and g.n <= embed_max_n:
        t0 = time.perf_counter()
        graphs = gp.build_galerkin_chain(g, hier.levels)
        rec["galerkin_seconds"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        coords = gp.embed(graphs, hier.levels, 3, device=device)
        coords_np = coords.cpu().numpy()
        rec["embed_seconds"] = round(time.perf_counter() - t0, 1)
        if not np.isfinite(coords_np).all():
            raise FloatingPointError("non-finite coordinates")
        rec["stress"] = round(layout_stress(g, coords_np), 4)

    rec["device"] = card_label(device)
    print(json.dumps(rec), flush=True)
    out_records.append(rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--louvain-max-n", type=int, default=150_000)
    ap.add_argument("--embed", action="store_true")
    ap.add_argument("--embed-max-n", type=int, default=1_100_000)
    ap.add_argument("--only", default=None,
                    help="substring filter over roster specs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true",
                    help="--device cpu: the plain PyTorch versions")
    ap.add_argument("-o", "--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.device import resolve

    device = resolve("cpu" if args.cpu else args.device)
    records, failed = [], 0
    for spec in ROSTER:
        if args.only and args.only not in spec:
            continue
        try:
            run_entry(spec, louvain_max_n=args.louvain_max_n,
                      do_embed=args.embed, embed_max_n=args.embed_max_n,
                      out_records=records, device=device)
        except Exception as e:
            # record the failure, run the rest, and exit 1 at the end
            traceback.print_exc()
            failed += 1
            print(json.dumps({"graph": spec, "error": repr(e)}), flush=True)
            records.append({"graph": spec, "error": repr(e)})
    with open(args.out, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    print(f"kernel launches: {json.dumps(dict(cuda.LAUNCHES))}",
          file=sys.stderr)
    if failed:
        print(f"{failed} roster entries failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
