"""Quality harness: the port of examples/run-tests.cpp.

Counterpart of graph_embed_tpu/harness/runtests.py.  Per roster graph it
measures the partition's seconds (:197-202) and modularity (:204), runs
an external Louvain when asked (:217-227; here networkx in-process or a
binary given by path), the A/B of the one-sided greedy against the
mutual-best rule (:285-300) and pair-counting similarity against ground
truth (:302-349).  Graphs are moved to ``device`` ("cuda" unless the
caller asks for the CPU): the modularity evaluations run there; the
greedy and native coarseners read the host COO.

The reference's ``compareComm`` counts pairs in an O(n^2) loop and
increments only one of its counters (run-tests.cpp:104-106); here the
counts come from a contingency table and every ratio is real, the two
live reference ratios bit-for-bit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def read_louvain_aggregates(path, n=None):
    """Parse a Louvain ``.tree`` file (multilevel 'node comm' pairs,
    run-tests.cpp:42-89) into an original-vertex assignment."""
    levels = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if len(toks) < 2:
                continue
            node, comm = int(toks[0]), int(toks[1])
            if node == 0:
                levels.append([])
            levels[-1].append(comm)
    if not levels:
        return np.zeros(0, dtype=np.int64)
    v = np.arange(len(levels[0]), dtype=np.int64)
    for lvl in levels:
        v = np.asarray(lvl, dtype=np.int64)[v]
    return v


def read_cmty(path, n):
    """Ground-truth communities, one per line listing its members (SNAP
    ``.cmty``, run-tests.cpp:302-317); a vertex in none gets -1, in
    several the last."""
    assign = np.full(n, -1, dtype=np.int64)
    with open(path) as f:
        for c, line in enumerate(f):
            for tok in line.split():
                assign[int(tok)] = c
    return assign


def louvain_networkx(g, seed: int = 0):
    """Louvain labels [n] from networkx, the in-process stand-in for the
    reference's external Louvain binary (run-tests.cpp:217).  networkx is
    imported only here."""
    import networkx as nx

    s, r, w = g.to_coo_numpy()
    G = nx.Graph()
    G.add_nodes_from(range(g.n))
    G.add_weighted_edges_from(zip(s.tolist(), r.tolist(), w.tolist()))
    comms = nx.community.louvain_communities(G, seed=seed)
    assign = np.zeros(g.n, dtype=np.int64)
    for c, members in enumerate(comms):
        for v in members:
            assign[v] = c
    return assign


def pair_counting_similarity(comm1, comm2):
    """Exact pair-counting agreement of two assignments: each one's
    same-aggregate pairs, the pairs in both, and the ratios of
    run-tests.cpp:347-348 (intersection over each total)."""
    comm1 = np.asarray(comm1)
    comm2 = np.asarray(comm2)
    if comm1.shape != comm2.shape:
        raise ValueError("assignments of different lengths")

    def same_pairs(labels):
        _, counts = np.unique(labels, return_counts=True)
        return int((counts * (counts - 1) // 2).sum())

    key = comm1.astype(np.int64) * (comm2.max() + 2) + comm2
    _, cell_counts = np.unique(key, return_counts=True)
    both = int((cell_counts * (cell_counts - 1) // 2).sum())
    t1, t2 = same_pairs(comm1), same_pairs(comm2)
    return {
        "total_pairs_1": t1,
        "total_pairs_2": t2,
        "pairs_in_both": both,
        "precision": both / t1 if t1 else 0.0,
        "recall": both / t2 if t2 else 0.0,
    }


def _load_roster_graph(graph_path_prefix, fmt, device="cpu"):
    """A roster entry: a file prefix (reads <prefix>.edges) or a synthetic
    spec standing in for the reference's SNAP/DIMACS roster
    (run-tests.cpp:361-400):

      synth:mesh3d:L[:extra_frac[:seed]]          roadnet/mesh family
      synth:rmat:scale[:edge_factor[:seed]]       social/web power-law
      synth:planted:k:size[:p_in[:p_out[:seed]]]  ground-truth communities
      synth:ring:cliques:size                     modularity sanity

    Returns (graph on ``device``, truth labels or None)."""
    from ..graph import synth
    from ..graph.io import read_graph

    if not graph_path_prefix.startswith("synth:"):
        return read_graph(graph_path_prefix + ".edges", fmt, symmetric=True,
                          device=device), None
    parts = graph_path_prefix.split(":")
    fam, args = parts[1], parts[2:]
    if fam == "mesh3d":
        return synth.mesh3d(int(args[0]),
                            extra_frac=float(args[1]) if len(args) > 1
                            else 0.0,
                            seed=int(args[2]) if len(args) > 2 else 0,
                            device=device), None
    if fam == "rmat":
        return synth.rmat(int(args[0]), int(args[1]) if len(args) > 1 else 16,
                          seed=int(args[2]) if len(args) > 2 else 0,
                          device=device), None
    if fam == "planted":
        return synth.planted_partition(
            int(args[0]), int(args[1]),
            p_in=float(args[2]) if len(args) > 2 else 0.3,
            p_out=float(args[3]) if len(args) > 3 else 0.01,
            seed=int(args[4]) if len(args) > 4 else 0, device=device)
    if fam == "ring":
        return synth.ring_of_cliques(int(args[0]), int(args[1]),
                                     device=device), None
    raise ValueError(f"unknown synth family: {fam}")


def run_test(graph_path_prefix, fmt="coolist", *, has_true_communities=False,
             louvain_bin=None, do_heuristics=False, randomize=False,
             do_louvain_nx=False, device="cuda", out=sys.stdout):
    """One roster entry (run-tests.cpp:145-353); prints and returns its
    JSON record."""
    from ..graph.csr import from_edges
    from ..partition.hierarchy import partition_base, partition_test
    from ..partition.interpolation import partition_from_labels
    from ..partition.modularity import modularity
    from ..utils.device import resolve

    device = resolve(device)
    graph_path = graph_path_prefix + ".edges"
    g, synth_truth = _load_roster_graph(graph_path_prefix, fmt, device)
    if randomize:
        # +-0.1% random vertex reweighting to break ties
        # (run-tests.cpp:162-181)
        rng = np.random.default_rng(0)
        s, r, w = g.to_coo_numpy()
        vw = rng.uniform(1 - 0.001, 1 + 0.001, size=g.n)
        g = from_edges(s, r, w * vw[s] * vw[r], n=g.n, dtype=g.dtype,
                       device=device)

    record = {"graph": graph_path_prefix, "n": g.n, "edges": g.num_edges}
    t0 = time.perf_counter()
    part = partition_base(g, 0.999)
    record["partition_seconds"] = time.perf_counter() - t0
    record["aggregates"] = part.num_aggs
    record["modularity"] = float(modularity(g, part))

    if louvain_bin == "networkx" or (louvain_bin is None and do_louvain_nx):
        t0 = time.perf_counter()
        nx_assign = louvain_networkx(g)
        record["louvain_seconds"] = time.perf_counter() - t0
        lp = partition_from_labels(nx_assign, device=device)
        record["louvain_modularity"] = float(modularity(g, lp))
    elif louvain_bin and os.path.exists(louvain_bin):
        tree = graph_path_prefix + ".tree"
        t0 = time.perf_counter()
        with open(tree, "w") as f:
            subprocess.run([louvain_bin, graph_path, "-l", "-1"], stdout=f,
                           check=False)
        record["louvain_seconds"] = time.perf_counter() - t0
        louvain = read_louvain_aggregates(tree, g.n)
        if louvain.size == g.n:
            lp = partition_from_labels(louvain, device=device)
            record["louvain_modularity"] = float(modularity(g, lp))

    if do_heuristics:
        t0 = time.perf_counter()
        part2 = partition_test(g, 0.999)
        record["variant_seconds"] = time.perf_counter() - t0
        record["variant_modularity"] = float(modularity(g, part2))
        record["variant_similarity"] = pair_counting_similarity(
            part.vertex_to_agg_numpy(), part2.vertex_to_agg_numpy())

    if has_true_communities or synth_truth is not None:
        truth = synth_truth
        if truth is None:
            cmty_path = graph_path_prefix + ".cmty"
            truth = (read_cmty(cmty_path, g.n)
                     if os.path.exists(cmty_path) else None)
        if truth is not None:
            truth = np.asarray(truth)
            mask = truth >= 0
            record["ground_truth_similarity"] = pair_counting_similarity(
                part.vertex_to_agg_numpy()[mask], truth[mask])

    print(json.dumps(record), file=out)
    return record


def main(argv) -> int:
    """CLI: run-tests <prefix> [<prefix> ...] [-louvain <bin>]
    [-communities] [-heuristics] [-louvain-nx] [-format coolist]
    [-device cuda|cpu]"""
    def opt(name, default=None):
        return argv[argv.index(name) + 1] if name in argv else default

    valued = {"-louvain", "-format", "-device"}
    prefixes = [a for i, a in enumerate(argv) if not a.startswith("-")
                and not (i and argv[i - 1] in valued)]
    for p in prefixes:
        run_test(p, opt("-format", "coolist"),
                 has_true_communities="-communities" in argv,
                 louvain_bin=opt("-louvain"),
                 do_heuristics="-heuristics" in argv,
                 do_louvain_nx="-louvain-nx" in argv,
                 device=opt("-device", "cuda"))
    return 0


def layout_stress(g, coords) -> float:
    """Edge stress of a layout at its best global scale, min_a mean over
    edges (a |x_i - x_j| - 1)^2 (the quality row of BASELINE.md), in
    float64 on the host."""
    s, r, _ = g.to_coo_numpy()
    if hasattr(coords, "detach"):
        coords = coords.detach().cpu().double().numpy()
    coords = np.asarray(coords, dtype=np.float64)
    keep = s < r
    d = np.linalg.norm(coords[s[keep]] - coords[r[keep]], axis=1)
    denom = float((d * d).sum())
    if denom == 0:
        return float("inf")
    a = float(d.sum()) / denom
    return float(((a * d - 1.0) ** 2).mean())


def run_embed_test(graph_path_prefix, fmt="coolist", *, dim=3,
                   coarsening=0.1, device="cuda", out=sys.stdout):
    """Embed-quality roster entry: the multilevel embed's seconds and its
    layout stress (the embedder pipeline's measurement,
    embedder.cpp:219-222)."""
    import torch

    from ..embed.driver import embed_graph
    from ..partition.modularity import modularity
    from ..utils.device import resolve

    device = resolve(device)
    g, _ = _load_roster_graph(graph_path_prefix, fmt, device)
    record = {"graph": graph_path_prefix, "n": g.n, "edges": g.num_edges}
    t0 = time.perf_counter()
    coords, res = embed_graph(g, dim, device=device,
                              coarsening_factor=coarsening)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    record["embed_seconds"] = time.perf_counter() - t0
    record["levels"] = res.level_sizes
    record["stress"] = layout_stress(g, coords)
    record["modularity_l1"] = float(modularity(g, res.levels[0]))
    print(json.dumps(record), file=out)
    return record
