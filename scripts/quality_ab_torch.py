"""Native greedy against the cached hierarchy's partition quality at the
sizes the LiveJournal-scale runs embed (the PyTorch port).

The counterpart of scripts/quality_ab.py, with its arguments and record
keys.  For each prep cache of scripts/lj_scale_run_torch.py given (``22
8``, ``mesh 256``, ...):
  * the modularity of each level of the cached mutual-best hierarchy
    (host bincounts);
  * the native one-sided greedy (partitionBase, run-tests.cpp:199) on the
    fine graph at the harness's stall threshold (0.999), with its seconds
    and modularity.

Host work only, as the JAX script's is: it takes no ``--device`` and
touches no card.  One record per cache on standard output, each appended
to ``--out`` (default ``quality_ab_torch.jsonl``).

  python scripts/quality_ab_torch.py [scale ef]... [--out path]
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import (ROOT, cache_dir, log,  # noqa: E402
                                split_args)

OUT = "quality_ab_torch.jsonl"


def q_host(s, r, w, v2a, m):
    """Modularity (src/partitioner.cpp:69-114, no int truncation)."""
    a, b = v2a[s], v2a[r]
    T = w.sum()
    intra = a == b
    d = np.bincount(a[intra], w[intra], minlength=m)
    out = np.bincount(a[~intra], w[~intra], minlength=m)
    alpha = (d + out) / T
    return float((d / T).sum() - (alpha ** 2).sum())


def run_one(scale, ef):
    from graph_embed_tpu_torch.native import greedy_lib

    d = cache_dir(scale, ef)
    with open(os.path.join(d, "prep.json")) as f:
        rec = json.load(f)
    z = np.load(os.path.join(d, "graph0.npz"))
    s, r, w = z["s"], z["r"], np.asarray(z["w"], np.float64)
    n = int(z["n"])
    pz = np.load(os.path.join(d, "parts.npz"))
    nlev = len(rec["level_sizes"]) - 1
    out = {"workload": rec["workload"], "n": n, "edges": int(s.size),
           "hierarchy_q_per_level": [], "partition_seconds":
           rec.get("partition_seconds")}
    comp = None
    for l in range(nlev):
        v2a = pz[f"v2a{l}"]
        comp = v2a if comp is None else v2a[comp]
        m = int(comp.max()) + 1
        q = q_host(s, r, w, comp, m)
        out["hierarchy_q_per_level"].append(
            {"level": l + 1, "aggs": m, "q": round(q, 4)})
        log(f"{rec['workload']} hierarchy level {l+1}: m={m} Q={q:.4f}")

    t0 = time.perf_counter()
    assign, m_g, _ = greedy_lib.greedy_run(
        n, s, r, np.asarray(z["w"], np.float32),
        stall_stop_threshold=0.999, variant="base")
    out["greedy_seconds"] = round(time.perf_counter() - t0, 1)
    out["greedy_aggs"] = int(m_g)
    out["greedy_q"] = round(q_host(s, r, w, assign, int(m_g)), 4)
    log(f"{rec['workload']} native greedy: m={m_g} Q={out['greedy_q']:.4f} "
        f"({out['greedy_seconds']}s)")
    return out


def main(argv):
    sys.path.insert(0, ROOT)
    args, opts = split_args(argv, out=OUT)
    args = args or ["22", "8"]
    for i in range(0, len(args), 2):
        scale = args[i] if args[i] == "mesh" else int(args[i])
        rec = run_one(scale, int(args[i + 1]))
        print(json.dumps(rec), flush=True)
        with open(opts["out"], "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
