"""Does max_agg_size recover the planted 1M graph's precision?  (The
PyTorch port.)

The counterpart of scripts/planted_precision.py, with its flags and record
keys.  The planted 1000 x 1000 roster graph (p_in 0.012, p_out 2e-6) after
the harness's +-0.1% vertex reweighting; per cap, the native hierarchy
with ``PartitionParams(max_agg_size=cap, cap_unit="original")`` (cap 0:
the defaults), the level nearest the true community count, its
pair-counting precision and recall against the planted truth, and its
modularity on the card (kernel A).

  python scripts/planted_precision_torch.py [-o out.jsonl] [--caps 0,1200]
      [--k 1000] [--m 1000] [--device d]

Records go to standard output and to ``-o`` (default
``bench_planted_precision_torch.jsonl``); last, on standard error,
``kernel launches: {...}``.  ``--device`` defaults to
``cuda`` and raises without a card (``--device cpu``: plain versions).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import card_label  # noqa: E402
from quality_roster_torch import (ROOT, nearest_level,  # noqa: E402
                                  reweighted, rounded_similarity)

OUT = "bench_planted_precision_torch.jsonl"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--out", default=OUT)
    ap.add_argument("--caps", default="0,1200,1500,2500")
    ap.add_argument("--k", type=int, default=1000, help="communities")
    ap.add_argument("--m", type=int, default=1000, help="community size")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import graph_embed_tpu_torch as gp
    from graph_embed_tpu_torch.harness.runtests import (
        _load_roster_graph, pair_counting_similarity)
    from graph_embed_tpu_torch.ops import cuda
    from graph_embed_tpu_torch.utils.device import resolve
    from graph_embed_tpu_torch.utils.params import PartitionParams

    device = resolve(args.device)
    label = card_label(device)
    spec = f"synth:planted:{args.k}:{args.m}:0.012:0.000002"
    g, truth = _load_roster_graph(spec, "coolist", device=device)
    truth = np.asarray(truth)
    print(f"{spec}: n={g.n} stored={g.num_edges}", file=sys.stderr,
          flush=True)
    g = reweighted(g, device)

    records = []
    for cap in (int(c) for c in args.caps.split(",")):
        # the cap bounds original-vertex mass: the per-level default resets
        # sizes at each snapshot and never binds on the way to the truth
        # level
        params = PartitionParams() if cap == 0 else PartitionParams(
            max_agg_size=cap, cap_unit="original")
        t0 = time.perf_counter()
        hier = gp.partition_hierarchy(g, 0.1, params, backend="native")
        secs = round(time.perf_counter() - t0, 1)
        upto = nearest_level(hier, args.k)
        hp = gp.compose(hier.levels, upto)
        sim = pair_counting_similarity(hp.vertex_to_agg_numpy(), truth)
        rec = {"graph": spec, "max_agg_size": cap,
               "hierarchy_seconds": secs,
               "level_sizes": hier.level_sizes,
               "truth_level": [upto, hp.num_aggs],
               "Q_at_level": round(float(gp.modularity(g, hp)), 4),
               "similarity": rounded_similarity(sim),
               "device": label}
        print(json.dumps(rec), flush=True)
        records.append(rec)

    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"kernel launches: {json.dumps(dict(cuda.LAUNCHES))}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
