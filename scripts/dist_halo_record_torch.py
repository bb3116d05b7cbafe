"""Multi-process halo pipeline record (the PyTorch port): one process x 8
shards against two processes x 4 shards, on the same graph and seed.

The counterpart of scripts/dist_halo_record.py, with its arguments and
record keys.  Each arm runs scripts/_dist_halo_worker_torch.py: first one
process holding all 8 shards, then two processes of 4 shards each, joined
by ``multihost.init_distributed`` under gloo (a ``file://`` rendezvous in
the work directory; on one card the ranks share it and gloo stages CUDA
tensors through the host).  Rank 0 of each arm appends its record (the
seconds of each phase, the halo plan's comm model and the checksum of the
coordinates) to ``--out`` (default ``dist_halo_record_torch.jsonl``).  The
two processes must give the coordinates of the one: the script exits 1
unless both arms' checksums are equal, or if any process fails.

  python scripts/dist_halo_record_torch.py [scale] [--device d] \\
      [--out path]

``scale`` defaults to 17 (rmat(17, 8, seed=1): 77,410 vertices).  Work
files (the rendezvous, rank 0's spans) go under
``.lj_cache/torch/dist_halo_rmat<scale>``.  ``--device`` defaults to
``cuda`` and raises without a card (``--device cpu``: plain versions).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lj_scale_run_torch import ROOT, split_args  # noqa: E402

WORKER = os.path.join(ROOT, "scripts", "_dist_halo_worker_torch.py")
CACHE_ROOT = os.path.join(ROOT, ".lj_cache", "torch")
OUT = "dist_halo_record_torch.jsonl"
TIMEOUT = 3000


def run_arm(nprocs, work, out, device, env):
    """Start the arm's ``nprocs`` workers at once; rank 0's record, or None
    if a worker failed or outlived ``TIMEOUT``."""
    rendezvous = os.path.join(work, f"rendezvous_{nprocs}")
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, str(rank), str(nprocs),
         f"file://{rendezvous}", out, "--device", device],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, text=True)
        for rank in range(nprocs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        print(f"{nprocs}-process arm outlived {TIMEOUT} s", flush=True)
        return None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        print(f"{nprocs}-process arm failed rcs={rcs}", flush=True)
        return None
    return json.loads([ln for ln in outs[0].splitlines()
                       if ln.startswith("{")][-1])


def main(argv):
    sys.path.insert(0, ROOT)
    from graph_embed_tpu_torch.utils.device import resolve

    args, opts = split_args(argv, device="cuda", out=OUT)
    device = str(resolve(opts["device"]))
    out = os.path.abspath(opts["out"])
    scale = args[0] if args else "17"
    work = os.path.join(CACHE_ROOT, f"dist_halo_rmat{scale}")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, DIST_HALO_SCALE=scale)
    recs = {}
    for nprocs, name in ((1, "single-process arm (1x8)"),
                         (2, "two-process arm (2x4)")):
        print(f"== {name}", flush=True)
        rec = run_arm(nprocs, work, out, device, env)
        if rec is None:
            return 1
        print(json.dumps(rec), flush=True)
        recs[nprocs] = rec
    same = recs[1]["coords_checksum"] == recs[2]["coords_checksum"]
    print(json.dumps({"checksums_equal": same,
                      "coords_checksum": [recs[1]["coords_checksum"],
                                          recs[2]["coords_checksum"]]}),
          flush=True)
    print(f"records appended to {out}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
