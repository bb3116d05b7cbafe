"""The control of a cell's ``correct``: the cell run with its traffic's
``control`` entries in place, which must come out not correct: for
``flat`` the program's own bf16-gather path (``x_precision="bf16"``, the
nearest precision below the float32 the configuration states), for
``embed`` the reference computed in bfloat16 in the program's place.

    python3 portbench/control.py --workload lj-rmat24.flat \
        --seeds 11,12,13 --seconds 2 [--program]

prints one line per seed with the numbers compared and their limits,
then a summary line; exit 0 when every control run is not correct.
``--program`` runs the seeds without the control instead (the lower
readings; exit 0 when every run is correct).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import harness  # noqa: E402


def readings(root: str, workload: str, seeds, seconds: float,
             device: str = "cuda", control: bool = True) -> list[dict]:
    """One result line per seed, with the control in place unless
    ``control`` is False."""
    cell = harness.resolve(root, workload)
    override = cell.traffic["control"] if control else None
    return [harness.run_cell(root, workload, s, seconds, False, device,
                             traffic=override) for s in seeds]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = not args.program
    lines = []
    for seed in seeds:
        line, = readings(harness.ROOT, args.workload, [seed], args.seconds,
                         control=control)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "device": line["device"]}), flush=True)
        lines.append(line)
    ok = all(line["correct"] != control for line in lines)
    print(json.dumps({"control": control, "as_expected_on_every_seed": ok,
                      "at": time.strftime("%Y-%m-%d %H:%M:%S")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
