"""The benchmark of graph_embed_tpu_torch: one cell, one run, one line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one cell is found by name, from
``BENCHMARK.json`` at the checkout's root:

* the cell's configuration: its ``file`` (under ``portbench/configs/``),
  whose ``generator`` names ``portbench/generators/<generator>.py``, which
  draws the graph on the device from the seed;
* the cell's traffic: ``portbench/traffic/<traffic>.json``, whose
  ``driver`` names ``portbench/drivers/<driver>.py``, which sets the
  program up, runs the measured window, checks what the window produced
  against a plain reference (``portbench/reference/``) and returns a
  ``Run``;
* each per-layer metric: ``portbench/metrics/<name>.py``, whose
  ``read(record)`` takes the metric from the driver's record (spans,
  counters, the profiler's kernel times) or returns None when the record
  holds nothing for it.

So a later cell, configuration, mix or per-layer metric is new files plus
entries in ``BENCHMARK.json``; no file here changes.  A run with
``--trace 0`` reports the cell's end-to-end metrics, one with ``--trace
1`` its per-layer metrics; both check what the window produced.  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last
key.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

#: top-level module names that no run may hold once its window has closed
BANNED_MODULES = ("jax", "jaxlib", "flax", "graph_embed_tpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only where ``value <= limit`` (a NaN is never within)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Run:
    """What a driver returns.  ``end_to_end``: metric name -> value;
    ``record``: the raw readings the per-layer readers take; ``busy_s`` /
    ``window_s``: the card's busy seconds and the traced window's
    seconds (a traced run only); ``breakdown``: ``device_ops`` and
    ``idle_gaps`` (a traced run only)."""

    end_to_end: dict
    attempted: int
    failed: int
    checks: list
    memory_peak_bytes: int
    record: dict
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict      # the configuration's file, as run
    traffic: dict     # the traffic mix's file
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    time the process started and the checkout's root (for its files)."""

    root: str
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def graph(self) -> dict:
        """The configuration's graph, drawn on the device by its generator
        from the configuration's own ``seed`` (one graph per
        configuration, as a data set is one file; ``--seed`` draws what
        runs on it): {"n", "senders", "receivers"} (unit weights, both
        directions stored, sorted by (sender, receiver)).  The reference
        draws it again."""
        cfg = self.cell.config
        gen = load_module(self.root, "generators", cfg["generator"])
        return gen.build(cfg, derive_seed(cfg["seed"], 0), self.device)


def gap(got, want, scale) -> float:
    """max |got - want| / scale over every element, in float64; NaN where
    ``got`` is not finite (the comparison every check makes)."""
    import torch

    got, want, scale = (torch.as_tensor(a).to(torch.float64)
                        for a in (got, want, scale))
    return float(((got - want).abs() / torch.clamp(scale, min=1e-30)).max())


def worst(*values: float) -> float:
    """The largest value, NaN where any is NaN."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def note(ctx: "Context", what: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    print(f"portbench: {time.perf_counter() - ctx.t0:.3f} s {what}",
          file=sys.stderr, flush=True)


def derive_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run (graph, coordinates, ...),
    so two generators of one run never draw the same numbers."""
    import numpy as np

    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_module(root: str, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root`` as a module (names may
    hold dots and dashes, so it is loaded by path)."""
    path = os.path.join(root, "portbench", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def resolve(root: str, workload: str) -> Cell:
    """The cell named ``workload`` in ``root``'s BENCHMARK.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _in_cell(m, workload, reported)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None
    where nvidia-smi is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             traffic: dict | None = None) -> dict:
    """Run one cell once and return its result line (a dict).  ``device``
    "cpu" runs the plain versions (tests at small sizes only);
    ``traffic`` replaces entries of the mix (the control's lower
    precision, ``control.py``)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = resolve(root, workload)
    if traffic:
        cell.traffic = {**cell.traffic, **traffic}
    ctx = Context(root=root, cell=cell, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t0=t0)
    driver = load_module(root, "drivers", cell.traffic["driver"])
    run: Run = driver.run(ctx)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_module(root, "metrics", m["name"]).read(run.record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in run.end_to_end]
        if missing:
            raise RuntimeError(f"driver {cell.traffic['driver']!r} gave no "
                               f"{missing}")
        metrics = {m["name"]: {"value": float(run.end_to_end[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    on_card = device != "cpu"
    import torch

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if on_card:
        dev["power_limit"] = power_limit()
    if trace and run.busy_s is not None:
        dev["busy_s"] = float(run.busy_s)
        dev["window_s"] = float(run.window_s)
    correct = (bool(run.checks) and all(c.ok for c in run.checks)
               and all(math.isfinite(v["value"]) for v in metrics.values()))
    line = {"correct": correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.breakdown is not None:
        line["breakdown"] = run.breakdown
    line["checks"] = {c.name: {"value": float(c.value),
                               "limit": float(c.limit)}
                      for c in run.checks}
    return line


def banned_loaded() -> list[str]:
    """The banned top-level names that ``sys.modules`` holds, compared
    whole (``graph_embed_tpu_torch`` is not ``graph_embed_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(BANNED_MODULES))


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell of "
                                 "graph_embed_tpu_torch once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(ROOT, args.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {cards}", file=sys.stderr)
        return 2
    line = run_cell(ROOT, args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", t0)
    found = banned_loaded()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
