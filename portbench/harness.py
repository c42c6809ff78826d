"""The benchmark's driver-independent part: find a cell by name, set it
up, run its window, judge it, reduce its trace and print the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything
that belongs to one cell, configuration or metric is a file of its own,
found by name:

* ``portbench/workloads/<cell>.json``: the traffic driver's name and
  its parameters;
* ``portbench/configs/<config>.json``: the net's constructor arguments,
  ``source``, ``assumed`` and ``reduced``;
* ``portbench/drivers/<driver>.py``: one module per kind of traffic,
  with ``setup``, ``window``, ``release`` and ``check``;
* ``portbench/metrics/<metric>.py``: one reader per per-layer metric,
  ``read(reading) -> float | None``.

So a later cell, configuration or metric adds files and edits none.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from portbench import trace as tracelib

#: when torch had been imported (the set-up's first part ends here)
T_IMPORTED = time.monotonic()

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax",
                     "rocalphago_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with its limit; passes at ``value <=
    limit`` (every number is a gap, a count of faults or a share)."""

    name: str
    value: float
    limit: float
    note: str = ""

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


class RunContext:
    """What a driver sees of a run: the seed, the window's length, the
    cell's parameters and configuration, the device, the set-up clock
    and the tracer."""

    def __init__(self, cell: dict, workload: dict, config: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t_start: float, patch: dict | None = None):
        self.cell = cell
        self.workload = workload
        self.params = workload["params"]
        self.config = config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.t_start = t_start
        self.setup_parts: dict[str, float] = {}
        self._lap = t_start
        self.counters: dict[str, float] = {}
        self.tracer = tracelib.Tracer(trace, device,
                                      int(workload.get("trace_skip", 2)),
                                      int(workload.get("trace_units", 10)))
        self.patch = patch or {}

    def seam(self, name: str, obj, **context):
        """``obj``, or what a fault or the control puts in its place
        (built from ``obj`` and the driver's ``context``)."""
        fault = self.patch.get(name)
        return obj if fault is None else fault(obj, **context)

    def lap(self, part: str) -> None:
        """Close the set-up part ``part`` at now (synchronised)."""
        sync(self.device)
        now = time.monotonic()
        self.setup_parts[part] = self.setup_parts.get(part, 0.0) + (
            now - self._lap)
        self._lap = now

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the run's device seeded from ``--seed`` and a
        stream number, so each use draws its own sequence."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (2**63 - 1))
        return g

    def span(self, name: str):
        return self.tracer.span(name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """``(cell, workload, config, driver module)`` of the cell
    ``name``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    workload = load_json(os.path.join(PKG, "workloads", f"{name}.json"))
    driver = importlib.import_module(
        f"portbench.drivers.{workload['driver']}")
    return bench, cell, workload, config, driver


def load_reader(metric: str):
    """The reader module of a per-layer metric (its file name is the
    metric's name, dots and all)."""
    path = os.path.join(PKG, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, which: str) -> list[dict]:
    """The end-to-end (``which="end_to_end"``) or per-layer metrics
    that cell ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if which == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def forbidden_loaded() -> list[str]:
    """The forbidden top-level module names present in this process."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def execute(name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float | None = None,
            patch: dict | None = None, overrides: dict | None = None,
            root: str = ROOT, log=print, parts: dict | None = None):
    """Run the cell ``name`` once on ``device``; returns ``(result,
    checks)``. ``overrides`` replaces workload parameters and
    configuration keys (``{"params": {...}, "config": {...}}``: the
    tests' small sizes); ``patch`` plants faults at a driver's seams."""
    t_start = time.monotonic() if t_start is None else t_start
    bench, cell, workload, config, driver = load_cell(name, root)
    if overrides:
        workload = dict(workload, params=dict(
            workload["params"], **overrides.get("params", {})))
        config = _merge(config, overrides.get("config", {}))
    run = RunContext(cell, workload, config, seed, seconds, trace, device,
                     t_start, patch)
    for part, (t0, t1) in (parts or {}).items():
        run.setup_parts[part] = t1 - t0
        run._lap = t1
    live = driver.setup(run)
    sync(device)
    setup_s = time.monotonic() - t_start
    log("setup_parts " + json.dumps(
        {k: v for k, v in run.setup_parts.items()}))
    window = driver.window(live, run)
    log("window " + json.dumps(dict(run.counters,
                                    window_s=window["seconds"])))
    if trace:
        # the traced units run after the window closes, so the window
        # is the same with and without the profiler
        run.tracer.arm()
        driver.traced(live, run)
        run.tracer.finish()
        log(f"traced: {run.tracer.count} units after the window")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    evidence = driver.release(live)
    del live
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks = driver.check(evidence, run)
    log(f"check_seconds {time.monotonic() - t_check:.3f}")
    counters = dict(run.counters, window_s=window["seconds"])
    if trace:
        summary = run.tracer.summary()
        reading = Reading(cell, workload, config, counters, summary)
        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        summary = None
        values = dict(window["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell_metrics(bench, name, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    correct = all(c.ok for c in checks)
    result = {"correct": correct, "attempted": int(window["attempted"]),
              "failed": sum(not c.ok for c in checks),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the cell, its parameters and
    configuration, the window's counters (``window_s`` among them) and
    the traced window's summary."""

    cell: dict
    workload: dict
    config: dict
    counters: dict
    trace: tracelib.TraceSummary | None


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench, cell, _, _, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on a "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t_cuda = time.monotonic()
    torch.cuda.set_device(device)
    torch.cuda.init()
    torch.empty(1, device=device)
    t_card = time.monotonic()
    print(f"card {card_limit()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    parts = {"python_and_torch_import": (t_start, T_IMPORTED),
             "cuda_init": (t_cuda, t_card),
             "card_query": (t_card, time.monotonic())}
    result, checks = execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, t_start,
                             parts=parts)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'} {c.note}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convolutions in full float32 inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
