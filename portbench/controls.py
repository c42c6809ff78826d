"""Readings that set a cell's limits: the program on many seeds, the
control (the plain reference in the precision below the configuration's,
in the program's place) and each fault the cell can have, planted under
the timed path. Not part of a benchmark run.

    python3 portbench/controls.py --workload <cell> --seeds 12 \
        --control-seeds 3 --seconds 2 [--out chiprun_out/controls.jsonl]

Each line printed is one run: its kind, seed, ``correct`` and every
number compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, kinds, seconds: float, device,
             overrides=None, log=None):
    """Yield ``{"kind", "seed", "correct", "checks"}`` for each kind
    (``program``, ``control`` or a fault's name) on each seed."""
    from portbench import harness

    _, _, _, _, driver = harness.load_cell(cell)
    for kind, kind_seeds in kinds:
        patch = (None if kind == "program" else driver.CONTROL
                 if kind == "control" else driver.FAULTS[kind])
        for seed in kind_seeds:
            result, checks = harness.execute(
                cell, seed, seconds, False, device, patch=patch,
                overrides=overrides, log=log or (lambda *_: None))
            yield {"kind": kind, "seed": seed,
                   "correct": result["correct"],
                   "checks": {k: v["value"]
                              for k, v in result["checks"].items()},
                   "notes": {c.name: c.note for c in checks if c.note}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--kinds", default="program,control,faults")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _, _, _, _, driver = harness.load_cell(a.workload)
    wanted = a.kinds.split(",")
    s0 = a.first_seed
    kinds = []
    if "program" in wanted:
        kinds.append(("program", range(s0, s0 + a.seeds)))
    small = range(s0 + 1000, s0 + 1000 + a.control_seeds)
    if "control" in wanted:
        kinds.append(("control", small))
    if "faults" in wanted:
        kinds += [(name, small) for name in driver.FAULTS]
    out = open(a.out, "a") if a.out else None
    t0 = time.monotonic()
    for row in readings(a.workload, kinds, a.seconds, device):
        row["cell"] = a.workload
        row["elapsed_s"] = time.monotonic() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
