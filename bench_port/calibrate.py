"""The readings that a cell's limits are set from, in one process:

    python3 -m bench_port.calibrate --workload <cell> --seconds 1 \
        --seeds <n> ... [--control-seeds <n> ...] [--fault-seeds <n> ...]

Each seed runs the cell as `run.py` does, with a short window: the program
(the lower readings), the control (the reference in the nearest precision
below the configuration's, fp8, put in the program's place: `control.py`)
and, for a training cell, the planted fault "half of the batch left out,
the mean taken over the rest" in the reference put in the program's place.
Prints one JSON line a run (its numbers, and for a training cell its five
worst leaves of each number), then each number's lower reading (the
program's largest) and upper reading (the least of the control's and the
fault's).  For a loader-fed training cell (kind "train_loader") the control
and the faults replace the train step alone (the port's loader still feeds
them), and one more fault, the loader's mesh targets moved one row on
(`control.RolledTargets`), reads the data layer's own check.  A state left
unchanged reads 1 on the training cells' gradient
and change numbers, and a loss altered by a fifth where it is produced reads
0.2 on loss_gap, by construction: neither needs a run.  Writes the lines to
chiprun_out/calibrate_<cell>.jsonl as well.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from . import harness
from .control import RefServe, RefTrain, RolledTargets


def _leaves(prog, ref, n=5):
    """The five worst moving leaves of the gradient and the change, each
    check step's loss gap, each part's gap of the first step's loss, and the
    leaves left out."""
    moving = harness.moving_leaves(ref["grad"])
    out = {"left_out": sorted(set(ref["grad"]) - set(moving)),
           "step_loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                                 ref["losses"])]}
    for key in ("grad", "change"):
        gaps = harness._leaf_gaps(prog[key], ref[key], moving)
        out[key] = sorted(zip(gaps, moving), reverse=True)[:n]
    out["parts_gaps"] = {k: abs(prog["parts"][k] - ref["parts"][k]) / abs(ref["parts"][k])
                         for k in ref["parts"] if ref["parts"][k]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["kind"]
    detail = {}
    compare = harness.compare_train

    def spy(prog, ref):
        detail["leaves"] = _leaves(prog, ref)
        return compare(prog, ref)
    harness.compare_train = spy

    runs = [("program", s, {}) for s in args.seeds]
    if kind == "serve":
        runs += [("control_fp8", s, {"serve_factory": RefServe}) for s in args.control_seeds]
    else:
        runs += [("control_fp8", s, {"train_factory": RefTrain}) for s in args.control_seeds]
        runs += [("fault_half_batch", s, {"train_factory": lambda *a: RefTrain(
            *a, precision="f32", fault="half_batch")}) for s in args.fault_seeds]
    if kind == "train_loader":
        runs += [("fault_rolled_targets", s, {"data_factory": RolledTargets})
                 for s in args.fault_seeds]
    os.makedirs("chiprun_out", exist_ok=True)
    readings = {}
    with open(os.path.join("chiprun_out", f"calibrate_{args.workload}.jsonl"), "a") as f:
        for who, seed, kw in runs:
            detail.clear()
            t = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, device, t0=t,
                                   log=lambda *a: print(*a, file=sys.stderr, flush=True), **kw)
            run = res["run"]
            line = {"who": who, "seed": seed,
                    "numbers": {k: c["value"] for k, c in res["checks"].items()},
                    "attempted": res["attempted"], "failed": res["failed"],
                    "metrics": harness.read_metrics(run, cell.end_to_end),
                    "seconds": time.perf_counter() - t, **detail}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            readings.setdefault(who, []).append(line["numbers"])
            torch.cuda.empty_cache()
    for k in (readings.get("program") or [{}])[0]:
        lower = max(r[k] for r in readings["program"])
        uppers = {w: min(r[k] for r in rs) for w, rs in readings.items() if w != "program"}
        up = min(uppers.values()) if uppers else math.nan
        print(f"{k}: lower {lower!r} upper {up!r} {uppers}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
