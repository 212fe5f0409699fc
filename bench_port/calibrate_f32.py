"""The readings that a float32 cell's limits are set from, in one process:

    python3 -m bench_port.calibrate_f32 --workload <cell> --seconds 1 \
        --seeds <n> ... [--control-seeds <n> ...] [--fault-seeds <n> ...]

As `calibrate.py`, with the float32 configuration's own control and faults
(`control_tf32.py`): the program (the lower readings); the control, the
reference with TF32 on for its dense products; the fault "the port at
bf16 in the float32 cell's place" and, for a training cell, the fault "half
of the batch left out" (`calibrate.py`'s).  Prints one JSON line a run, with
the limits that caught it where the cell has limits, then each number's
lower reading (the program's largest) and the least reading of each control
and fault.  Writes the lines to chiprun_out/calibrate_<cell>.jsonl as well.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import harness
from .calibrate import _leaves
from .control import RefTrain
from .control_tf32 import Tf32Serve, Tf32Train, bf16_serve, bf16_train


def _runs(kind: str, args) -> list:
    factory = "serve_factory" if kind == "serve" else "train_factory"
    runs = [("program", s, {}) for s in args.seeds]
    runs += [("control_tf32", s, {factory: Tf32Serve if kind == "serve" else Tf32Train})
             for s in args.control_seeds]
    runs += [("fault_bf16_port", s, {factory: bf16_serve if kind == "serve" else bf16_train})
             for s in args.fault_seeds]
    if kind == "train":
        runs += [("fault_half_batch", s, {factory: lambda *a: RefTrain(
            *a, precision="f32", fault="half_batch")}) for s in args.fault_seeds]
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate_f32: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    detail = {}
    compare = harness.compare_train

    def spy(prog, ref):
        detail["leaves"] = _leaves(prog, ref)
        return compare(prog, ref)
    harness.compare_train = spy

    os.makedirs("chiprun_out", exist_ok=True)
    readings = {}
    with open(os.path.join("chiprun_out", f"calibrate_{args.workload}.jsonl"), "a") as f:
        for who, seed, kw in _runs(cell.traffic["kind"], args):
            detail.clear()
            t = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, device, t0=t,
                                   log=lambda *a: print(*a, file=sys.stderr, flush=True), **kw)
            line = {"who": who, "seed": seed,
                    "numbers": {k: c["value"] for k, c in res["checks"].items()},
                    "caught_by": sorted(k for k, c in res["checks"].items()
                                        if not c["ok"]) if cell.limits else None,
                    "attempted": res["attempted"], "failed": res["failed"],
                    "metrics": harness.read_metrics(res["run"], cell.end_to_end),
                    "memory_peak_bytes": res["memory_peak_bytes"],
                    "seconds": time.perf_counter() - t, **detail}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            readings.setdefault(who, []).append(line["numbers"])
            torch.cuda.empty_cache()
    for k in (readings.get("program") or [{}])[0]:
        lower = max(r[k] for r in readings["program"])
        least = {w: min(r[k] for r in rs) for w, rs in readings.items() if w != "program"}
        print(f"{k}: lower {lower!r} least of the others {least}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
