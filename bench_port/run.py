"""The port's benchmark: one run of one cell on the card it is started on.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with as many CUDA cards as
the cell asks for.  Set-up (process start to the first timed request:
imports, the port's pyramid packing and weight loading, the kernels'
build on a checkout's first run, warm-up) is `setup_s`; then the window of
`--seconds`; with `--trace 1` a traced segment after it; then the
comparison with the plain reference, once the program's state is freed.
The last line of standard output is the result (one JSON object); the last
lines of standard error are each number compared beside its limit.  Exits
non-zero, printing no result, without CUDA or the cards the cell needs, if
the port is not the checkout's own, or if JAX or the JAX package is loaded.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"   # one process, few threads: steadier host times

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pose2mesh_release_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _num(v: float):
    """A number for the JSON line; one that is not finite as its name."""
    return v if math.isfinite(v) else repr(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from .system import port_root
    if port_root() != root.resolve():
        print(f"the port is imported from {port_root()}, not from this checkout {root}",
              file=sys.stderr)
        return 2
    from .harness import load_cell, read_metrics, run_cell

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = load_cell(args.workload, manifest)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t0=T0,
                   log=lambda *a: print(*a, file=sys.stderr, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    run = res["run"]
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = read_metrics(run, entries)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": all(c["ok"] for c in res["checks"].values()) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "device": device_info}
    if args.trace and run.trace is not None:
        s = run.trace
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        out["breakdown"] = {"device_ops": s.top(s.device_ops), "idle_gaps": s.top(s.gaps)}
        w = run.window
        print(json.dumps({"trace_overhead": {
            "untraced_s_per_step": w.seconds / max(w.requests, 1),
            "traced_s_per_step": s.window_s / max(s.steps, 1)}}), flush=True)
    print(json.dumps({"launches_per_step": run.launches_per_step}), flush=True)
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                     for k, c in res["checks"].items()}
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
