"""Where the time of the train step goes, on one GPU, by the program's spans.

    python -m pose2mesh_release_tpu_torch.tools.profile_train [--batch 64] [--steps 5]
        [--hand] [--dtype bfloat16|float32]

Builds the train step of `train_setup.smpl_train_setup` (`--hand`:
`mano_train_setup`; `--dtype` compute, bf16 by default, RMSprop at lr 1e-3, edge loss on) and the
eager step on the same model (`make_train_step(graph=False)`), warms both up
(the graphed step captures its CUDA graph), then:
  1. times `--steps` steps of each on the host clock, each ending in a
     synchronize, and `--steps` steps of each back to back with one
     synchronize at the end: the end-to-end metric "train step ms per
     batch"; prints `core.train.graph_counters`;
  2. traces `--steps` graphed steps with torch.profiler (the card's activity
     alone): the device ms a step by kernel name and the idle share, read
     from the replays of a graph captured before the profiler started;
  3. traces `--steps` steps with torch.profiler, the card's activity alone,
     with the program's spans on (`utils/profiling.py::trace(host=False)`),
     and puts each kernel, copy and set down to the span that launched it
     and each idle gap of the device to the span the host was in
     (`span_breakdown`).  Printed a step: the phases (network forward =
     `p2m.posenet` + `p2m.meshnet`, losses = `p2m.losses`, backward =
     `p2m.backward` with what autograd's thread ran under it, optimizer =
     `p2m.optimizer`); K1 = all that `p2m.band_conv` launched, K2 = all that
     `p2m.band_conv.bwd` launched, beside the time of K1's and K2's kernels
     by name; the dense convs = all that `p2m.dense_conv` launched (the
     basis kernel and the projection), their backward = all that
     `p2m.dense_conv.bwd` launched, and `ops/dense_cheby.launches` a step;
     the spans by their own device and idle ms; the launches inside
     `p2m.step`; the device's idle share.  The spans on, these steps run
     eagerly (a replay launches no span).
Needs a CUDA device; writes chiprun_out/profile_train.json (bf16) or
chiprun_out/profile_train_float32.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from ..core.train import graph_counters, make_train_step
from ..ops import dense_cheby
from ..train_setup import mano_train_setup, smpl_train_setup
from ..utils.profiling import STEP, profile_spans, span_breakdown

LR = 1e-3
# kernel-name groups of the device time (the names K1's and K2's CUDA sources give)
GROUPS = (("K1 kernels", ("cheby_proj_kernel", "cheby_proj_f32_kernel", "fold_kernel",
                          "reduce_partials")),
          ("K2 kernels", ("bwd_dx_kernel", "bwd_dw_kernel", "bwd_dx_f32_kernel",
                          "bwd_dw_f32_kernel", "dw_reduce_kernel")),
          ("hop engine (K1 and K2)", ("band_hop_kernel", "band_hop_f32")),
          ("dense basis", ("dense_cheby_kernel",)),
          ("matrix products", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))
PHASES = (("network forward", ("p2m.posenet", "p2m.meshnet")),
          ("extract_mesh and regressor", ("p2m.extract_mesh", "p2m.regressor")),
          ("losses", ("p2m.losses",)),
          ("backward", ("p2m.backward",)),
          ("optimizer", ("p2m.optimizer",)),
          ("K1 (p2m.band_conv)", ("p2m.band_conv",)),
          ("K2 (p2m.band_conv.bwd)", ("p2m.band_conv.bwd",)),
          ("dense convs (p2m.dense_conv)", ("p2m.dense_conv",)),
          ("dense backward (p2m.dense_conv.bwd)", ("p2m.dense_conv.bwd",)))


def _group(name: str, groups=GROUPS) -> str:
    low = name.lower()
    return next((g for g, pats in groups if any(p in low for p in pats)), "other")


def graphed_trace(step, n: int, groups=GROUPS) -> dict:
    """n replays of a graphed step under torch.profiler, the card's
    activity alone and no spans (with them on the step runs eagerly), read
    by `span_breakdown`: device ms a step by kernel-name group (`groups`),
    operations a step, the idle share of the window from the first
    operation to the last."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            b = span_breakdown(json.load(f)["traceEvents"])
    by_group = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    for name, us in b.ops_us.items():
        by_group[_group(name, groups)] += us / 1e3 / n
    return {"device_ms_per_step": b.busy_us / 1e3 / n,
            "operations_per_step": sum(b.ops_calls.values()) / n,
            "idle_share": 1.0 - b.busy_us / b.window_us if b.window_us else None,
            "groups_ms_per_step": by_group}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--hand", action="store_true", help="the MANO hand's train step")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    n = args.steps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    setup = mano_train_setup if args.hand else smpl_train_setup
    s = setup(dtype=getattr(torch, args.dtype), device="cuda", seed=0, batch=args.batch)
    state = s.state
    eager_step = make_train_step(state.model, state.optimizer, s.j_regressor, device="cuda",
                                 graph=False)
    steps = {"graphed": s.train_step, "eager": eager_step}

    def step(kind="graphed"):
        nonlocal state
        state, _ = steps[kind](state, s.art_compute, s.batch, LR, True, s.generator)

    for kind in steps:
        for _ in range(3):
            step(kind)
    torch.cuda.synchronize()

    walls, back_to_back = {}, {}
    for kind in steps:
        walls[kind] = []
        for _ in range(n):
            t0 = time.perf_counter()
            step(kind)
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(n):
            step(kind)
        torch.cuda.synchronize()
        back_to_back[kind] = (time.perf_counter() - t0) * 1e3 / n
    counters = dict(graph_counters)
    graphed = graphed_trace(lambda: step("graphed"), n)

    traced = {}
    dense_before = dict(dense_cheby.launches)

    def run():
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        traced["ms"] = (time.perf_counter() - t0) * 1e3
    b = profile_spans(run)
    if b.steps != n:
        raise SystemExit(f"profile_train: {b.steps} {STEP} spans in the trace, expected {n}")
    groups = dict.fromkeys([g for g, _ in GROUPS] + ["other"], 0.0)
    for name, us in b.ops_us.items():
        groups[_group(name)] += us / 1e3 / n
    phases = {p: sum(b.per_step(b.device_us_inclusive, k) for k in spans) / 1e3
              for p, spans in PHASES}
    device_ms = b.busy_us / 1e3 / n
    dense_calls = {k: (dense_cheby.launches[k] - dense_before[k]) / n for k in dense_before}
    result = {
        "card": card, "model": "mano" if args.hand else "smpl", "dtype": args.dtype,
        "batch": args.batch,
        "steps": n, "lr": LR,
        "wall_ms_per_step": walls["graphed"],
        "eager_wall_ms_per_step": walls["eager"],
        "back_to_back_ms_per_step": back_to_back,
        "graph_counters": counters,
        "graphed_trace": graphed,
        "traced_wall_ms_per_step": traced["ms"] / n,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - b.busy_us / b.window_us if b.window_us else None,
        "phases_device_ms_per_step": phases,
        "dense_cheby_launches_per_step": dense_calls,
        "kernel_groups_ms_per_step": groups,
        "spans": b.summary(),
        "top_kernels_ms_per_step": [(k, us / 1e3 / n) for k, us in
                                    sorted(b.ops_us.items(), key=lambda kv: -kv[1])[:15]],
    }
    print(card)
    print(f"{result['model']} train step, {args.dtype}, batch {args.batch}")
    for kind in steps:
        print(f"{kind} wall ms per step: {[round(w, 3) for w in walls[kind]]}; back to back "
              f"{back_to_back[kind]:.3f}")
    print(f"graph_counters: {counters}")
    print(f"graphed steps traced (CUDA activity alone): device ms per step "
          f"{graphed['device_ms_per_step']:.3f}, idle share {graphed['idle_share']}, "
          f"operations a step {graphed['operations_per_step']:.1f}; by kernel name "
          f"{ {g: round(ms, 3) for g, ms in graphed['groups_ms_per_step'].items()} }")
    print(f"eager steps with the spans on: traced wall {result['traced_wall_ms_per_step']:.3f}")
    print(f"device ms per step: {device_ms:.3f}; idle share of the traced window: "
          f"{result['device_idle_share']}")
    print("device ms a step by phase (all the phase's spans launched):")
    for name, ms in phases.items():
        print(f"  {name:40s} {ms:8.3f} ms")
    print(f"ops/dense_cheby.launches a step (eager, spans on): {dense_calls}")
    print("device ms a step by kernel name:")
    for name, ms in groups.items():
        print(f"  {name:40s} {ms:8.3f} ms")
    print(json.dumps({"spans": result["spans"]}))
    for key, ms in result["top_kernels_ms_per_step"]:
        print(f"  {ms:8.3f} ms  {key[:100]}")
    if device_ms == 0:
        print("the profiler recorded no device time: device breakdown not measured")
    os.makedirs("chiprun_out", exist_ok=True)
    name = "profile_train" + ("" if args.dtype == "bfloat16" else f"_{args.dtype}")
    with open(os.path.join("chiprun_out", f"{name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
