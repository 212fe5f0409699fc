"""Where the time of the SMPL deploy forward goes, on one GPU.

    python -m pose2mesh_release_tpu_torch.tools.profile_forward [--batch 64]
        [--flat-impl group|strip|window] [--unfused] [--dtype bfloat16|float32]

Builds the deploy forward of `deploy.smpl_deploy_forward` (`--dtype`, bf16 by
default; float32 takes the kernels' float32 instances) on the
chosen path (the band convs' kernels: `--flat-impl`, or `--unfused` for two
hops and three projections per conv) and the eager eval step on the same
model (`make_eval_step(graph=False)`), warms both up (the graphed step
captures its CUDA graph), then:
  1. times `--steps` forwards of each on the host clock, each ending in a
     synchronize (as a closed-loop client waits), and `--steps` back to back
     with one synchronize at the end; prints the eval step's
     `core.train.graph_counters`;
  2. traces `--steps` replays of the graphed forward with torch.profiler
     (the card's activity alone): device ms a forward by kernel group,
     operations a forward, the idle share;
  3. traces `--steps` forwards with the program's spans on (which run
     eagerly: a replay launches no span; `utils/profiling.py::trace(host=
     False)`) and prints the device time per forward by kernel, grouped into
     the port's band kernels, matrix products and the rest, the CUDA
     launches per forward of each group, all that `p2m.band_conv` launched,
     all that `p2m.dense_conv` launched (the dense levels' basis kernel and
     projection) and `ops/dense_cheby.launches` a forward, the spans by
     their own device and idle ms (`span_breakdown`), and the device's idle
     share of the traced window.
Needs a CUDA device; writes chiprun_out/profile_forward.json (the group
path, bf16) or chiprun_out/profile_forward[_<path>][_float32].json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..core.train import graph_counters, make_eval_step
from ..deploy import smpl_deploy_forward
from ..ops import dense_cheby
from ..utils.profiling import profile_spans
from .profile_train import graphed_trace

GROUPS = (("band kernels", ("band_hop_kernel", "band_hop_f32", "cheby_proj_kernel",
                            "cheby_proj_f32_kernel")),
          ("dense basis", ("dense_cheby_kernel",)),
          ("matrix products", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--flat-impl", choices=("group", "strip", "window"), default="group")
    ap.add_argument("--unfused", action="store_true",
                    help="fused=False: each band conv as two hops and three projections")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if args.unfused and args.flat_impl != "group":
        ap.error("--unfused takes no fused kernels: leave --flat-impl at group")
    path = "unfused" if args.unfused else args.flat_impl
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    d = smpl_deploy_forward(dtype=getattr(torch, args.dtype), device="cuda", seed=0,
                            flat_impl=args.flat_impl, fused=not args.unfused)
    g = torch.Generator().manual_seed(1)
    pose2d = torch.randn(args.batch, 17, 2, generator=g).cuda()
    steps = {"graphed": d.eval_step,
             "eager": make_eval_step(d.model, d.j_regressor, device="cuda", graph=False)}
    for step in steps.values():
        for _ in range(3):
            step(d.art_compute, pose2d)
    torch.cuda.synchronize()

    walls, back_to_back = {}, {}
    for kind, step in steps.items():
        walls[kind] = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step(d.art_compute, pose2d)
            torch.cuda.synchronize()
            walls[kind].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(d.art_compute, pose2d)
        torch.cuda.synchronize()
        back_to_back[kind] = (time.perf_counter() - t0) * 1e3 / args.steps
    counters = {k: v for k, v in graph_counters.items() if k.startswith("eval.")}
    graphed = graphed_trace(lambda: d.eval_step(d.art_compute, pose2d), args.steps, GROUPS)

    traced = {}
    dense_before = dense_cheby.launches["dense_cheby_stack"]

    def run():
        t0 = time.perf_counter()
        for _ in range(args.steps):
            d.eval_step(d.art_compute, pose2d)
        torch.cuda.synchronize()
        traced["ms"] = (time.perf_counter() - t0) * 1e3
    b = profile_spans(run)
    traced_ms = traced["ms"]
    dense_calls = (dense_cheby.launches["dense_cheby_stack"] - dense_before) / args.steps
    kernels, counts = b.ops_us, b.ops_calls
    device_ms = b.busy_us / 1e3 / args.steps
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    group_launches = dict.fromkeys(groups, 0.0)
    for key, us in kernels.items():
        low = key.lower()
        name = next((n for n, pats in GROUPS if any(p in low for p in pats)), "other")
        groups[name] += us / 1e3 / args.steps
        group_launches[name] += counts[key] / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "card": card, "path": path, "dtype": args.dtype, "batch": args.batch, "steps": args.steps,
        "wall_ms_per_forward": walls["graphed"],
        "eager_wall_ms_per_forward": walls["eager"],
        "back_to_back_ms_per_forward": back_to_back,
        "graph_counters": counters,
        "graphed_trace": graphed,
        "traced_wall_ms_per_forward": traced_ms / args.steps,
        "device_ms_per_forward": device_ms,
        "device_idle_share": 1.0 - b.busy_us / b.window_us if b.window_us else None,
        "groups_ms_per_forward": groups,
        "groups_launches_per_forward": group_launches,
        "band_conv_spans_ms_per_forward": b.per_step(b.device_us_inclusive,
                                                     "p2m.band_conv") / 1e3,
        "dense_conv_spans_ms_per_forward": b.per_step(b.device_us_inclusive,
                                                      "p2m.dense_conv") / 1e3,
        "dense_cheby_launches_per_forward": dense_calls,
        "spans": b.summary(),
        "top_kernels_ms_per_forward": [(k, us / 1e3 / args.steps) for k, us in top],
    }
    print(card)
    print(f"path {path}, {args.dtype}")
    for kind in steps:
        print(f"{kind} wall ms per forward: {[round(w, 3) for w in walls[kind]]}; back to "
              f"back {back_to_back[kind]:.3f}")
    print(f"graph_counters: {counters}")
    print(f"graphed forwards traced (CUDA activity alone): device ms per forward "
          f"{graphed['device_ms_per_step']:.3f}, idle share {graphed['idle_share']}, "
          f"operations a forward {graphed['operations_per_step']:.1f}; by kernel group "
          f"{ {k: round(ms, 3) for k, ms in graphed['groups_ms_per_step'].items()} }")
    print(f"eager forwards with the spans on: traced wall {traced_ms / args.steps:.3f}")
    print(f"device ms per forward: {device_ms:.3f}; idle share of the traced "
          f"window: {result['device_idle_share']}")
    for name, ms in groups.items():
        print(f"  {name:16s} {ms:8.3f} ms in {group_launches[name]:g} launches")
    print(f"  all that p2m.band_conv launched {result['band_conv_spans_ms_per_forward']:.3f} ms")
    print(f"  all that p2m.dense_conv launched {result['dense_conv_spans_ms_per_forward']:.3f} ms; "
          f"ops/dense_cheby.launches a forward {dense_calls:g}")
    print(json.dumps({"spans": result["spans"]}))
    for key, ms in result["top_kernels_ms_per_forward"]:
        print(f"  {ms:8.3f} ms  {key[:100]}")
    if device_ms == 0:
        print("the profiler recorded no device time: device breakdown not measured")
    os.makedirs("chiprun_out", exist_ok=True)
    name = ("profile_forward" + ("" if path == "group" else f"_{path}")
            + ("" if args.dtype == "bfloat16" else f"_{args.dtype}"))
    with open(os.path.join("chiprun_out", f"{name}.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
