"""Kernel times of several checkouts in turns on one GPU: an A/B of the
kernels between commits within one call, on one card.

    python -m pose2mesh_release_tpu_torch.tools.kernel_ab PARENT . . PARENT [--f32]

Each argument is a checkout of this repository (a directory holding
`chip_smoke.py` and the package, e.g. the parent commit unpacked with
`git archive`); they run in the order given, each in its own process from
its own directory, building its kernels into its own `build/`.  Each run
times the kernel rows of chip_smoke's phases 2 and 4 at the SMPL main
path's shapes (batch 64, bf16: the group and commuted deploy convs, the
hop K4, the strip and window convs, K1, K2, K1 with keep_basis), and with
`--f32` also the rows of the float32 instances (phase 14: each kernel's
that the checkout has; K4, K5 and K6 only where its chip_smoke checks them
in float32), with that checkout's own code.  Prints the card's name, power limit, SM clock, power
draw and temperature before and after each run, then one line
`AB {"tree", "ok", "ms": {kernel: ms summed over one pass}, "splits":
{kernel: {launch: ms summed over one pass}}, "rows": {"tag kernel": ms}}`
(the splits: each kernel's launches apart, chip_smoke's split_ms; the
float32 GEMM splits among them).  A run that
fails a kernel check exits non-zero.  Needs the card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

# run in the checkout's directory: its chip_smoke and its package
ROWS = r"""
import json, os, subprocess, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from pose2mesh_release_tpu_torch.deploy import smpl_deploy_forward
from pose2mesh_release_tpu_torch.ops import _build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
SMI = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,temperature.gpu",
       "--format=csv,noheader"]
print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip(), flush=True)
_build.build_all()
by_v = {op.num_vertices: op
        for op in smpl_deploy_forward(dtype=torch.bfloat16, device="cuda", seed=0).art.mesh_ops}
gen = torch.Generator(device="cuda").manual_seed(0)
convs = list(enumerate(cs.MAIN_PATH_CONVS))
rows = [cs.check_conv(by_v[V], n, fi, fo, ep, gen, f"main{i}") for i, (V, n, fi, fo, ep) in convs]
rows += [cs.check_hop(by_v[V], fi, gen, f"hop{i}") for i, (V, _, fi, _, _) in convs]
rows += [cs.check_strip(by_v[V], fi, fo, ep, gen, f"strip{i}")
         for i, (V, _, fi, fo, ep) in convs]
rows += [cs.check_window(by_v[V], fi, fo, ep, gen, f"window{i}")
         for i, (V, _, fi, fo, ep) in convs]
for i, (V, fi, fo, fold, stats) in enumerate(cs.TRAIN_CONVS):
    rows += cs.check_train_conv(by_v[V], fi, fo, fold, stats, gen, f"train{i}")
V, fi, fo = cs.KEEP_BASIS_CONV
rows.append(cs.check_keep_basis(by_v[V], fi, fo, gen, "keep_basis"))
if F32:
    import inspect
    f32 = torch.float32
    extra = [cs.check_conv(by_v[V], n, fi, fo, ep, gen, f"f32main{i}", f32)
             for i, (V, n, fi, fo, ep) in convs]
    # K4, K5 and K6 where the checkout has their float32 instances
    if "dtype" in inspect.signature(cs.check_hop).parameters:
        extra += [cs.check_hop(by_v[V], fi, gen, f"f32hop{i}", f32)
                  for i, (V, _, fi, _, _) in convs]
        extra += [cs.check_strip(by_v[V], fi, fo, ep, gen, f"f32strip{i}", f32)
                  for i, (V, _, fi, fo, ep) in convs]
        extra += [cs.check_window(by_v[V], fi, fo, ep, gen, f"f32window{i}", f32)
                  for i, (V, _, fi, fo, ep) in convs]
    for i, (V, fi, fo, fold, stats) in enumerate(cs.TRAIN_CONVS):
        extra += cs.check_train_conv(by_v[V], fi, fo, fold, stats, gen, f"f32train{i}", f32)
    V, fi, fo = cs.KEEP_BASIS_CONV
    extra.append(cs.check_keep_basis(by_v[V], fi, fo, gen, "f32keep_basis", f32))
    for r in extra:
        r["name"] += "[f32]"
    rows += extra
ms, splits = {}, {}
for r in rows:
    ms[r["name"]] = ms.get(r["name"], 0.0) + r["ms"]
    for k, t in r.get("split_ms", {}).items():
        d = splits.setdefault(r["name"], {})
        d[k] = d.get(k, 0.0) + t
print(subprocess.run(SMI, capture_output=True, text=True).stdout.strip(), flush=True)
ok = all(r["ok"] for r in rows)
print("AB " + json.dumps({"tree": os.getcwd(), "ok": ok, "ms": ms, "splits": splits,
                         "rows": {r["tag"] + " " + r["name"]: r["ms"] for r in rows}}),
      flush=True)
sys.exit(0 if ok else 1)
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="kernel times of checkouts in turns on one GPU")
    p.add_argument("trees", nargs="+", help="checkout directories, in the order to run")
    p.add_argument("--f32", action="store_true",
                   help="also the float32 instances' rows (checkouts that have them)")
    args = p.parse_args(argv)
    code = f"F32 = {args.f32}\n" + ROWS
    for tree in args.trees:
        if not os.path.exists(os.path.join(tree, "chip_smoke.py")):
            raise SystemExit(f"{tree}: no chip_smoke.py, not a checkout of this repository")
        lines = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                               text=True)
        keep = [line for line in lines.stdout.splitlines()
                if line.startswith(("AB ", "NVIDIA")) or "FAIL" in line]
        print("\n".join(keep), flush=True)
        if lines.returncode:
            print(lines.stderr[-4000:], file=sys.stderr)
            return lines.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
