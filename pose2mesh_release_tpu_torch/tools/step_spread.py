"""How far the float32 SMPL train step moves when only the order of its
batch changes: on the card's kernels and on the plain versions on the CPU.

    python -m pose2mesh_release_tpu_torch.tools.step_spread [--batch 64] [--hidden 4096]
        [--devices cuda,cpu]

The full-width cascade of chip_smoke's phase 15b (the stand-in SMPL, 9
levels, SMPL_BLOCKS, PoseNet `--hidden`, random weights from seed 0, the
synthetic batch of seed 0, dropout 0, float32), one SGD step's gradients on
each device of `--devices`, once on the batch and once with its halves
swapped.  Prints, per parameter and for every gradient as one vector, the
rel_l2 between:

  spread    a device's step and its half-swapped step: the rounding that a
            reordering of the same float32 sums moves (a data-axis mesh
            reorders them so; chip_smoke holds the float32 mesh step at a
            multiple of the card's spread)
  cuda_cpu  the card's step (K1, K2) and the CPU's (their plain versions)

and, for every training BatchNorm of the step, the largest and the median
over channels of mean^2 / var from its sums: the one-pass variance
E[y^2] - E[y]^2 loses that ratio times float32's epsilon.  Writes
chiprun_out/step_spread.json.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import time

import numpy as np
import torch

from ..body.smpl import SMPL
from ..core.optim import make_preconditioner
from ..core.train import TrainState, make_train_step
from ..data.joint_sets import HUMAN36
from ..deploy import build_artifact
from ..models import meshnet, posenet
from ..models.pose2mesh import Pose2Mesh
from ..train_setup import synthetic_batch

LR = 1e-3


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class BnRatios:
    """Records, by BatchNorm name, the largest and the median over channels
    of mean^2 / var of every training `bn_affine` call of `model`."""

    def __init__(self, model: torch.nn.Module):
        self.names = {id(m): n for n, m in model.named_modules()}
        self.calls = {}
        self._orig = posenet.bn_affine

    def __enter__(self):
        def wrapped(bn, sums, n, train, *args, **kw):
            if train:
                s0, s1 = (s.detach().double() for s in sums)
                mean = s0 / n
                var = (s1 / n - mean * mean).clamp_min(1e-30)
                r = (mean * mean / var).cpu()
                self.calls[self.names[id(bn)]] = (float(r.max()), float(r.median()))
            return self._orig(bn, sums, n, train, *args, **kw)
        posenet.bn_affine = meshnet.bn_affine = wrapped
        return self

    def __exit__(self, *exc):
        posenet.bn_affine = meshnet.bn_affine = self._orig


def gradients(model: Pose2Mesh, state: dict, art, jreg: np.ndarray, batch: dict,
              device: torch.device) -> dict:
    """The gradients of one float32 SGD step from `state`."""
    model.load_state_dict(state)
    opt = make_preconditioner("sgd", model.parameters())
    make_train_step(model, opt, jreg, device=device)(TrainState(model, opt), art, batch,
                                                     LR, True, None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def whole(a: dict, b: dict) -> float:
    return math.sqrt(sum(float((a[n] - b[n]).square().sum()) for n in b)
                     / sum(float(b[n].square().sum()) for n in b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "step_spread.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [torch.device(d) for d in args.devices.split(",")]
    if any(d.type == "cuda" for d in devices):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(card, flush=True)
    smpl = SMPL()
    art_cpu = build_artifact(smpl.face, HUMAN36, 9, torch.device("cpu"))
    rng = np.random.default_rng(0)
    jreg = rng.random((17, art_cpu.num_vertices)).astype(np.float32)
    jreg /= jreg.sum(axis=1, keepdims=True)
    batch_np = synthetic_batch(smpl.v_template, args.batch, jreg, rng)
    B = args.batch
    swap = np.concatenate([np.arange(B // 2, B), np.arange(B // 2)])
    grads, ratios, seconds, state = {}, {}, {}, None
    for dev in devices:
        art = art_cpu.to(dev, torch.float32)
        model = Pose2Mesh(art.joint_num, art.mesh_ops[-1].num_vertices, dtype=torch.float32,
                          posenet_hidden=args.hidden, inference_fused=False, dropout=0.0,
                          device=dev, generator=torch.Generator().manual_seed(0))
        if state is None:
            state = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        for tag, order in (("", None), ("_swap", swap)):
            batch = {k: torch.from_numpy(v if order is None else v[order]).to(dev)
                     for k, v in batch_np.items()}
            t0 = time.perf_counter()
            with BnRatios(model) as bn:
                grads[dev.type + tag] = gradients(model, state, art, jreg, batch, dev)
            seconds[dev.type + tag] = time.perf_counter() - t0
            ratios[dev.type + tag] = bn.calls
        del model, art
    pairs = {f"spread {d.type}": (d.type, d.type + "_swap") for d in devices}
    if len(devices) == 2:
        pairs["cuda_cpu"] = ("cuda", "cpu")
    names = list(grads[devices[0].type])
    table = {k: {n: rel_l2(grads[a][n], grads[b][n]) for n in names}
             for k, (a, b) in pairs.items()}
    report = {"batch": B, "hidden": args.hidden, "seconds": seconds,
              "whole": {k: whole(grads[a], grads[b]) for k, (a, b) in pairs.items()},
              "per_parameter": table,
              "bn_mean2_over_var": {k: v for k, v in ratios.items()}}
    print(f"batch {B}, PoseNet {args.hidden}, float32; every gradient as one vector: "
          + ", ".join(f"{k} {v:.3e}" for k, v in report["whole"].items()), flush=True)
    first = list(pairs)[0]
    print(f"parameters by {first}, largest first: " + ", ".join(
        f"{n} (" + ", ".join(f"{k} {table[k][n]:.3e}" for k in pairs) + ")"
        for n in sorted(names, key=lambda n: -table[first][n])[:12]), flush=True)
    for k, calls in ratios.items():
        print(f"{k}: mean^2 / var over channels (largest, median) of its "
              f"{len(calls)} training BatchNorms, by median, largest first: " + ", ".join(
                  f"{n} ({a:.2e}, {m:.2e})"
                  for n, (a, m) in sorted(calls.items(), key=lambda x: -x[1][1])[:6]),
              flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
