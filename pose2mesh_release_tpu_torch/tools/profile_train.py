"""Where the time of the SMPL train step goes, on one GPU.

    python -m pose2mesh_release_tpu_torch.tools.profile_train [--batch 64] [--steps 5]

Builds the train step of `train_setup.smpl_train_setup` (bf16 compute,
RMSprop at lr 1e-3, edge loss on), warms it up, then:
  1. times `--steps` steps on the host clock, each ending in a synchronize:
     the end-to-end metric "train step ms per batch";
  2. traces `--steps` steps with torch.profiler: device time per step by
     kernel, grouped into K1 (`fused_cheby_conv_train`: its fold pass and
     projection), K2 (`fused_cheby_conv_bwd`: dx, dW), the hop engine that
     both run, their partial-sum passes, matrix products and the rest, and
     the device's idle share of the traced window;
  3. traces `--steps` steps again, each cut into phases (network forward,
     loss forward, loss backward, network backward, optimizer) marked with
     a marker kernel, and splits by the phase they run in the hop engine's
     kernels (K1's hops in the network forward, K2's in its backward) and
     the kernels that no name claims: the network's BatchNorm, elementwise,
     gather and cast kernels, the losses, the optimizer.  K1's and K2's
     totals are their named kernels (2.) plus their engine time (3.).
Needs a CUDA device; writes chiprun_out/profile_train.json.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..core.losses import pose2mesh_loss
from ..core.optim import set_lr
from ..models.meshnet import extract_mesh
from ..train_setup import smpl_train_setup

LR = 1e-3
ENGINE = "hop engine (K1 and K2)"
GROUPS = (("K1 fused_cheby_conv_train", ("cheby_proj_kernel", "cheby_proj_f32_kernel",
                                         "fold_kernel")),
          ("K2 fused_cheby_conv_bwd", ("bwd_dx_kernel", "bwd_dw_kernel", "bwd_dx_f32_kernel",
                                      "bwd_dw_f32_kernel", "dw_reduce_kernel")),
          (ENGINE, ("band_hop_kernel",)),
          ("K1/K2 partial-sum passes", ("reduce_partials",)),
          ("matrix products", ("gemm", "gemv", "cutlass", "xmma", "sm90_")))
PHASES = ("network forward", "loss forward", "loss backward", "network backward",
          "optimizer")
# the phases' unnamed kernels, as the end-to-end breakdown reports them
PHASE_GROUPS = {"network forward": "network BatchNorm/elementwise/gathers",
                "network backward": "network BatchNorm/elementwise/gathers",
                "loss forward": "losses", "loss backward": "losses",
                "optimizer": "optimizer"}


def _group(name: str):
    low = name.lower()
    return next((g for g, pats in GROUPS if any(p in low for p in pats)), None)


def _is_annotation(e) -> bool:
    """A range the trace mirrors onto the device timeline (the optimizer's
    `Optimizer.step#...`), not a kernel."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("Optimizer.")


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_kernels(prof):
    """[(name, device us)] of every kernel (and copy) the trace holds."""
    return [(e.name, float(e.device_time_total)) for e in _device_events(prof)
            if not _is_annotation(e)]


def _mark():
    """A tiny kernel ending a phase on the device timeline: it runs after
    every kernel the phase launched, from any thread, as all share one
    stream."""
    torch.cuda._sleep(1)


def _phased_step(setup, state, jreg):
    """The train step of core/train.py cut into phases, each ended by a
    marker kernel."""
    model, opt, b, art = state.model, state.optimizer, setup.batch, setup.art_compute
    opt.zero_grad(set_to_none=True)
    mesh_dev, pose3d = model(art, b["pose2d"], train=True, generator=setup.generator)
    _mark()
    mesh = extract_mesh(art, mesh_dev)
    reg = torch.einsum("jv,bvc->bjc", jreg, mesh * 1000.0)
    total = pose2mesh_loss(mesh, pose3d, reg, b, art.faces, use_edge_loss=True)["total"]
    _mark()
    grads = torch.autograd.grad(total, (mesh_dev, pose3d))
    _mark()
    torch.autograd.backward((mesh_dev, pose3d), grads)
    _mark()
    set_lr(opt, LR)
    opt.step()
    _mark()


def _by_phase(prof):
    """({phase: device us of the kernels of that phase that no name group
    claims}, {phase: device us of the hop engine}, markers seen): the device
    kernels in time order, the phase advancing at each marker kernel."""
    dev = sorted((e for e in _device_events(prof) if not _is_annotation(e)),
                 key=lambda e: e.time_range.start)
    out = {p: 0.0 for p in PHASES}
    engine = {p: 0.0 for p in PHASES}
    i = 0
    for e in dev:
        if "spin_kernel" in e.name:
            i += 1
            continue
        group = _group(e.name)
        if group is None:
            out[PHASES[i % len(PHASES)]] += e.device_time_total
        elif group == ENGINE:
            engine[PHASES[i % len(PHASES)]] += e.device_time_total
    return out, engine, i


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    n = args.steps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    s = smpl_train_setup(dtype=torch.bfloat16, device="cuda", seed=0, batch=args.batch)
    jreg = torch.as_tensor(s.j_regressor).cuda()
    state = s.state

    def step():
        nonlocal state
        state, _ = s.train_step(state, s.art_compute, s.batch, LR, True, s.generator)

    for _ in range(3):
        step()
    torch.cuda.synchronize()

    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for name, us in _device_kernels(prof):
        kernels[name] = kernels.get(name, 0.0) + us
    device_ms = sum(kernels.values()) / 1e3 / n
    groups = {g: 0.0 for g, _ in GROUPS}
    groups["other"] = 0.0
    for name, us in kernels.items():
        groups[_group(name) or "other"] += us / 1e3 / n

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof2:
        for _ in range(n):
            _phased_step(s, state, jreg)
        torch.cuda.synchronize()
    phases, engine, markers = _by_phase(prof2)
    if markers != len(PHASES) * n:
        raise SystemExit(f"profile_train: {markers} phase markers in the trace, "
                         f"expected {len(PHASES) * n}")
    phase_ms = {p: us / 1e3 / n for p, us in phases.items()}
    other_split = {}
    for p, ms in phase_ms.items():
        other_split[PHASE_GROUPS[p]] = other_split.get(PHASE_GROUPS[p], 0.0) + ms
    phased_device_ms = sum(us for _, us in _device_kernels(prof2)) / 1e3 / n
    engine_ms = {p: us / 1e3 / n for p, us in engine.items()}
    totals = {"K1 (named + hops in the network forward)":
              groups["K1 fused_cheby_conv_train"] + engine_ms["network forward"],
              "K2 (named + hops in the network backward)":
              groups["K2 fused_cheby_conv_bwd"] + engine_ms["network backward"]}

    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    result = {
        "card": card, "batch": args.batch, "steps": n, "lr": LR,
        "wall_ms_per_step": walls,
        "traced_wall_ms_per_step": traced_ms / n,
        "device_ms_per_step": device_ms,
        "device_idle_share": (max(0.0, 1.0 - device_ms * n / traced_ms)
                              if traced_ms > 0 else None),
        "groups_ms_per_step": groups,
        "other_by_phase_ms_per_step": other_split,
        "unnamed_kernels_by_phase_ms_per_step": phase_ms,
        "hop_engine_by_phase_ms_per_step": engine_ms,
        "k1_k2_ms_per_step": totals,
        "phased_device_ms_per_step": phased_device_ms,
        "top_kernels_ms_per_step": [(k, us / 1e3 / n) for k, us in top],
    }
    print(card)
    print(f"wall ms per step (batch {args.batch}): {[round(w, 3) for w in walls]}")
    print(f"device ms per step: {device_ms:.3f}; idle share of the traced window: "
          f"{result['device_idle_share']}")
    for name, ms in groups.items():
        print(f"  {name:40s} {ms:8.3f} ms")
    print(f"'other' split by the phase it runs in (phased steps, device "
          f"{phased_device_ms:.3f} ms per step):")
    for name, ms in other_split.items():
        print(f"  {name:40s} {ms:8.3f} ms")
    print("hop engine by phase: " + ", ".join(f"{p} {ms:.3f} ms" for p, ms in engine_ms.items()
                                              if ms))
    for name, ms in totals.items():
        print(f"  {name:40s} {ms:8.3f} ms")
    for key, ms in result["top_kernels_ms_per_step"]:
        print(f"  {ms:8.3f} ms  {key[:100]}")
    if device_ms == 0:
        print("the profiler recorded no device time: device breakdown not measured")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_train.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
