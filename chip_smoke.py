#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     pose2mesh_release_tpu_torch/csrc with nvcc;
  2. hold each deploy kernel against its plain PyTorch version on the card
     at the SMPL deploy forward's 10 band-conv shapes (batch 64, bf16) plus
     one synthetic band_k=2 level, and time kernel and plain version;
  3. drive the deploy forward (SMPL stand-in, 9 levels, SMPL_BLOCKS, PoseNet
     hidden 4096, 17 H36M joints, bf16, batch 64, BatchNorm folded into
     seeded random weights) through make_eval_step on 4 request batches,
     count the kernel launches, check shapes and finiteness, and compare one
     batch with the same forward through the plain versions;
  4. hold the training conv (K1) and its fused backward (K2) against their
     plain versions at the SMPL train step's 10 band-conv shapes, each in the
     variant the step uses (batch 64, bf16), plus the band_k=2 level, and
     time kernel and plain version;
  5. drive the train step (smpl_train_setup: the same network in its
     training form, bf16 compute, batch 64, RMSprop at lr 1e-3, edge loss on)
     for 1 warm-up and 4 counted steps: finite losses, a total that falls,
     exactly 10 K1 + 10 K2 launches per step and no deploy-kernel launch; then
     one step's loss and gradients from the same state through the plain
     versions of K1 and K2 on the card;
  6. print the kernel table as one JSON line, then the result line.

Tolerances: a kernel (bf16 operands, float32 accumulation, bf16 hop results)
against its plain version computed in float32 from the same bf16 inputs:
relative L2 error <= 1e-2 over the real vertex rows, for every output (y and
the statistics of K1; dx, dW, db, ds, dc of K2).  The forward against the
plain forward (same bf16 rounding points): relative L2 error of the mesh and
of the regressed joints <= 2e-2.  The train step against the same step
through the plain K1 and K2: relative difference of the total loss <= 2e-2
and relative L2 error of each parameter's gradient <= 5e-2, except the
biases that feed a training BatchNorm, whose exact gradient is zero (they are
reported, not held).  Matmuls of the plain versions run in full float32
(TF32 off).

Bounds: bytes over 3.35 TB/s and operations over 989 TFLOP/s (H100 SXM
bf16 dense), the larger of the two.  Operations: the Laplacian hops at the
operator's nonzeros, the projections densely, over the real rows (K2: two
hops of the cotangent, the dx product and the dW product).  Bytes: each
input read once and each output written once, vertex tensors at the real
rows and the operator at its nonzero values.
Everything written to chiprun_out/chip_smoke.json as well.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

KERNEL_TOL = 1e-2
FORWARD_TOL = 2e-2
STEP_LOSS_TOL = 2e-2
STEP_GRAD_TOL = 5e-2
BATCH = 64
REQUESTS = 4
TRAIN_STEPS = 4
LR = 1e-3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
REPLACES = {
    "fused_cheby_conv": "pose2mesh_release_tpu/ops/pallas_cheby.py:713",
    "fused_cheby_conv_commuted": "pose2mesh_release_tpu/ops/pallas_cheby.py:421",
    "fused_cheby_conv_train": "pose2mesh_release_tpu/ops/pallas_cheby.py:1015",
    "fused_cheby_conv_bwd": "pose2mesh_release_tpu/ops/pallas_cheby.py:922",
}
SOURCES = {
    "fused_cheby_conv": "pose2mesh_release_tpu_torch/csrc/fused_cheby.cu",
    "fused_cheby_conv_commuted":
        "pose2mesh_release_tpu_torch/csrc/fused_cheby_commuted.cu",
    "fused_cheby_conv_train": "pose2mesh_release_tpu_torch/csrc/fused_cheby_train.cu",
    "fused_cheby_conv_bwd": "pose2mesh_release_tpu_torch/csrc/fused_cheby_bwd.cu",
}
DEPLOY_KERNELS = ("fused_cheby_conv", "fused_cheby_conv_commuted")
TRAIN_KERNELS = ("fused_cheby_conv_train", "fused_cheby_conv_bwd")
# The SMPL deploy forward's band convs, in forward order:
# (level vertex count, kernel, fin, fout, epilogue)
MAIN_PATH_CONVS = [
    (981, "fused_cheby_conv", 256, 256, "relu"),
    (981, "fused_cheby_conv", 256, 256, "skip_add"),
    (1849, "fused_cheby_conv_commuted", 256, 128, "relu"),
    (1849, "fused_cheby_conv", 128, 128, "skip_proj"),
    (3475, "fused_cheby_conv", 128, 128, "relu"),
    (3475, "fused_cheby_conv", 128, 128, "skip_add"),
    (6890, "fused_cheby_conv", 128, 128, "relu"),
    (6890, "fused_cheby_conv", 128, 128, "skip_add"),
    (6890, "fused_cheby_conv_commuted", 128, 64, "relu"),
    (6890, "fused_cheby_conv", 64, 3, "final"),
]
# a band_k = 2 level of SMPL's second level size, both kernels
K2_CONVS = [
    ("fused_cheby_conv", 128, 128, "skip_proj"),
    ("fused_cheby_conv_commuted", 256, 128, "relu"),
]
# The SMPL train step's band convs, in forward order: (level vertex count,
# fin, fout, K1 reads relu(x*s + c), K1 emits the batch-stat sums); K2 runs
# once per conv in the backward, with the fold where K1 has it.
TRAIN_CONVS = [
    (981, 256, 256, False, True),
    (981, 256, 256, True, True),
    (1849, 256, 128, False, True),
    (1849, 128, 128, True, True),
    (3475, 128, 128, False, True),
    (3475, 128, 128, True, True),
    (6890, 128, 128, False, True),
    (6890, 128, 128, True, True),
    (6890, 128, 64, False, True),
    (6890, 64, 3, True, False),
]
# the band_k = 2 level: K1 in_fold + emit_stats, K2 in_fold
K2_TRAIN_CONV = (128, 128, True, True)


def log(*a):
    print(*a, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def cuda_ms(fn, n: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(flops: int, bytes_: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 tensor-core rate."""
    t_bytes, t_flops = bytes_ / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def reset_launches():
    from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
    for counts in (fc.launches, ft.launches):
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
    return {**fc.launches, **ft.launches}


def k2_level(V: int, seed: int = 0):
    """Random symmetric operator of V rows with block-bandwidth 2."""
    import numpy as np
    import scipy.sparse as sp
    from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
    T = 128
    bw = 2 * T - T // 2
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(V), 6)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=rows.shape), 0, V - 1)
    L = sp.coo_matrix((rng.standard_normal(rows.shape) * 0.15, (rows, cols)),
                      shape=(V, V))
    L = ((L + L.T) * 0.5).tolil()
    L[0, bw] = L[bw, 0] = 0.1
    op = _make_level_op(L.tocsr(), "band", T)
    assert op.band_k == 2, op.band_k
    return op


def check_conv(op, name, fin, fout, epilogue, gen, tag):
    """Kernel vs plain version on the card; returns the row of numbers."""
    import torch
    from pose2mesh_release_tpu_torch.models.meshnet import channel_interp_matrix
    from pose2mesh_release_tpu_torch.ops import fused_cheby as fc

    dev, bf = "cuda", torch.bfloat16
    band = op.band_val.to(dev, bf)
    V, Vp = op.num_vertices, op.padded_vertices

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    x = randn(Vp, BATCH, fin, scale=0.5)
    W = randn(3 * fin, fout, scale=1.0 / math.sqrt(3 * fin))
    b = randn(fout, scale=0.1)
    kw = {"relu": epilogue != "final"}
    skip = skip_w = None
    if epilogue == "skip_add":
        skip = randn(Vp, BATCH, fout, scale=0.5)
    elif epilogue == "skip_proj":
        fs = 2 * fout
        skip = randn(Vp, BATCH, fs, scale=0.5)
        skip_w = torch.from_numpy(channel_interp_matrix(fs, fout).T.copy()).to(dev, bf)
    if name == "fused_cheby_conv":
        kw.update(skip=skip, skip_w=skip_w)
        kernel, plain = fc.fused_cheby_conv, fc.fused_cheby_conv_plain
    else:
        kernel, plain = fc.fused_cheby_conv_commuted, fc.fused_cheby_conv_commuted_plain

    y = kernel(band, x, W, b, **kw)
    torch.cuda.synchronize()
    f32 = {k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()}
    ref = plain(band.float(), x.float(), W.float(), b.float(), **f32)
    err = rel_l2(y[:V], ref[:V])
    max_abs = float((y[:V].float() - ref[:V]).abs().max())
    finite = bool(torch.isfinite(y[:V].float()).all())
    ms = cuda_ms(lambda: kernel(band, x, W, b, **kw), 20)
    plain_ms = cuda_ms(lambda: plain(band, x, W, b, **kw), 5)

    nnz = int(torch.count_nonzero(op.band_val))
    hop_cols = BATCH * (fin if name == "fused_cheby_conv" else fout)
    flops = 2 * 2 * nnz * hop_cols + 2 * V * BATCH * 3 * fin * fout
    if skip_w is not None:
        flops += 2 * V * BATCH * skip.shape[-1] * fout
    # bytes by the same rule as the operations: vertex tensors at the real
    # rows, the band operator at its nonzero values
    bytes_ = (nbytes(x[:V], None if skip is None else skip[:V], y[:V], W, b, skip_w)
              + nnz * band.element_size())
    bound_ms, bound_by = bound(flops, bytes_)
    row = {
        "tag": tag, "name": name, "V": V, "Vp": Vp, "band_k": op.band_k,
        "batch": BATCH, "fin": fin, "fout": fout, "epilogue": epilogue,
        "rel_l2": err, "max_abs_err": max_abs, "ok": err <= KERNEL_TOL and finite,
        "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": bytes_,
    }
    log(f"  {tag:10s} {name:26s} V={V:5d} k={op.band_k} {fin:3d}->{fout:3d} "
        f"{epilogue:9s} rel_l2={err:.2e} max_abs={max_abs:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={row['bound_ms']:.4f} "
        f"({row['bound_by']}) library_ms=null {'ok' if row['ok'] else 'FAIL'}")
    return row


def check_train_conv(op, fin, fout, fold, stats, gen, tag):
    """K1 and K2 vs their plain versions on the card; returns their two rows."""
    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft

    dev, bf = gen.device, torch.bfloat16
    band = op.band_val.to(dev, bf)
    V = op.num_vertices

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale + shift).to(bf)

    x = randn(V, BATCH, fin, scale=0.5)
    W = randn(3 * fin, fout, scale=1.0 / math.sqrt(3 * fin))
    b = randn(fout, scale=0.1)
    g = randn(V, BATCH, fout)
    in_fold = (randn(fin, scale=0.25, shift=1.0), randn(fin, scale=0.1)) if fold else None
    fold32 = None if in_fold is None else tuple(t.float() for t in in_fold)
    nnz = int(torch.count_nonzero(op.band_val))
    band_bytes = nnz * band.element_size()
    fold_bytes = nbytes(*in_fold) if fold else 0
    cases = {
        "fused_cheby_conv_train": (
            lambda: ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold,
                                              emit_stats=stats),
            lambda: ft.fused_cheby_conv_train_plain(band, x, W, b, in_fold=in_fold,
                                                    emit_stats=stats),
            lambda: ft.fused_cheby_conv_train_plain(
                band.float(), x.float(), W.float(), b.float(), in_fold=fold32,
                emit_stats=stats),
            ("y", "sum_y", "sum_y2"),
            # two hops of u, the projection
            2 * 2 * nnz * BATCH * fin + 2 * V * BATCH * 3 * fin * fout,
            nbytes(x, W, b) + V * BATCH * fout * 2 + band_bytes + fold_bytes
            + (2 * fout * 4 if stats else 0)),
        "fused_cheby_conv_bwd": (
            lambda: ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold),
            lambda: ft.fused_cheby_conv_bwd_plain(band, g, x, W, in_fold=in_fold),
            lambda: ft.fused_cheby_conv_bwd_plain(band.float(), g.float(), x.float(),
                                                  W.float(), in_fold=fold32),
            ("dx", "dW", "db", "ds", "dc"),
            # two hops of g, the dx product, the dW product
            2 * 2 * nnz * BATCH * fout + 2 * 2 * V * BATCH * 3 * fout * fin,
            nbytes(g, x, W) + nbytes(x) + 3 * fin * fout * 4 + fout * 4 + band_bytes
            + (fold_bytes + 2 * fin * 4 if fold else 0)),
    }
    rows = []
    for name, (kernel, plain, ref32, names, flops, bytes_) in cases.items():
        out = kernel()
        torch.cuda.synchronize()
        ref = ref32()
        out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        errs = {n: rel_l2(a, r) for n, a, r in zip(names, out, ref)}
        # on the activation (y, dx); the sums are held by their rel_l2 alone
        max_abs = float((out[0].float() - ref[0]).abs().max())
        finite = all(bool(torch.isfinite(a.float()).all()) for a in out)
        ms = cuda_ms(kernel, 10)
        plain_ms = cuda_ms(plain, 3)
        bound_ms, bound_by = bound(flops, bytes_)
        row = {
            "tag": tag, "name": name, "V": V, "band_k": op.band_k, "batch": BATCH,
            "fin": fin, "fout": fout, "in_fold": fold, "emit_stats": stats,
            "rel_l2": errs, "max_abs_err": max_abs,
            "ok": finite and max(errs.values()) <= KERNEL_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": bytes_,
        }
        log(f"  {tag:10s} {name:22s} V={V:5d} k={op.band_k} {fin:3d}->{fout:3d} "
            f"fold={int(fold)} stats={int(stats)} rel_l2 "
            + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
            + f" max_abs={max_abs:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms=null "
            f"{'ok' if row['ok'] else 'FAIL'}")
        rows.append(row)
    return rows


def train_step_vs_plain(setup, state):
    """One train step's loss and gradients from the model's current state,
    through the kernels and through the plain versions of K1 and K2 on the
    card (lr 0, so the parameters stay; the same dropout draws).  Returns
    (loss with kernels, loss plain, {param: rel L2 of its gradient}, the
    biases left out, ms of the plain step)."""
    import copy

    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft

    model = state.model
    snapshot = copy.deepcopy(model.state_dict())
    n_convs = len(model.pose2mesh.cl)
    # a bias followed by a training BatchNorm has an exact gradient of zero
    zero_grad_biases = {f"pose2mesh.cl.{i}.bias" for i in range(n_convs - 1)} | {
        f"pose_lifter.linear_stages.{j}.w1.bias"
        for j in range(len(model.pose_lifter.linear_stages))}

    def one_step():
        model.load_state_dict(snapshot)
        gen = torch.Generator(device=setup.batch["pose2d"].device).manual_seed(123)
        t0 = time.perf_counter()
        _, losses = setup.train_step(state, setup.art_compute, setup.batch, 0.0, True, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        return float(losses["total"]), grads, ms

    loss_k, grads_k, _ = one_step()
    kernels = ft.fused_cheby_conv_train, ft.fused_cheby_conv_bwd
    ft.fused_cheby_conv_train = ft.fused_cheby_conv_train_plain
    ft.fused_cheby_conv_bwd = ft.fused_cheby_conv_bwd_plain
    try:
        loss_p, grads_p, plain_ms = one_step()
    finally:
        ft.fused_cheby_conv_train, ft.fused_cheby_conv_bwd = kernels
    model.load_state_dict(snapshot)
    errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_p if n not in zero_grad_biases}
    left_out = {n: (float(grads_k[n].norm()), float(grads_p[n].norm()))
                for n in sorted(zero_grad_biases)}
    return loss_k, loss_p, errs, left_out, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 2
    try:
        from pose2mesh_release_tpu_torch.deploy import smpl_deploy_forward
        from pose2mesh_release_tpu_torch.ops import _build
        from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
        from pose2mesh_release_tpu_torch.train_setup import smpl_train_setup
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    # -- phase 1: card, build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.time()
    libs = _build.build_all()
    report["build_s"] = time.time() - t0
    log(f"phase 1: built {sorted(libs)} in {report['build_s']:.1f} s")
    for stem, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {stem}: {line.strip()}")

    # -- phase 2: kernel checks at the main path's shapes -----------------
    deploy = smpl_deploy_forward(dtype=torch.bfloat16, device="cuda", seed=0)
    art = deploy.art
    by_v = {op.num_vertices: op for op in art.mesh_ops}
    log(f"pyramid levels: {[(op.kind, op.num_vertices, op.padded_vertices, op.band_k) for op in art.mesh_ops]}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f"phase 2: kernel vs plain (f32 from the same bf16 inputs), "
        f"batch {BATCH}, tolerance rel_l2 <= {KERNEL_TOL}")
    rows = [check_conv(by_v[V], name, fin, fout, ep, gen, f"main{i}")
            for i, (V, name, fin, fout, ep) in enumerate(MAIN_PATH_CONVS)]
    op2 = k2_level(3475)
    rows += [check_conv(op2, name, fin, fout, ep, gen, f"k2_{i}")
             for i, (name, fin, fout, ep) in enumerate(K2_CONVS)]
    report["convs"] = rows
    bad = [r["tag"] for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")

    # -- phase 3: the deploy forward ---------------------------------------
    model, eval_step, art_bf = deploy.model, deploy.eval_step, deploy.art_compute
    g = torch.Generator().manual_seed(1)
    batches = [torch.randn(BATCH, 17, 2, generator=g).cuda() for _ in range(REQUESTS)]
    eval_step(art_bf, batches[0])  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    outs, times = [], []
    for p in batches:
        t0 = time.perf_counter()
        outs.append(eval_step(art_bf, p))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    log(f"phase 3: {REQUESTS} requests of batch {BATCH}: ms per batch "
        f"{[round(t, 3) for t in times]} ({card}); launches {launches}")
    want = {"fused_cheby_conv": 8 * REQUESTS, "fused_cheby_conv_commuted": 2 * REQUESTS,
            "fused_cheby_conv_train": 0, "fused_cheby_conv_bwd": 0}
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    for mesh, reg, pose3d in outs:
        assert mesh.shape == (BATCH, 6890, 3) and reg.shape == (BATCH, 17, 3), \
            (mesh.shape, reg.shape)
        assert pose3d.shape == (BATCH, 17, 3)
        for t in (mesh, reg, pose3d):
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())

    # the same forward with MeshNet's band convs swapped for the plain versions
    from pose2mesh_release_tpu_torch.models import meshnet
    kernels_in_use = (meshnet.fused_cheby_conv, meshnet.fused_cheby_conv_commuted)
    meshnet.fused_cheby_conv = fc.fused_cheby_conv_plain
    meshnet.fused_cheby_conv_commuted = fc.fused_cheby_conv_commuted_plain
    try:
        ref = eval_step(art_bf, batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(art_bf, batches[0])
        torch.cuda.synchronize()
        plain_fwd_ms = (time.perf_counter() - t0) * 1e3
    finally:
        meshnet.fused_cheby_conv, meshnet.fused_cheby_conv_commuted = kernels_in_use
    mesh_err = rel_l2(outs[0][0], ref[0])
    reg_err = rel_l2(outs[0][1], ref[1])
    log(f"  forward vs plain forward: mesh rel_l2={mesh_err:.3e} "
        f"reg_pose rel_l2={reg_err:.3e} (tolerance {FORWARD_TOL}); "
        f"plain forward {plain_fwd_ms:.3f} ms; mesh mm range "
        f"[{float(outs[0][0].min()):.2f}, {float(outs[0][0].max()):.2f}]")
    if not (mesh_err <= FORWARD_TOL and reg_err <= FORWARD_TOL):
        raise SystemExit("forward disagrees with the plain forward")
    report["forward"] = {"card": card, "batch": BATCH, "ms_per_batch": times,
                         "plain_forward_ms": plain_fwd_ms, "launches": launches,
                         "mesh_rel_l2": mesh_err, "reg_pose_rel_l2": reg_err}

    # -- phase 4: the training kernels at the train step's shapes ---------
    log(f"phase 4: K1/K2 vs plain (f32 from the same bf16 inputs), batch {BATCH}, "
        f"tolerance rel_l2 <= {KERNEL_TOL}")
    train_rows = []
    for i, (V, fin, fout, fold, stats) in enumerate(TRAIN_CONVS):
        train_rows += check_train_conv(by_v[V], fin, fout, fold, stats, gen, f"train{i}")
    train_rows += check_train_conv(op2, *K2_TRAIN_CONV, gen, "k2_train")
    report["train_convs"] = train_rows
    bad = [(r["tag"], r["name"]) for r in train_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"training kernel check failed: {bad}")
    del deploy, model, eval_step, outs, ref
    torch.cuda.empty_cache()

    # -- phase 5: the train step --------------------------------------------
    t0 = time.time()
    setup = smpl_train_setup(dtype=torch.bfloat16, device="cuda", seed=0, batch=BATCH)
    log(f"phase 5: train setup in {time.time() - t0:.1f} s; batch {BATCH}, bf16, "
        f"RMSprop lr {LR}, edge loss on")
    state = setup.state
    state, warm = setup.train_step(state, setup.art_compute, setup.batch, LR, True,
                                   setup.generator)
    torch.cuda.synchronize()
    reset_launches()
    step_losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, losses = setup.train_step(state, setup.art_compute, setup.batch, LR, True,
                                         setup.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_losses.append({k: float(v) for k, v in losses.items()})
    train_launches = read_launches()
    log(f"  warm-up total {float(warm['total']):.5f}; {TRAIN_STEPS} steps: ms per step "
        f"{[round(t, 3) for t in step_ms]} ({card}); totals "
        f"{[round(l['total'], 5) for l in step_losses]}; launches {train_launches}")
    want = {"fused_cheby_conv": 0, "fused_cheby_conv_commuted": 0,
            "fused_cheby_conv_train": 10 * TRAIN_STEPS,
            "fused_cheby_conv_bwd": 10 * TRAIN_STEPS}
    if train_launches != want:
        raise SystemExit(f"launch counts {train_launches} != {want}")
    if not all(math.isfinite(v) for l in step_losses for v in l.values()):
        raise SystemExit(f"non-finite loss: {step_losses}")
    if not step_losses[-1]["total"] < step_losses[0]["total"]:
        raise SystemExit("the total loss did not fall over the steps")
    loss_k, loss_p, grad_errs, left_out, plain_step_ms = train_step_vs_plain(setup, state)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"  step vs plain-version step: total {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_err:.2e}, tolerance {STEP_LOSS_TOL}); gradient rel_l2 max "
        f"{worst[0][1]:.3e} (tolerance {STEP_GRAD_TOL}), worst {worst}; "
        f"plain step {plain_step_ms:.3f} ms")
    log(f"  biases feeding a BatchNorm (|grad| kernels, plain): "
        f"{ {n: (round(a, 8), round(b, 8)) for n, (a, b) in left_out.items()} }")
    if not (loss_err <= STEP_LOSS_TOL and worst[0][1] <= STEP_GRAD_TOL):
        raise SystemExit("the train step disagrees with the plain-version step")
    report["train"] = {"card": card, "batch": BATCH, "lr": LR, "ms_per_step": step_ms,
                       "losses": step_losses, "launches": train_launches,
                       "plain_step_ms": plain_step_ms, "loss_rel_err": loss_err,
                       "grad_rel_l2": grad_errs, "zero_grad_biases": left_out}

    # -- phase 6: the kernel table -----------------------------------------
    kernels = []
    for name in DEPLOY_KERNELS + TRAIN_KERNELS:
        every = [r for r in rows + train_rows if r["name"] == name]
        main = [r for r in every if r["tag"].startswith(("main", "train"))]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": (launches if name in DEPLOY_KERNELS else train_launches)[name],
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in main)
                         * 2 >= len(main) else "operations"),
            "library_ms": None,
            "status": "ok",
            "shapes_per_pass": len(main),
        })
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
