#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit; build the CUDA kernels from
     pose2mesh_release_tpu_torch/csrc with nvcc;
  2. hold each deploy kernel against its plain PyTorch version on the card
     at the SMPL deploy forward's 10 band-conv shapes (batch 64, bf16) plus
     one synthetic band_k=2 level, and time kernel and plain version: the
     group kernels (each also its launches apart: the basis-order conv's two
     hops and its projection, the commuted conv's projection and its two
     hops), the strip conv (strip_h 128, one level at 64, band_k=2 in both
     orders and commuted with a skip projection; each also its launches
     apart, as the group kernels'), the window conv (also its launches apart:
     its two hops, its projection), and the single hop of the unfused path
     (forward and backward
     through its autograd Function, beside torch.sparse.mm on the level's
     CSR Laplacian), after the share of nonzero 16 x 16 band sub-tiles each
     level gives the hop engine (the sub-tiles it multiplies);
  3. drive the deploy forward (SMPL stand-in, 9 levels, SMPL_BLOCKS, PoseNet
     hidden 4096, 17 H36M joints, bf16, batch 64, BatchNorm folded into
     seeded random weights) through make_eval_step on 4 request batches,
     count the kernel launches, check shapes and finiteness, and compare one
     batch with the same forward through the plain versions; then the same
     on the strip path (flat_impl="strip": 10 strip convs per forward), the
     window path (10 window convs) and the unfused path (fused=False: 20
     hops, no fused conv), each also against the group forward, and the CUDA
     launches of the hop engine and the projection GEMM in one forward of
     each, counted by torch.profiler (strip 30, window 30, unfused 20);
  4. hold the training conv (K1) and its fused backward (K2) against their
     plain versions at the SMPL train step's 10 band-conv shapes, each in the
     variant the step uses (batch 64, bf16), plus the band_k=2 level, and
     time kernel and plain version, and each one's launches apart (K1: the
     fold pass, its two hops, the projection with the statistics; K2: its
     two hops, dx, dW with the reductions); then K1 with keep_basis (y, z1,
     z2) at one training shape, the only run of that variant (no path takes
     it);
  5. drive the train step (smpl_train_setup: the same network in its
     training form, bf16 compute, batch 64, RMSprop at lr 1e-3, edge loss on)
     for 1 warm-up and 4 counted steps: finite losses, a total that falls,
     exactly 10 K1 + 10 K2 launches per step and no deploy-kernel launch; one
     step's loss and gradients through the kernels against the same step
     through the plain versions of K1 and K2 on the card, twice: from the
     fresh state (before the warm-up step: the kernels' own error) and from
     the state after the five steps (the error grown along the trajectory);
  6. the MANO hand (stand-in, 778 vertices, 6 levels, MANO_BLOCKS, 21
     joints): every kernel of its band level (778 rows, Vp 1024, strip width
     480) against its plain version at batch 64, bf16: the 4 deploy convs
     (2 group basis, 2 commuted) on the group, strip and window paths, the
     unfused path's hops, and the 4 train convs (K1, K2);
  7. the MANO deploy forward (mano_deploy_forward): 4 requests on the group
     path against its plain forward, exactly 2 + 2 group convs each; one
     request on each further path against the group forward (4 strip, 4
     window or 8 hop calls; 12, 12, 8 engine and projection CUDA launches);
  8. the MANO train step (mano_train_setup, its GT synthesised by LBS on the
     card): the step against the plain-K1/K2 step from the fresh state, 1
     warm-up and 4 counted steps with exactly 4 K1 + 4 K2 calls each;
  9. the face corners' two backwards (the banded selector product the train
     step runs, and the index gathers' index-add) at SMPL and MANO widths,
     float32, batch 64: the gradient of the normal + edge losses through
     each (relative L2 <= 1e-5) and each backward's ms;
  10. GT synthesis: posed_mesh_rotated at batch 64 on the card against the
     same call on the CPU (max abs error <= 1e-2 mm, float32), MANO and
     SMPL, and its ms;
  11. the kernel table (SMPL passes);
  12. the data layer (stand-in annotation files in the JSON layouts of
     tests/test_data.py's fixtures, written to a temporary directory, with
     joints regressed from each record's stand-in SMPL mesh): Human36M
     (train, COCO input), COCO, MuCo and PW3D (test) with 128 records each
     and FreiHAND (train) with 64, built with device="cuda" (GT synthesis
     on the card); the datasets' graph (`pyramid_for`, dense_threshold
     1024): SMPL 6890 / 3475 / 1849 band and 981 dense, MANO all dense.
     The loader alone (ms per batch on the per-sample path over the mix, 16
     threads, and on the get_batch path over Human36M) and the H2D copy of a
     batch; Trainer's default path: MultipleDatasets(make_same_len=True) ->
     BatchLoader(64, shuffle, drop_last, 16 threads, on the card) -> one
     epoch (6 steps) of the train step on the datasets' graph (bf16,
     RMSprop), exactly 8 K1 + 8 K2 per step, finite losses, the first loader
     batch's step against the plain-K1/K2 step; the first batch on the card
     against the same seed's batch on the CPU (one thread, relative L2 <=
     1e-5 per tensor) on both paths; 2 steps of FreiHAND's MANO train step
     with no band-level launch; Tester's evaluation loop over PW3D (the
     deploy forward, group path, exactly 6 + 2 group convs per forward,
     compute_both_err per batch, evaluate at the end) against the same loop
     on the CPU through the plain versions (MPJPE, PA-MPJPE, MPVPE within
     2e-2 relative);
  13. the engine and the entry points over phase 12's stand-in files, at
     the same width (batch 64, bf16, PoseNet 4096, 16 loader threads, the
     mix tested on PW3D), each through the entry point a user calls:
     cli.train for 2 epochs (checkpoint{1,2}, best and final .pth.tar,
     metrics.jsonl, the two PDF plots; exactly 8 K1 + 8 K2 in every step
     and 8 K1 in every in-epoch eval forward, counted per call by wrapping
     core.engine's step makers; ms per step, samples/s, each epoch's wall
     seconds); a Trainer resumed from checkpoint2 (epoch 3, model and
     optimizer state equal to the file's exactly) for one more epoch;
     cli.test from best.pth.tar through the deploy Tester (6 group + 2
     commuted convs a forward) against the training-form eval of the same
     checkpoint (8 K1 a forward; every metric within 2e-2 relative);
     PoseNet alone (cli.train one epoch, cli.test on its checkpoint; no
     band launch); cli.demo (float32 on every device, as the JAX demo) with
     best.pth.tar on a 17-keypoint COCO .npy
     and a COCO detections .json (two people after the NMS), and on a
     17-joint H36M .npy with random weights (best.pth.tar holds a 19-joint
     lifter): .obj files of 6890 finite vertices, 8 float32 K1 a person,
     seconds a person and the camera fit's ms, and each fit against fit_camera on
     the CPU from the same inputs (reprojection error within 1e-3
     relative; the parameters beside their sensitivity to a 1e-6 nudge,
     since the demo's joints, from a barely trained model, do not match
     its keypoints and leave the L1 fit's optimum flat), then the fit on
     the stand-in body's own joints under a known camera (parameters
     within 1e-3 of the CPU's);
  14. the float32 instances (the `f32` argument of every csrc entry point)
     and the float32 paths at full SMPL width: each instance against its
     plain version on the same float32 inputs at the shapes of phases 2 and
     4 (the group and commuted convs, K1 with its fold and statistics, K2,
     K1 with keep_basis, the hop K4, the strip conv K5 in both orders with
     every epilogue, the window conv K6; the band_k = 2 level, K5 also at
     64-row strip tiles) and K4, K5, K6 at MANO's band level, relative L2
     <= 1e-5, K1, K2, K4, K5 and K6 run twice to equal bits, and its ms,
     plain ms and bound; smpl_deploy_forward(dtype=float32), 4 requests of
     batch 64, exactly 8 group + 2 commuted convs each, within 1e-4 of the
     plain float32 forward, then the strip, window and unfused paths as in
     phase 3 (the same calls and CUDA launches a forward as bf16, within
     1e-4 of the path's plain float32 forward and of the group forward),
     and MANO's forward, one request on each path, likewise;
     smpl_train_setup(dtype=float32), the step from the fresh state against
     the plain-K1/K2 float32 step (loss 1e-5, gradients 1e-3), then 1 + 4
     steps of exactly 10 K1 + 10 K2; the unfused training form (fused=False)
     with those weights, one step against its plain step (loss 1e-5,
     gradients 1e-3; every training conv carries statistics or a fold, so
     10 K1 + 10 K2 and no hop) and its eval forward (10 hops + 5 K1) within
     1e-4 of its plain forward; over phase 12's stand-in files, cli.train
     with TPU.compute_dtype f32 for one epoch (8 K1 + 8 K2 a step, 8 K1 an
     in-epoch eval forward), cli.test of its checkpoint, deploy (6 + 2
     group convs a forward) against the training form (every metric within
     1e-4), a float32 deploy Tester (Tester(cfg, model=...)) with the same
     folded weights on the strip, window and unfused paths (8 strip, 8
     window or 16 hop calls a forward), each within 1e-4 of the training
     form, and cli.demo on the card with --input_img a PNG written with PIL
     (decoded by PIL where matplotlib is missing; 8 float32 K1 a person)
     against the same demo on the CPU (mesh and joints within 1e-4);
  15. multi-device, in spawned processes joined into a gloo group (file
     rendezvous, a join deadline), every rank on cuda:0 (NCCL puts one rank
     on a card; gloo stages each collective through host memory, so its
     times are not a scaling number), after the parent built the kernels
     (phase 1) and wrote the SMPL artifact as npz: (a) the halo hop on 2
     and 4 graph ranks at each SMPL band level (6890 / 3475 / 1849 / 981)
     and the band_k = 2 level, batch 32, 128 channels, bf16 and float32: K4
     on each rank's halo-extended slab, forward and VJP against the
     one-device K4 on the whole tensor (float32 rel_l2 <= 1e-6, bf16 <=
     1e-2), two runs to equal bits, 3 launches; (b) the full-width SMPL
     train step (global batch 64, PoseNet 4096, SMPL_BLOCKS, SGD, dropout
     0) on a (2, 1) mesh in float32 and bf16 and on a (2, 2) mesh in
     float32, each rank against the one-device step of the same weights and
     batch and dtype, leaving out the biases that feed a training
     BatchNorm, whose gradient cancels (float32: loss 1e-5, the gradients as
     one vector 1e-3, each gradient 1e-3 and each parameter after the step
     rel_l2 1e-4, or 4x the one-device step's own spread when the batch's
     halves are swapped, whichever is larger; bf16: loss 2e-2, the
     gradients as one vector 0.15, each gradient and each parameter after
     the step 0.2), the ranks' parameters equal, each rank's launches per
     step ((2, 1): 10 K1 + 10 K2; (2, 2): 40 halo hops on K4 and nothing
     fused), ms per step and the gradient sync's ms; (c) the census of
     those steps (count and bytes of every collective; no band-sized
     all-gather but one out of and one into each graph-split level); (d) the float32
     deploy Tester of phase 14's checkpoint over phase 12's files on (2, 1)
     (6 group + 2 commuted a forward a rank) and (2, 2) (16 halo hops)
     against phase 14's 1 x 1 deploy Tester (every metric 1e-4); (e) NCCL at
     world size 1 (all_reduce_sum, the gradient sync), and the (2, 1) step
     across two cards where the machine has them;
  16. the JAX package's last modules: (a) the published-checkpoint runbook:
     the port's RefCascade (parity/torch_ref.py) over phase 3's pyramid with
     seeded weights, saved as a reference-layout final.pth.tar (`module.`
     prefixes), through load_checkpoint and the deploy forward (group path,
     8 + 2 a forward) in bf16 and float32, 4 batches of 64, against
     RefCascade's float32 forward on the card (mesh, regressed and lifted
     joints rel_l2 2e-2 / 1e-4); a 19-joint one over the datasets' graph
     through cli.test on phase 12's PW3D files (6 + 2 a forward) against the
     same evaluation of RefCascade (2e-2 relative); (b) the committed JAX
     .ckpt fixture (tests/data/jax_ckpt, written by the JAX package) through
     load_checkpoint: the deploy forward in float32 (1e-4) and bf16 (2e-2)
     against the JAX eval outputs (3 group + 1 commuted a forward), a
     Trainer-style resume (optimizer state by optim_state_from_flax) and one
     float32 RMSprop step (4 K1 + 4 K2) against the JAX package's next step
     (losses 1e-4; parameters and statistics rtol 1e-3, atol 1e-2 and each
     one's step rel_l2 1e-2, the biases whose gradient cancels within
     RMSprop's 10 learning rates);
     (c) the 3DPW converter on the card and on the CPU over
     tests/test_data.py's synthetic pickle (integers and strings equal,
     floats 1e-5) and the port's PW3D on the card's JSON; (d)
     utils.profiling's pyramid_roofline and, per band level,
     spmm_roofline's and sparse_conv_roofline's ideal time beside phase 2's
     K4 and group-conv times;
  then print the MANO kernels' numbers per pass, the data layer's numbers,
  the engine's numbers, the float32 paths' numbers, the multi-device
  numbers, phase 16's numbers and the kernel table (the bf16 kernels and, named `...[f32]`,
  their float32 instances) as one JSON line each, then the result line.

Tolerances: a kernel (bf16 operands, float32 accumulation, bf16 hop results)
against its plain version computed in float32 from the same bf16 inputs:
relative L2 error <= 1e-2 over the real vertex rows, for every output (y and
the statistics of K1, and z1, z2 with keep_basis; dx, dW, db, ds, dc of K2;
the hop and its backward).  Each forward against the plain forward of the same
path (same bf16 rounding points), and each further path against the group
forward: relative L2 error of the mesh and of the regressed joints <= 2e-2.  The train step against the same step
through the plain K1 and K2: relative difference of the total loss <= 2e-2
and relative L2 error of each parameter's gradient <= 5e-2, except the
biases that feed a training BatchNorm, whose exact gradient is zero (they are
reported, not held).  Matmuls of the plain versions run in full float32
(TF32 off).  The float32 instances (phase 14) against their plain versions
on the same float32 inputs: relative L2 <= 1e-5 (the 3xTF32 products keep
about float32's precision; one TF32 product, about three decimal digits,
would not).

Bounds: bytes over 3.35 TB/s and operations over 989 TFLOP/s (H100 SXM
bf16 dense; the float32 instances 495 / 3 TFLOP/s, dense TF32 over the
three products of 3xTF32), the larger of the two.  Operations: the Laplacian hops at the
operator's nonzeros, the projections densely, over the real rows (K2: two
hops of the cotangent, the dx product and the dW product; the strip conv's
hops on Fout columns in commuted order).  Bytes: each input read once and
each output written once, vertex tensors at the real rows and the operator at
its nonzero values.
Everything written to chiprun_out/chip_smoke.json as well.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

# the card's peak rates (H100 SXM): bf16 dense, the 3xTF32 rate of the
# float32 instances, HBM3 bytes/s
from pose2mesh_release_tpu_torch.utils.profiling import (
    PEAK_3XTF32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES,
)

KERNEL_TOL = 1e-2
FORWARD_TOL = 2e-2
STEP_LOSS_TOL = 2e-2
STEP_GRAD_TOL = 5e-2
BATCH = 64
REQUESTS = 4
TRAIN_STEPS = 4
LR = 1e-3
# phase 14, the float32 instances: each against its plain version on the
# same float32 inputs (relative L2), their bound at the 3xTF32 rate
# (PEAK_3XTF32_FLOPS), the float32 forward
# against the plain float32 forward, the float32 step against the
# plain-K1/K2 float32 step (loss, gradients), the float32 deploy Tester's
# metrics against the float32 training-form eval (relative), the demo's
# mesh on the card against the CPU's (relative L2)
F32_KERNEL_TOL = 1e-5
F32_FORWARD_TOL = 1e-4
F32_STEP_LOSS_TOL = 1e-5
F32_STEP_GRAD_TOL = 1e-3
F32_DEPLOY_VS_TRAIN_TOL = 1e-4
F32_DEMO_MESH_TOL = 1e-4
# the strip conv's float32 checks at the band_k = 2 level (fin, fout,
# epilogue): basis with the skip projection; commuted plain, with the skip
# projection and with the skip add
F32_K2_STRIP_CONVS = [(128, 128, "skip_proj"), (256, 128, "relu"), (256, 128, "skip_proj"),
                      (256, 128, "skip_add")]
# the SMPL unfused training form's eval forward: each band block's first
# conv unfused (2 hops), its second K1 with the fold
UNFUSED_EVAL_LAUNCHES = {"banded_hop": 10, "fused_cheby_conv_train": 5}
REPLACES = {
    "fused_cheby_conv": "pose2mesh_release_tpu/ops/pallas_cheby.py:713",
    "fused_cheby_conv_commuted": "pose2mesh_release_tpu/ops/pallas_cheby.py:421",
    "fused_cheby_conv_train": "pose2mesh_release_tpu/ops/pallas_cheby.py:1015",
    "fused_cheby_conv_bwd": "pose2mesh_release_tpu/ops/pallas_cheby.py:922",
    "banded_hop": "pose2mesh_release_tpu/ops/pallas_cheby.py:240",
    "strip_cheby_conv": "pose2mesh_release_tpu/ops/pallas_strip.py:348",
    "window_cheby_conv": "pose2mesh_release_tpu/ops/pallas_window.py:243",
    "fused_cheby_conv_train(keep_basis)": "pose2mesh_release_tpu/ops/pallas_cheby.py:1015",
}
SOURCES = {
    "fused_cheby_conv": "pose2mesh_release_tpu_torch/csrc/fused_cheby.cu",
    "fused_cheby_conv_commuted":
        "pose2mesh_release_tpu_torch/csrc/fused_cheby_commuted.cu",
    "fused_cheby_conv_train": "pose2mesh_release_tpu_torch/csrc/fused_cheby_train.cu",
    "fused_cheby_conv_bwd": "pose2mesh_release_tpu_torch/csrc/fused_cheby_bwd.cu",
    "banded_hop": "pose2mesh_release_tpu_torch/csrc/banded_hop.cu",
    "strip_cheby_conv": "pose2mesh_release_tpu_torch/csrc/strip_cheby.cu",
    "window_cheby_conv": "pose2mesh_release_tpu_torch/csrc/strip_cheby.cu",
    "fused_cheby_conv_train(keep_basis)":
        "pose2mesh_release_tpu_torch/csrc/fused_cheby_train.cu",
}
DEPLOY_KERNELS = ("fused_cheby_conv", "fused_cheby_conv_commuted")
# the further deploy paths: deploy.on_path's arguments, the wrapper each band
# conv goes through and its calls per forward
PATHS = {
    "strip": ({"flat_impl": "strip"}, "strip_cheby_conv", 10),
    "window": ({"flat_impl": "window"}, "window_cheby_conv", 10),
    "unfused": ({"fused": False}, "banded_hop", 20),
}
# the CUDA launches of the hop engine and the projection GEMM in one forward
# of each further path: strip 7 basis-order convs x 3 + 3 commuted x 3,
# window 10 x 3, unfused 10 x 2 hops
ENGINE_KERNELS = ("band_hop_kernel", "cheby_proj_kernel")
PATH_CUDA_LAUNCHES = {"strip": 30, "window": 30, "unfused": 20}
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
# The MANO stand-in (778 vertices, 6 levels, MANO_BLOCKS): its one band level
# (778 rows, Vp 1024, strip width 480) takes blocks 5 and 6.  Deploy convs in
# forward order (kernel, fin, fout, epilogue) by the rule of MAIN_PATH_CONVS,
# train convs (fin, fout, fold, stats) by that of TRAIN_CONVS.
MANO_DEPLOY_CONVS = [
    ("fused_cheby_conv_commuted", 256, 128, "relu"),
    ("fused_cheby_conv", 128, 128, "skip_proj"),
    ("fused_cheby_conv_commuted", 128, 64, "relu"),
    ("fused_cheby_conv", 64, 3, "final"),
]
MANO_TRAIN_CONVS = [
    (256, 128, False, True),
    (128, 128, True, True),
    (128, 64, False, True),
    (64, 3, True, False),
]
MANO_PATHS = {
    "strip": ({"flat_impl": "strip"}, "strip_cheby_conv", 4),
    "window": ({"flat_impl": "window"}, "window_cheby_conv", 4),
    "unfused": ({"fused": False}, "banded_hop", 8),
}
# strip: 1 basis-order conv (skip projection) x 3 + 3 commuted x 3; window
# 4 x 3; unfused 4 x 2 hops
MANO_PATH_CUDA_LAUNCHES = {"strip": 12, "window": 12, "unfused": 8}
MANO_SHAPES = [(BATCH, 778, 3), (BATCH, 21, 3), (BATCH, 21, 3)]
# the MANO kernels' calls per pass of their path (one forward, one step)
MANO_LAUNCHES = {"fused_cheby_conv": 2, "fused_cheby_conv_commuted": 2,
                 "fused_cheby_conv_train": 4, "fused_cheby_conv_bwd": 4,
                 "banded_hop": 8, "strip_cheby_conv": 4, "window_cheby_conv": 4}
FACE_GRAD_TOL = 1e-5
GT_TOL_MM = 1e-2
# K1 with keep_basis: (level vertex count, fin, fout)
KEEP_BASIS_CONV = (1849, 256, 128)
# phase 12, the data layer: records per stand-in dataset (FreiHAND's),
# the loader's threads, loader-fed train steps (one epoch of the mix of
# three 128-record datasets at batch 64), the card-vs-CPU batch tolerance
# (relative L2 per tensor) and the evaluation metrics' (relative)
DATA_RECORDS = 128
HAND_RECORDS = 64
LOADER_WORKERS = 16
DATA_STEPS = 6
BATCH_TOL = 1e-5
EVAL_TOL = 2e-2
# SMPL on the datasets' graph (dense_threshold 1024, 981 dense): per step
# K1 and K2 on 8 band convs, per deploy forward 6 group basis + 2 commuted
DATA_TRAIN_CONVS = 8
DATA_DEPLOY_LAUNCHES = {"fused_cheby_conv": 6, "fused_cheby_conv_commuted": 2}
# phase 13, the engine and the entry points: epochs of cli.train (then one
# resumed), the deploy Tester's metrics against the training-form eval of
# the same checkpoint (relative), the card's camera fit against the CPU's
# (relative L2)
ENGINE_EPOCHS = 2
DEPLOY_VS_TRAIN_TOL = 2e-2
CAMERA_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def kernel_label(mangled: str) -> str:
    """A ptxas entry name, shortened to the last component of its (nested)
    name and its integer template arguments, with `[f32]` for a float32
    instance: `cheby_proj_kernel<128,1>`, `band_hop_kernel<16,0,0>[f32]`."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I(13__nv_bfloat16|f)?((?:L[a-z]+\d+E)*)E", mangled[i:])
    if args:
        ints = re.findall(r"L[a-z]+(\d+)E", args.group(2))
        name += f"<{','.join(ints)}>" if ints else ""
        name += "[f32]" if args.group(1) == "f" else ""
    return name


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


def bound(flops: int, bytes_: int, f32: bool = False):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the bf16 tensor-core rate (float32: the 3xTF32 rate)."""
    peak = PEAK_3XTF32_FLOPS if f32 else PEAK_BF16_FLOPS
    t_bytes, t_flops = bytes_ / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def _counters():
    from pose2mesh_release_tpu_torch.ops import fused_cheby, fused_cheby_train, hop, \
        strip_cheby, window_cheby
    return [m.launches for m in (fused_cheby, fused_cheby_train, hop, strip_cheby,
                                 window_cheby)]


def reset_launches():
    for counts in _counters():
        for key in counts:
            counts[key] = 0


def read_launches() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def expect(**counts) -> dict:
    """Every wrapper's launch count: `counts`, and 0 for the others."""
    return {k: counts.get(k, 0) for k in read_launches()}


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
    op = _make_level_op(L.tocsr(), "band", T, strip_h=128)
    assert op.band_k == 2, op.band_k
    return op


def restrip(op, strip_h: int):
    """The band level `op` packed again with strip tiles of strip_h rows."""
    import numpy as np
    import scipy.sparse as sp
    from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
    nbd, nt, T, _ = op.band_val.shape
    bv = op.band_val.float().cpu().numpy()
    d, t, r, c = np.nonzero(bv)
    L = sp.csr_matrix((bv[d, t, r, c], (t * T + r, (t + d - nbd // 2) * T + c)),
                      shape=(op.num_vertices,) * 2)
    return _make_level_op(L, "band", T, strip_h=strip_h)


def conv_case(op, fin, fout, epilogue, gen, dtype=None):
    """Inputs of one deploy conv on the card at batch BATCH, bf16 (or
    `dtype`): x (Vp, B, fin), W (3 fin, fout), b, and the epilogue's skip and
    skip_w (or None)."""
    import torch
    from pose2mesh_release_tpu_torch.models.meshnet import channel_interp_matrix

    dev, bf = "cuda", dtype or torch.bfloat16
    Vp = op.padded_vertices

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    x = randn(Vp, BATCH, fin, scale=0.5)
    W = randn(3 * fin, fout, scale=1.0 / math.sqrt(3 * fin))
    b = randn(fout, scale=0.1)
    skip = skip_w = None
    if epilogue == "skip_add":
        skip = randn(Vp, BATCH, fout, scale=0.5)
    elif epilogue == "skip_proj":
        fs = 2 * fout
        skip = randn(Vp, BATCH, fs, scale=0.5)
        skip_w = torch.from_numpy(channel_interp_matrix(fs, fout).T.copy()).to(dev, bf)
    return x, W, b, skip, skip_w


def check_conv(op, name, fin, fout, epilogue, gen, tag, dtype=None):
    """A group deploy kernel vs its plain version on the card, bf16 (or its
    `dtype` instance); returns the row of numbers."""
    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby as fc

    dtype = dtype or torch.bfloat16
    band = op.band_val.to("cuda", dtype)
    V, es = op.num_vertices, band.element_size()
    x, W, b, skip, skip_w = conv_case(op, fin, fout, epilogue, gen, dtype)
    kw = {"relu": epilogue != "final"}
    if name == "fused_cheby_conv":
        kw.update(skip=skip, skip_w=skip_w)
        kernel, plain = fc.fused_cheby_conv, fc.fused_cheby_conv_plain
    else:
        kernel, plain = fc.fused_cheby_conv_commuted, fc.fused_cheby_conv_commuted_plain
    f32 = {k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()}
    nnz = int(torch.count_nonzero(op.band_val))
    hop_cols = BATCH * (fin if name == "fused_cheby_conv" else fout)
    flops = 2 * 2 * nnz * hop_cols + 2 * V * BATCH * 3 * fin * fout
    if skip_w is not None:
        flops += 2 * V * BATCH * skip.shape[-1] * fout
    # bytes by the same rule as the operations: vertex tensors at the real
    # rows, the band operator at its nonzero values
    bytes_ = (nbytes(x[:V], None if skip is None else skip[:V], W, b, skip_w)
              + V * BATCH * fout * es + nnz * es)
    row = measure(
        tag, name, {"V": V, "band_k": op.band_k, "fin": fin, "fout": fout,
                    "epilogue": epilogue},
        lambda: kernel(band, x, W, b, **kw), lambda: plain(band, x, W, b, **kw),
        lambda: plain(band.float(), x.float(), W.float(), b.float(), **f32),
        ("y",), V, flops, bytes_, dtype=dtype)
    # its launches apart (not counted as launches)
    if name == "fused_cheby_conv":
        run, _ = fc.conv_launcher(band, x, W, b, kw["relu"], skip, skip_w)
        row["split_ms"] = split_ms(tag, "group", run, fc.CONV_STAGES, row["ms"])
    else:
        run, _ = fc.commuted_launcher(band, x, W, b, kw["relu"])
        row["split_ms"] = split_ms(tag, "commuted", run, fc.COMMUTED_STAGES, row["ms"])
    return row


def split_ms(tag, label, run, stages, whole_ms) -> dict:
    """Time each stage of a launcher alone (20 runs each) and print the split."""
    ms = {name: cuda_ms(lambda m=mask: run(m), 20) for name, mask in stages.items()}
    log(f"  {tag:10s} {label} split ms: " + " ".join(f"{n}={t:.4f}" for n, t in ms.items())
        + f" sum={sum(ms.values()):.4f} (whole call {whole_ms:.4f})")
    return ms


def check_train_conv(op, fin, fout, fold, stats, gen, tag, dtype=None):
    """K1 and K2 vs their plain versions on the card, bf16 (or their `dtype`
    instances, then also K1 and K2 run twice to equal bits); returns their
    two rows."""
    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft

    dev, bf = gen.device, dtype or torch.bfloat16
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
    info = {"V": V, "band_k": op.band_k, "fin": fin, "fout": fout, "in_fold": fold,
            "emit_stats": stats}
    k1 = measure(
        tag, "fused_cheby_conv_train", info,
        lambda: ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold,
                                          emit_stats=stats),
        lambda: ft.fused_cheby_conv_train_plain(band, x, W, b, in_fold=in_fold,
                                                emit_stats=stats),
        lambda: ft.fused_cheby_conv_train_plain(
            band.float(), x.float(), W.float(), b.float(), in_fold=fold32,
            emit_stats=stats),
        ("y", "sum_y", "sum_y2"), V,
        # two hops of u, the projection
        2 * 2 * nnz * BATCH * fin + 2 * V * BATCH * 3 * fin * fout,
        nbytes(x, W, b) + V * BATCH * fout * x.element_size() + band_bytes + fold_bytes
        + (2 * fout * 4 if stats else 0), dtype=dtype)
    k2 = measure(
        tag, "fused_cheby_conv_bwd", info,
        lambda: ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold),
        lambda: ft.fused_cheby_conv_bwd_plain(band, g, x, W, in_fold=in_fold),
        lambda: ft.fused_cheby_conv_bwd_plain(band.float(), g.float(), x.float(),
                                              W.float(), in_fold=fold32),
        ("dx", "dW", "db", "ds", "dc"), None,
        # two hops of g, the dx product, the dW product
        2 * 2 * nnz * BATCH * fout + 2 * 2 * V * BATCH * 3 * fout * fin,
        nbytes(g, x, W) + nbytes(x) + 3 * fin * fout * 4 + fout * 4 + band_bytes
        + (fold_bytes + 2 * fin * 4 if fold else 0), dtype=dtype)
    # each kernel's launches apart, on the same inputs (not counted as launches)
    run, _ = ft.train_launcher(band, x, W, b, in_fold, stats, False)
    k1_stages = {n: m for n, m in ft.TRAIN_STAGES.items() if fold or n != "fold"}
    k1["split_ms"] = split_ms(tag, "K1", run, k1_stages, k1["ms"])
    run, _ = ft.bwd_launcher(band, g, x, W, in_fold)
    k2["split_ms"] = split_ms(tag, "K2", run, ft.BWD_STAGES, k2["ms"])
    if dtype is not None:  # the ordered, atomic-free reductions: equal bits twice
        for row, fn in ((k1, lambda: ft.fused_cheby_conv_train(
                            band, x, W, b, in_fold=in_fold, emit_stats=stats)),
                        (k2, lambda: ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold))):
            a, c = fn(), fn()
            a, c = (a, c) if isinstance(a, tuple) else ((a,), (c,))
            row["bits_equal"] = all(torch.equal(u, v) for u, v in zip(a, c))
            row["ok"] = row["ok"] and row["bits_equal"]
        log(f"  {tag:10s} two runs, equal bits: K1 {k1['bits_equal']}, K2 {k2['bits_equal']}")
    return [k1, k2]


def measure(tag, name, info, kernel, plain, ref32, names, rows, flops, bytes_,
            library=None, timed=None, timed_plain=None, dtype=None):
    """Hold the kernel's outputs (the first `rows` rows of each, or all of
    them) against the float32 plain version, within KERNEL_TOL (a float32
    instance, `dtype` float32: within F32_KERNEL_TOL, bound at the 3xTF32
    rate); time kernel (or `timed`), plain version (or `timed_plain`) and
    library call.  Returns the row of numbers."""
    import torch
    out = kernel()
    torch.cuda.synchronize()
    ref = ref32()
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    errs = {n: rel_l2(a[:rows], r[:rows]) for n, a, r in zip(names, out, ref)}
    max_abs = float((out[0][:rows].float() - ref[0][:rows].float()).abs().max())
    finite = all(bool(torch.isfinite(a.float()).all()) for a in out)
    ms = cuda_ms(timed or kernel, 20)
    plain_ms = cuda_ms(timed_plain or plain, 5)
    library_ms = None if library is None else cuda_ms(library, 20)
    f32 = dtype is not None and dtype == torch.float32
    bound_ms, bound_by = bound(flops, bytes_, f32)
    tol = F32_KERNEL_TOL if f32 else KERNEL_TOL
    row = {"tag": tag, "name": name, **info, "batch": BATCH, "rel_l2": errs,
           "max_abs_err": max_abs, "ok": finite and max(errs.values()) <= tol,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": bytes_}
    log(f"  {tag:10s} {name:22s} {info} rel_l2 "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" max_abs={max_abs:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) library_ms="
        + ("null" if library_ms is None else f"{library_ms:.4f}")
        + f" {'ok' if row['ok'] else 'FAIL'}")
    return row


_library_dtype = {}


def sparse_csr(op, dtype):
    """The level's Laplacian as a torch sparse CSR matrix of nt*T rows, in
    `dtype`, or in float32 where the sparse product takes no `dtype`."""
    import warnings

    import torch
    nbd, nt, T, _ = op.band_val.shape
    d, t, r, c = torch.nonzero(op.band_val, as_tuple=True)
    vals = op.band_val[d, t, r, c]
    with warnings.catch_warnings():  # torch's notes on its beta sparse support
        warnings.simplefilter("ignore", UserWarning)
        L = torch.sparse_coo_tensor(torch.stack([t * T + r, (t + d - nbd // 2) * T + c]),
                                    vals, (nt * T, nt * T)).coalesce().to_sparse_csr()
    if dtype not in _library_dtype:
        try:
            probe = L.to(dtype)
            torch.sparse.mm(probe, torch.zeros(nt * T, 16, dtype=dtype, device=L.device))
            torch.cuda.synchronize()
            _library_dtype[dtype] = dtype
        except RuntimeError as e:
            log(f"  torch.sparse.mm takes no {dtype} here ({str(e).splitlines()[0]}); "
                f"library_ms in float32")
            _library_dtype[dtype] = torch.float32
    return L.to(_library_dtype[dtype])


def subtile_occupancy(op) -> dict:
    """What the hop engine multiplies at a level: the share of nonzero 16 x 16
    sub-tiles among the band blocks of in-range neighbour tiles, the nonzero
    sub-tiles per 16-row group (mean, max) and the share of groups with more
    than the HOP_CAP the engine keeps in registers."""
    import torch
    from pose2mesh_release_tpu_torch.ops.hop import HOP_CAP
    band = op.band_val.to("cuda")
    nbd, nt, T, _ = band.shape
    nz = band.reshape(nbd, nt, T // 16, 16, T // 16, 16).ne(0).any(5).any(3)
    src = (torch.arange(nt, device="cuda")[None, :] + torch.arange(nbd, device="cuda")[:, None]
           - nbd // 2)
    valid = (src >= 0) & (src < nt)
    per_group = (nz & valid[:, :, None, None]).sum((0, 3)).float()  # (nt, 8)
    return {"V": op.num_vertices, "band_k": op.band_k,
            "occupancy": float(nz[valid].float().mean()),
            "per_group_mean": float(per_group.mean()), "per_group_max": int(per_group.max()),
            "over_cap": float((per_group > HOP_CAP).float().mean())}


def check_hop(op, fin, gen, tag, dtype=None):
    """K4 at one conv of the unfused path: the hop forward and backward
    through its autograd Function vs the plain version, bf16 (or its `dtype`
    instance, then also run twice to equal bits); timed as the conv's two
    hops (x and a cotangent of its shape), beside two torch.sparse.mm calls
    on the level's CSR Laplacian."""
    import torch
    from pose2mesh_release_tpu_torch.ops import hop as hp
    dev, bf = "cuda", dtype or torch.bfloat16
    band = op.band_val.to(dev, bf)
    V, Vp = op.num_vertices, op.padded_vertices
    x = (torch.randn(Vp, BATCH, fin, generator=gen, device=dev) * 0.5).to(bf)
    g = torch.randn(Vp, BATCH, fin, generator=gen, device=dev).to(bf)

    def fwd_bwd(hop_fn, b_, x_, g_):
        xr = x_.clone().requires_grad_()
        saved, hp.hop = hp.hop, hop_fn
        try:
            y = hp.banded_hop(b_, xr)
            y.backward(g_)
        finally:
            hp.hop = saved
        return y.detach(), xr.grad

    L = sparse_csr(op.to(dev), bf)
    x2 = x.reshape(Vp, -1).to(L.dtype)
    nnz = int(torch.count_nonzero(op.band_val))
    row = measure(
        tag, "banded_hop", {"V": V, "Vp": Vp, "band_k": op.band_k, "F": fin,
                            "library": f"torch.sparse.mm {L.dtype}"},
        lambda: fwd_bwd(hp.hop, band, x, g), lambda: fwd_bwd(hp.hop_plain, band, x, g),
        lambda: fwd_bwd(hp.hop_plain, band.float(), x.float(), g.float()),
        ("y", "dx"), V, 2 * 2 * nnz * BATCH * fin,
        # x and g read, y and dx written (real rows), the operator's nonzeros
        4 * nbytes(x[:V]) + nnz * band.element_size(),
        library=lambda: (torch.sparse.mm(L, x2), torch.sparse.mm(L, x2)),
        timed=lambda: (hp.hop(band, x), hp.hop(band, g)),
        timed_plain=lambda: (hp.hop_plain(band, x), hp.hop_plain(band, g)), dtype=dtype)
    if dtype is not None:
        bits_twice(row, tag, lambda: hp.hop(band, x))
    return row


def bits_twice(row, tag, fn):
    """A float32 instance run twice on the same inputs: equal bits, or the
    row fails."""
    import torch
    row["bits_equal"] = torch.equal(fn(), fn())
    row["ok"] = row["ok"] and row["bits_equal"]
    log(f"  {tag:10s} two runs, equal bits: {row['bits_equal']}")


def check_strip(op, fin, fout, epilogue, gen, tag, dtype=None):
    """K5: the strip conv in the mode of the JAX rule vs its plain version,
    bf16 (or its `dtype` instance, then also run twice to equal bits)."""
    import torch
    from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
    dev = "cuda"
    V, Vp, h = op.num_vertices, op.padded_vertices, op.strip_h
    S, off = op.strip_val.to(dev, dtype or torch.bfloat16), op.strip_off.to(dev)
    es = S.element_size()
    x, W, b, skip, skip_w = conv_case(op, fin, fout, epilogue, gen, dtype)
    mode = sc.strip_mode(fin, fout)
    if mode == "commuted":
        W3 = W.view(3, fin, fout)
        W = torch.cat([W3[0] - W3[2], W3[1], W3[2]])
    kw = dict(mode=mode, relu=epilogue != "final", skip=skip, skip_w=skip_w)
    f32 = {k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()}
    nnz = int(torch.count_nonzero(op.band_val))
    flops = (2 * 2 * nnz * BATCH * (fin if mode == "basis" else fout)
             + 2 * V * BATCH * 3 * fin * fout
             + (0 if skip_w is None else 2 * V * BATCH * skip.shape[-1] * fout))
    y_bytes = V * BATCH * fout * es
    bytes_ = (nbytes(x[:V], None if skip is None else skip[:V], W, b, skip_w, off)
              + y_bytes + nnz * es)
    row = measure(
        tag, "strip_cheby_conv", {"V": V, "band_k": op.band_k, "strip_h": h,
                                  "W": S.shape[1], "mode": mode, "fin": fin,
                                  "fout": fout, "epilogue": epilogue},
        lambda: sc.strip_cheby_conv(S, off, h, x, W, b, **kw),
        lambda: sc.strip_cheby_conv_plain(S, off, h, x, W, b, **kw),
        lambda: sc.strip_cheby_conv_plain(S.float(), off, h, x.float(), W.float(),
                                          b.float(), **f32),
        ("y",), V, flops, bytes_, dtype=dtype)
    # its launches apart (not counted as launches)
    run, _ = sc.strip_launcher(S, off, h, x, W, b, mode, kw["relu"], skip, skip_w)
    row["split_ms"] = split_ms(tag, f"strip {mode}", run, sc.STRIP_STAGES[mode], row["ms"])
    if dtype is not None:
        bits_twice(row, tag, lambda: sc.strip_cheby_conv(S, off, h, x, W, b, **kw))
    return row


def check_window(op, fin, fout, epilogue, gen, tag, dtype=None):
    """K6: the window conv (basis order) vs its plain version, bf16 (or its
    `dtype` instance, then also run twice to equal bits)."""
    import torch
    from pose2mesh_release_tpu_torch.ops import window_cheby as wc
    V = op.num_vertices
    win, woff = wc.window_cat(op.band_val.to("cuda", dtype or torch.bfloat16))
    es = win.element_size()
    x, W, b, skip, skip_w = conv_case(op, fin, fout, epilogue, gen, dtype)
    kw = dict(relu=epilogue != "final", skip=skip, skip_w=skip_w)
    f32 = {k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()}
    nnz = int(torch.count_nonzero(op.band_val))
    flops = (2 * 2 * nnz * BATCH * fin + 2 * V * BATCH * 3 * fin * fout
             + (0 if skip_w is None else 2 * V * BATCH * skip.shape[-1] * fout))
    bytes_ = (nbytes(x[:V], None if skip is None else skip[:V], W, b, skip_w, woff)
              + V * BATCH * fout * es + nnz * es)
    row = measure(
        tag, "window_cheby_conv", {"V": V, "band_k": op.band_k, "fin": fin,
                                   "fout": fout, "epilogue": epilogue},
        lambda: wc.window_cheby_conv(win, woff, x, W, b, **kw),
        lambda: wc.window_cheby_conv_plain(win, woff, x, W, b, **kw),
        lambda: wc.window_cheby_conv_plain(win.float(), woff, x.float(), W.float(),
                                           b.float(), **f32),
        ("y",), V, flops, bytes_, dtype=dtype)
    # its launches apart (not counted as launches)
    run, _ = wc.window_launcher(win, woff, x, W, b, kw["relu"], skip, skip_w)
    row["split_ms"] = split_ms(tag, "window", run, wc.WINDOW_STAGES, row["ms"])
    if dtype is not None:
        bits_twice(row, tag, lambda: wc.window_cheby_conv(win, woff, x, W, b, **kw))
    return row


def check_keep_basis(op, fin, fout, gen, tag, dtype=None):
    """K1b: K1 with keep_basis (y, z1, z2) vs its plain version, bf16 (or its
    `dtype` instance); the one call held against it is counted as this
    variant's launch."""
    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
    dev, bf = "cuda", dtype or torch.bfloat16
    band = op.band_val.to(dev, bf)
    V = op.num_vertices
    x = (torch.randn(V, BATCH, fin, generator=gen, device=dev) * 0.5).to(bf)
    W = (torch.randn(3 * fin, fout, generator=gen, device=dev) / math.sqrt(3 * fin)).to(bf)
    b = (torch.randn(fout, generator=gen, device=dev) * 0.1).to(bf)
    reset_launches()
    ft.fused_cheby_conv_train(band, x, W, b, keep_basis=True)
    torch.cuda.synchronize()
    launches = read_launches()["fused_cheby_conv_train"]
    nnz = int(torch.count_nonzero(op.band_val))
    row = measure(
        tag, "fused_cheby_conv_train(keep_basis)", {"V": V, "fin": fin, "fout": fout},
        lambda: ft.fused_cheby_conv_train(band, x, W, b, keep_basis=True),
        lambda: ft.fused_cheby_conv_train_plain(band, x, W, b, keep_basis=True),
        lambda: ft.fused_cheby_conv_train_plain(band.float(), x.float(), W.float(),
                                                b.float(), keep_basis=True),
        ("y", "z1", "z2"), V,
        2 * 2 * nnz * BATCH * fin + 2 * V * BATCH * 3 * fin * fout,
        nbytes(x, W, b) + (V * BATCH * (fout + 2 * fin) + nnz) * x.element_size(),
        dtype=dtype)
    row["launches"] = launches
    log(f"  {tag:10s} keep_basis: {launches} launch of the check")
    return row


def plain_versions(path):
    """(module, attribute, plain version) swaps that run `path`'s band convs
    through the plain PyTorch versions."""
    from pose2mesh_release_tpu_torch.models import meshnet
    from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
    from pose2mesh_release_tpu_torch.ops import hop as hp
    from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
    from pose2mesh_release_tpu_torch.ops import window_cheby as wc
    return {
        "group": [(meshnet, "fused_cheby_conv", fc.fused_cheby_conv_plain),
                  (meshnet, "fused_cheby_conv_commuted", fc.fused_cheby_conv_commuted_plain)],
        "strip": [(meshnet, "strip_cheby_conv", sc.strip_cheby_conv_plain)],
        "window": [(meshnet, "window_cheby_conv", wc.window_cheby_conv_plain)],
        "unfused": [(hp, "hop", hp.hop_plain)],
    }[path]


def plain_forward(path, step, art, pose2d):
    """One forward of `path` through the plain versions: (outputs, ms)."""
    import torch
    swaps = plain_versions(path)
    saved = [getattr(m, a) for m, a, _ in swaps]
    for m, a, fn in swaps:
        setattr(m, a, fn)
    try:
        ref = step(art, pose2d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(art, pose2d)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (m, a, _), fn in zip(swaps, saved):
            setattr(m, a, fn)
    return ref, ms


def drive_path(path, deploy, batches, group_out, card, paths=None, cuda_counts=None,
               shapes=None, tol=FORWARD_TOL):
    """Phase 3 for a further path: a model built for the path with the group
    model's weights, warm-up, the counted requests (one per batch), the plain
    forward of the same path and the group forward's outputs, within `tol`.
    paths, cuda_counts, shapes: the model's PATHS, PATH_CUDA_LAUNCHES and
    output shapes (default: SMPL's)."""
    import torch
    from pose2mesh_release_tpu_torch.deploy import on_path
    paths, cuda_counts = paths or PATHS, cuda_counts or PATH_CUDA_LAUNCHES
    shapes = shapes or [(BATCH, 6890, 3), (BATCH, 17, 3), (BATCH, 17, 3)]
    kw, wrapper, per_forward = paths[path]
    step, art_bf = on_path(deploy, **kw).eval_step, deploy.art_compute
    step(art_bf, batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    outs, times = [], []
    for p in batches:
        t0 = time.perf_counter()
        outs.append(step(art_bf, p))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    log(f"  {path}: {len(batches)} requests of batch {BATCH}: ms per batch "
        f"{[round(t, 3) for t in times]} ({card}); launches {launches}")
    want = expect(**{wrapper: per_forward * len(batches)})
    if launches != want:
        raise SystemExit(f"{path}: launch counts {launches} != {want}")
    for out in outs:
        assert [tuple(t.shape) for t in out] == list(shapes), path
        assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in out)
    cuda_launches = kernel_launches(lambda: step(art_bf, batches[0]))
    engine = sum(n for name, n in cuda_launches.items()
                 if any(k in name for k in ENGINE_KERNELS))
    log(f"  {path}: CUDA launches in one forward (torch.profiler): hop engine and "
        f"projection {engine} (expected {cuda_counts[path]}), all kernels "
        f"{sum(cuda_launches.values())}")
    if engine != cuda_counts[path]:
        raise SystemExit(f"{path}: {engine} hop engine and projection launches per forward, "
                         f"expected {cuda_counts[path]}: {cuda_launches}")
    ref, plain_ms = plain_forward(path, step, art_bf, batches[0])
    errs = {"mesh_vs_plain": rel_l2(outs[0][0], ref[0]),
            "reg_pose_vs_plain": rel_l2(outs[0][1], ref[1]),
            "mesh_vs_group": rel_l2(outs[0][0], group_out[0]),
            "reg_pose_vs_group": rel_l2(outs[0][1], group_out[1])}
    log(f"  {path}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tolerance {tol}); plain forward {plain_ms:.3f} ms")
    if max(errs.values()) > tol:
        raise SystemExit(f"{path}: forward disagrees: {errs}")
    return {"card": card, "batch": BATCH, "ms_per_batch": times, "launches": launches,
            "cuda_launches_per_forward": cuda_launches, "engine_launches_per_forward": engine,
            "plain_forward_ms": plain_ms, **errs}


def kernel_launches(fn) -> dict:
    """The CUDA kernel launches of one call of fn, by kernel name, counted by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            counts[evt.key] = counts.get(evt.key, 0) + evt.count
    return counts


def train_step_vs_plain(setup, state):
    """One train step's loss and gradients from the model's current state,
    through the kernels and through the plain versions of K1, K2 and the hop
    K4 on the card (lr 0; the same dropout draws; the parameters, BatchNorm
    statistics and optimizer state are put back after each step).  Returns
    (loss with kernels, loss plain, {param: rel L2 of its gradient}, the
    biases left out, ms of the plain step)."""
    import copy

    import torch
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
    from pose2mesh_release_tpu_torch.ops import hop as hp

    model, opt = state.model, state.optimizer
    snapshot = copy.deepcopy(model.state_dict())
    opt_snapshot = copy.deepcopy(opt.state_dict())
    n_convs = len(model.pose2mesh.cl)
    # a bias followed by a training BatchNorm has an exact gradient of zero
    zero_grad_biases = {f"pose2mesh.cl.{i}.bias" for i in range(n_convs - 1)} | {
        f"pose_lifter.linear_stages.{j}.w1.bias"
        for j in range(len(model.pose_lifter.linear_stages))}

    def one_step():
        model.load_state_dict(snapshot)
        opt.load_state_dict(opt_snapshot)
        gen = torch.Generator(device=setup.batch["pose2d"].device).manual_seed(123)
        t0 = time.perf_counter()
        _, losses = setup.train_step(state, setup.art_compute, setup.batch, 0.0, True, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
        return float(losses["total"]), grads, ms

    loss_k, grads_k, _ = one_step()
    kernels = ft.fused_cheby_conv_train, ft.fused_cheby_conv_bwd, hp.hop
    ft.fused_cheby_conv_train = ft.fused_cheby_conv_train_plain
    ft.fused_cheby_conv_bwd = ft.fused_cheby_conv_bwd_plain
    hp.hop = hp.hop_plain
    try:
        loss_p, grads_p, plain_ms = one_step()
    finally:
        ft.fused_cheby_conv_train, ft.fused_cheby_conv_bwd, hp.hop = kernels
    model.load_state_dict(snapshot)
    opt.load_state_dict(opt_snapshot)
    errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in grads_p if n not in zero_grad_biases}
    left_out = {n: (float(grads_k[n].norm()), float(grads_p[n].norm()))
                for n in sorted(zero_grad_biases)}
    return loss_k, loss_p, errs, left_out, plain_ms


def step_check(label, loss_k, loss_p, grad_errs, left_out, plain_step_ms,
               loss_tol=STEP_LOSS_TOL, grad_tol=STEP_GRAD_TOL) -> dict:
    """Print and hold one train_step_vs_plain comparison; returns its
    figures."""
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    worst = sorted(grad_errs.items(), key=lambda kv: -kv[1])[:5]
    log(f"  step vs plain-version step ({label}): total {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_err:.2e}, tolerance {loss_tol}); gradient rel_l2 max "
        f"{worst[0][1]:.3e} (tolerance {grad_tol}), worst {worst}; "
        f"plain step {plain_step_ms:.3f} ms")
    log(f"  biases feeding a BatchNorm (|grad| kernels, plain): "
        f"{ {n: (round(a, 8), round(b, 8)) for n, (a, b) in left_out.items()} }")
    if not (loss_err <= loss_tol and worst[0][1] <= grad_tol):
        raise SystemExit(f"the train step ({label}) disagrees with the plain-version step")
    return {"loss_rel_err": loss_err, "worst": worst, "grad_rel_l2": grad_errs,
            "zero_grad_biases": left_out, "plain_step_ms": plain_step_ms}


def mano_kernels(gen, card):
    """Phase 6: every kernel of the MANO path at its band level, against its
    plain version: the 4 deploy convs on each fused path and the unfused
    path's hops, the 4 train convs (K1, K2).  Returns (deploy, rows)."""
    import torch
    from pose2mesh_release_tpu_torch.deploy import mano_deploy_forward
    t0 = time.time()
    deploy = mano_deploy_forward(dtype=torch.bfloat16, device="cuda", seed=0)
    op = deploy.art.mesh_ops[0]
    log(f"phase 6: MANO kernels vs plain, batch {BATCH}, tolerance rel_l2 <= {KERNEL_TOL} "
        f"(set-up {time.time() - t0:.1f} s); levels "
        f"{[(o.kind, o.num_vertices, o.padded_vertices, o.band_k) for o in deploy.art.mesh_ops]}"
        f", strip {tuple(op.strip_val.shape)} at h {op.strip_h}")
    o = subtile_occupancy(op)
    log(f"  hop engine sub-tiles at V={o['V']}: {o['occupancy']:.4f} nonzero, per 16-row "
        f"group mean {o['per_group_mean']:.2f} max {o['per_group_max']}, share over the "
        f"register slots {o['over_cap']:.4f}")
    rows = [check_conv(op, name, fin, fout, ep, gen, f"mano{i}")
            for i, (name, fin, fout, ep) in enumerate(MANO_DEPLOY_CONVS)]
    rows += [check_strip(op, fin, fout, ep, gen, f"mano_strip{i}")
             for i, (_, fin, fout, ep) in enumerate(MANO_DEPLOY_CONVS)]
    rows += [check_window(op, fin, fout, ep, gen, f"mano_window{i}")
             for i, (_, fin, fout, ep) in enumerate(MANO_DEPLOY_CONVS)]
    rows += [check_hop(op, fin, gen, f"mano_hop{i}")
             for i, (_, fin, _, _) in enumerate(MANO_DEPLOY_CONVS)]
    for i, conv in enumerate(MANO_TRAIN_CONVS):
        rows += check_train_conv(op, *conv, gen, f"mano_train{i}")
    bad = [(r["tag"], r["name"]) for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"MANO kernel check failed: {bad}")
    return deploy, rows


def mano_forward(deploy, card) -> dict:
    """Phase 7: the MANO deploy forward, 4 requests on the group path against
    its plain forward, one request on each further path against the group
    forward, exact call counts."""
    import torch
    eval_step, art_bf = deploy.eval_step, deploy.art_compute
    g = torch.Generator().manual_seed(2)
    batches = [torch.randn(BATCH, 21, 2, generator=g).cuda() for _ in range(REQUESTS)]
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
    log(f"phase 7: MANO deploy forward, {REQUESTS} requests of batch {BATCH}: ms per batch "
        f"{[round(t, 3) for t in times]} ({card}); launches {launches}")
    want = expect(fused_cheby_conv=2 * REQUESTS, fused_cheby_conv_commuted=2 * REQUESTS)
    if launches != want:
        raise SystemExit(f"MANO: launch counts {launches} != {want}")
    for out in outs:
        assert [tuple(t.shape) for t in out] == MANO_SHAPES
        assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in out)
    ref, plain_ms = plain_forward("group", eval_step, art_bf, batches[0])
    errs = {"mesh_vs_plain": rel_l2(outs[0][0], ref[0]),
            "reg_pose_vs_plain": rel_l2(outs[0][1], ref[1])}
    log(f"  MANO group: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tolerance {FORWARD_TOL}); plain forward {plain_ms:.3f} ms; mesh mm range "
        f"[{float(outs[0][0].min()):.2f}, {float(outs[0][0].max()):.2f}]")
    if max(errs.values()) > FORWARD_TOL:
        raise SystemExit(f"MANO: forward disagrees with the plain forward: {errs}")
    report = {"group": {"card": card, "batch": BATCH, "ms_per_batch": times,
                        "launches": launches, "plain_forward_ms": plain_ms, **errs}}
    for path in MANO_PATHS:
        report[path] = drive_path(path, deploy, batches[:1], outs[0], card, MANO_PATHS,
                                  MANO_PATH_CUDA_LAUNCHES, MANO_SHAPES)
    return report


def mano_train(card):
    """Phase 8: the MANO train step (mano_train_setup, LBS GT on the card):
    the step against the plain-K1/K2 step from the fresh state, then 1
    warm-up and 4 counted steps.  Returns (setup, report)."""
    import torch
    from pose2mesh_release_tpu_torch.train_setup import mano_train_setup
    t0 = time.time()
    setup = mano_train_setup(dtype=torch.bfloat16, device="cuda", seed=0, batch=BATCH)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    log(f"phase 8: MANO train setup (LBS GT on the card) in {setup_s:.2f} s; batch {BATCH}, "
        f"bf16, RMSprop lr {LR}, edge loss on")
    state = setup.state
    fresh = step_check("MANO, fresh state", *train_step_vs_plain(setup, state))
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
    launches = read_launches()
    log(f"  MANO warm-up total {float(warm['total']):.5f}; {TRAIN_STEPS} steps: ms per step "
        f"{[round(t, 3) for t in step_ms]} ({card}); totals "
        f"{[round(l['total'], 5) for l in step_losses]}; launches {launches}")
    want = expect(fused_cheby_conv_train=4 * TRAIN_STEPS, fused_cheby_conv_bwd=4 * TRAIN_STEPS)
    if launches != want:
        raise SystemExit(f"MANO: launch counts {launches} != {want}")
    if not all(math.isfinite(v) for l in step_losses for v in l.values()):
        raise SystemExit(f"MANO: non-finite loss: {step_losses}")
    return setup, {"card": card, "batch": BATCH, "lr": LR, "setup_s": setup_s,
                   "ms_per_step": step_ms, "losses": step_losses, "launches": launches,
                   "fresh_state": fresh}


def face_backward(label, art, gen) -> dict:
    """Phase 9 at one mesh: the face corners' two backwards (the banded
    selector product over face_perm / face_sel, and the index gathers'
    index-add) on float32 batch-BATCH meshes: the gradient of the normal +
    edge losses through each, and each backward alone timed with CUDA
    events."""
    import torch
    from pose2mesh_release_tpu_torch.core import losses as L
    faces, V = art.faces, art.num_vertices
    pred = torch.randn(BATCH, V, 3, generator=gen, device="cuda") * 0.1
    gt = torch.randn(BATCH, V, 3, generator=gen, device="cuda") * 0.1
    routes = {"band": {"face_band": (art.face_perm, art.face_sel, art.vertex_gather)},
              "index_add": {}}
    cot = torch.randn(BATCH, faces.shape[0], 3, 3, generator=gen, device="cuda")
    grads, backward = {}, {}
    for name, kw in routes.items():
        p = pred.clone().requires_grad_()
        c = L._face_corners(p, faces, **kw)
        loss = (L.normal_vector_loss(p, gt, faces, corners=c)
                + L.edge_length_loss(p, gt, faces, corners=c))
        (grads[name],) = torch.autograd.grad(loss, p)
        # the corners' backward alone, for a fixed cotangent
        p = pred.clone().requires_grad_()
        c = L._face_corners(p, faces, **kw)
        dot = sum((c[i] * cot[:, :, i]).sum() for i in range(3))
        backward[name] = (lambda d=dot, q=p: torch.autograd.grad(d, q, retain_graph=True))
    err = rel_l2(grads["band"], grads["index_add"])
    # wall ms per call: the least of 5 windows of 50 calls, the routes
    # alternating; device ms: the CUDA kernels' time per call
    ms = {name: [] for name in routes}
    for rep in range(5):
        for name in (routes if rep % 2 == 0 else list(routes)[::-1]):
            ms[name].append(cuda_ms(backward[name], 50))
    wall = {name: min(t) for name, t in ms.items()}
    device = {name: device_ms(fn) for name, fn in backward.items()}
    W = tuple(art.face_sel.shape)
    log(f"  {label}: V={V} F={faces.shape[0]} face_sel {W}: gradient band vs index-add "
        f"rel_l2={err:.3e} (tolerance {FACE_GRAD_TOL}); backward ms (CUDA events, least of "
        f"5 x 50 calls) band={wall['band']:.4f} index_add={wall['index_add']:.4f}; device ms "
        f"(torch.profiler) band={device['band']:.4f} index_add={device['index_add']:.4f}; "
        f"every window {ms}")
    if not err <= FACE_GRAD_TOL:
        raise SystemExit(f"{label}: the face backwards disagree ({err})")
    return {"V": V, "faces": int(faces.shape[0]), "face_sel": W, "grad_rel_l2": err,
            "ms": wall, "ms_windows": ms, "device_ms": device}


def device_ms(fn, n: int = 10) -> float:
    """The CUDA kernels' time per call of fn over n calls, summed by
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
    return total / 1e3 / n


def gt_synthesis(label, params, gen) -> dict:
    """Phase 10 at one body model: posed_mesh_rotated at batch BATCH on the
    card against the same call on the CPU (float32), and its ms."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.data.gt_synth import posed_mesh_rotated
    from pose2mesh_release_tpu_torch.train_setup import mano_gt_inputs
    J = params.num_joints
    pose, shape = mano_gt_inputs(BATCH, np.random.default_rng(0))
    pose = np.resize(pose, (BATCH, 3 * J)).astype(np.float32)
    R = torch.eye(3).expand(BATCH, 3, 3)
    t = torch.tensor([0.0, 0.0, 500.0]).expand(BATCH, 3)
    args = [torch.from_numpy(pose), torch.from_numpy(shape), R, t]
    gpu = [a.cuda() for a in args]
    p_gpu, p_cpu = params.to("cuda"), params.to("cpu")
    with torch.no_grad():
        out = posed_mesh_rotated(p_gpu, *gpu)
        ref = posed_mesh_rotated(p_cpu, *args)
        err = max(float((o.cpu() - r).abs().max()) for o, r in zip(out, ref))
        ms = cuda_ms(lambda: posed_mesh_rotated(p_gpu, *gpu), 20)
    log(f"  {label}: V={params.num_vertices} J={J}: card vs CPU max abs {err:.3e} mm "
        f"(tolerance {GT_TOL_MM}); {ms:.4f} ms per batch of {BATCH}")
    if not err <= GT_TOL_MM:
        raise SystemExit(f"{label}: GT synthesis on the card disagrees with the CPU ({err} mm)")
    return {"V": params.num_vertices, "J": J, "max_abs_mm": err, "ms": ms}


def mano_table(rows) -> list:
    """Per kernel of the MANO path: its calls per pass and the sums over that
    pass's shapes (the kernel table's rule)."""
    out = []
    for name, launches in MANO_LAUNCHES.items():
        mine = [r for r in rows if r["name"] == name]
        if not mine:
            continue
        out.append({"name": name, "launches": launches,
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": sum(r["ms"] for r in mine),
                    "plain_ms": sum(r["plain_ms"] for r in mine),
                    "bound_ms": sum(r["bound_ms"] for r in mine),
                    "library_ms": (None if any(r["library_ms"] is None for r in mine)
                                   else sum(r["library_ms"] for r in mine)),
                    "shapes_per_pass": len(mine)})
    return out

def _dump(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def local_regressor(template, num_joints: int, seed: int, k: int = 8):
    """(num_joints, V) regressor whose rows average k neighbouring vertices
    of the template around random centres, so the joints spread over the
    body as the real regressors' do."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centres = rng.choice(len(template), num_joints, replace=False)
    dist = ((template[None] - template[centres][:, None]) ** 2).sum(-1)
    near = np.argsort(dist, axis=1)[:, :k]
    w = rng.random((num_joints, k)) + 0.5
    reg = np.zeros((num_joints, len(template)), np.float32)
    reg[np.arange(num_joints)[:, None], near] = w / w.sum(1, keepdims=True)
    return reg


def write_stand_in_data(root: str, seed: int = 0, device: str = "cuda") -> None:
    """Stand-in annotation files in the JSON layouts of tests/test_data.py's
    fixtures, DATA_RECORDS records each (FreiHAND HAND_RECORDS), under
    root/<dataset>, and the H36M and COCO regressors where SMPL(data_dir=root)
    reads them (root/Human36M, root/COCO, the reference's data layout).
    Human36M's joint_3d (world mm), COCO's keypoints and MuCo's
    keypoints_cam are regressed from each record's stand-in SMPL mesh (LBS
    on `device`), so every record's fit error is ~0 and it keeps its mesh
    supervision."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.gt_synth import posed_mesh_world
    from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
    from pose2mesh_release_tpu_torch.data.muco import MUCO_JOINTS_NAME
    rng = np.random.default_rng(seed)
    n = DATA_RECORDS
    template = SMPL().v_template
    regs = {"Human36M/J_regressor_h36m_correct.npy": local_regressor(template, 17, 21),
            "COCO/J_regressor_coco.npy": local_regressor(template, 17, 22)}
    for rel, reg in regs.items():
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        np.save(os.path.join(root, rel), reg)
    h36m_reg, coco_reg = regs["Human36M/J_regressor_h36m_correct.npy"], \
        regs["COCO/J_regressor_coco.npy"]
    params = SMPL().layer().to(device)

    def draw(trans_z: float):
        pose = (rng.standard_normal((n, 72)) * 0.1).astype(np.float32)
        shape = (rng.standard_normal((n, 10)) * 0.5).astype(np.float32)
        trans = np.tile(np.float32([0.0, 0.0, trans_z]), (n, 1))
        with torch.no_grad():
            mesh, _ = posed_mesh_world(params, *(torch.from_numpy(a).to(device)
                                                 for a in (pose, shape, trans)))
        return pose, shape, trans, mesh.cpu().numpy()

    # Human36M, subject 1 (train, debug): camera R = I, t = (0, 0, 5 m)
    pose, shape, trans, mesh = draw(0.0)
    images, anns, joints, smpl_p = [], [], {"2": {"1": {}}}, {"2": {"1": {}}}
    for i in range(n):
        frame = i * 5
        images.append({"id": i, "file_name": f"s_01_act_02_subact_01_ca_01_{frame:06d}.jpg",
                       "width": 1000, "height": 1000, "subject": 1, "action_idx": 2,
                       "subaction_idx": 1, "frame_idx": frame, "cam_idx": 1})
        anns.append({"id": i, "image_id": i, "bbox": [300.0, 300.0, 400.0, 400.0]})
        joints["2"]["1"][str(frame)] = (h36m_reg @ mesh[i]).tolist()
        smpl_p["2"]["1"][str(frame)] = {"pose": pose[i].tolist(), "shape": shape[i].tolist(),
                                        "trans": trans[i].tolist()}
    base = os.path.join(root, "Human36M", "annotations", "Human36M_subject1")
    _dump(base + "_data.json", {"images": images, "annotations": anns})
    _dump(base + "_camera.json", {"1": {"R": np.eye(3).tolist(), "t": [0.0, 0.0, 5000.0],
                                        "f": [1500.0, 1500.0], "c": [500.0, 500.0]}})
    _dump(base + "_joint_3d.json", joints)
    _dump(base + "_smpl_param.json", smpl_p)

    # COCO: keypoints = the weak-perspective projection of the COCO joints
    pose, shape, _, mesh = draw(0.0)
    images, anns, smplify = [], [], {}
    for i in range(n):
        kp = np.full((17, 3), 2.0, np.float32)
        kp[:, :2] = (coco_reg @ mesh[i])[:, :2] / 1000.0 * 150.0 + 250.0
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 640, "height": 480})
        anns.append({"id": i, "image_id": i, "iscrowd": 0, "num_keypoints": 17,
                     "bbox": [100.0, 100.0, 300.0, 300.0], "keypoints": kp.flatten().tolist()})
        smplify[str(i)] = {"smpl_param": {"pose": pose[i].tolist(), "shape": shape[i].tolist()},
                           "cam_param": {"s": [150.0], "t": [250.0, 250.0]}}
    coco = os.path.join(root, "COCO", "annotations")
    _dump(os.path.join(coco, "person_keypoints_train2017.json"),
          {"images": images, "annotations": anns})
    _dump(os.path.join(coco, "coco_smplify_train.json"), smplify)

    # MuCo: one person per image, 3 m away; the H36M-named keypoints_cam
    # are the H36M joints of the mesh
    pose, shape, trans, mesh = draw(3.0)
    images, anns, smpl_p = [], [], {}
    for i in range(n):
        h36m = h36m_reg @ mesh[i]
        kp_cam = rng.standard_normal((21, 3)) * 200 + [0.0, 0.0, 3000.0]
        for m, name in enumerate(MUCO_JOINTS_NAME):
            if name in HUMAN36.joints_name:
                kp_cam[m] = h36m[HUMAN36.joints_name.index(name)]
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 2048, "height": 2048,
                       "f": [1500.0, 1500.0], "c": [1024.0, 1024.0]})
        anns.append({"id": i, "image_id": i, "keypoints_cam": kp_cam.tolist(),
                     "keypoints_img": (rng.random((21, 2)) * 2000).tolist(),
                     "bbox": [500.0, 500.0, 800.0, 800.0]})
        smpl_p[str(i)] = {"pose": pose[i].tolist(), "shape": shape[i].tolist(),
                          "trans": trans[i].tolist()}
    _dump(os.path.join(root, "MuCo", "data", "MuCo-3DHP.json"),
          {"images": images, "annotations": anns})
    _dump(os.path.join(root, "MuCo", "data", "smpl_param.json"), smpl_p)

    # PW3D (test): one sequence, one person 4 m away, genders alternating
    images, anns = [], []
    for i in range(n):
        images.append({"id": i, "file_name": f"image_{i:05d}.jpg", "width": 1920,
                       "height": 1080, "sequence": "courtyard_stand_in_00",
                       "cam_param": {"focal": [1960.0, 1969.0], "princpt": [960.0, 540.0]}})
        anns.append({"id": i, "image_id": i, "person_id": 0,
                     "bbox": [700.0, 200.0, 400.0, 700.0],
                     "smpl_param": {"pose": (rng.standard_normal(72) * 0.1).tolist(),
                                    "shape": (rng.standard_normal(10) * 0.3).tolist(),
                                    "trans": [0.0, 0.0, 4.0],
                                    "gender": "female" if i % 2 else "male"}})
    _dump(os.path.join(root, "PW3D", "3DPW_latest_test.json"),
          {"images": images, "annotations": anns})

    # FreiHAND (train): the MANO hand 0.5 m away
    images, anns, data = [], [], {}
    for i in range(HAND_RECORDS):
        images.append({"id": i, "file_name": f"rgb/{i:08d}.jpg", "width": 224,
                       "height": 224, "db_idx": i})
        anns.append({"id": i, "image_id": i, "bbox": [40.0, 40.0, 150.0, 150.0]})
        data[str(i)] = {
            "cam_param": {"focal": [500.0, 500.0], "princpt": [112.0, 112.0],
                          "R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.5]},
            "mano_param": {"pose": (rng.standard_normal(48) * 0.2).tolist(),
                           "shape": (rng.standard_normal(10) * 0.5).tolist()},
            "joint_3d": (rng.standard_normal((21, 3)) * 50).tolist()}
    _dump(os.path.join(root, "FreiHAND", "freihand_train_coco.json"),
          {"images": images, "annotations": anns})
    _dump(os.path.join(root, "FreiHAND", "freihand_train_data.json"), data)


def build_datasets(root: str, device: str = "cuda") -> dict:
    """Phase 12.1: the six datasets on the card (GT synthesis there), each's
    build seconds, the graphs' level kinds, the share of valid samples."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.body.mano import MANO
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data import get_dataset_class
    smpl = SMPL(data_dir=root)
    mano = MANO()
    specs = {
        "Human36M": ("train", smpl, {"debug": True, "input_joint_name": "coco"}),
        "COCO": ("train", smpl, {}),
        "MuCo": ("train", smpl, {}),
        "PW3D": ("test", smpl, {}),
        "FreiHAND": ("train", mano, {"output_dir": os.path.join(root, "freihand_out")}),
    }
    dbs, build_s = {}, {}
    for name, (split, body, kw) in specs.items():
        t0 = time.time()
        dbs[name] = get_dataset_class(name)(split, data_dir=os.path.join(root, name),
                                            mesh_model=body, device=device, **kw)
        torch.cuda.synchronize()
        build_s[name] = time.time() - t0
    kinds = {name: [(op.kind, op.num_vertices) for op in ds.graph.mesh_ops]
             for name, ds in dbs.items()}
    valid = {name: float(np.mean(ds.fit_error <= ds.fitting_thr))
             if ds.fit_error is not None else 1.0 for name, ds in dbs.items()}
    n_all = sum(len(ds) for ds in dbs.values())
    share = sum(valid[name] * len(ds) for name, ds in dbs.items()) / n_all
    log(f"phase 12: datasets built on the card: "
        f"{ {n: (len(ds), round(build_s[n], 3)) for n, ds in dbs.items()} } "
        f"(records, build s; the first SMPL and the MANO build pack their pyramid)")
    log(f"  graph levels: SMPL {kinds['Human36M']}; MANO {kinds['FreiHAND']}")
    log(f"  share of samples with mesh_valid 1: {share:.4f} {valid}")
    smpl_kinds = [k for k, _ in kinds["Human36M"][:4]]
    if smpl_kinds != ["band", "band", "band", "dense"] or \
            [v for _, v in kinds["Human36M"][:4]] != [6890, 3475, 1849, 981]:
        raise SystemExit(f"the datasets' SMPL graph is not 6890/3475/1849 band, 981 dense: "
                         f"{kinds['Human36M']}")
    if any(k != "dense" for k, _ in kinds["FreiHAND"]):
        raise SystemExit(f"the MANO datasets' graph has a band level: {kinds['FreiHAND']}")
    if any(ds.graph is not dbs["Human36M"].graph for n, ds in dbs.items() if n != "FreiHAND"):
        raise SystemExit("the SMPL datasets do not share one cached graph")
    if share < 1.0:
        raise SystemExit(f"stand-in records lost their mesh supervision: {valid}")
    return {"dbs": dbs, "build_s": build_s, "levels": kinds, "valid_share": share,
            "valid": valid}


def _reseed(dbs, seed: int) -> None:
    """The datasets' Generators and numpy's global one (augm_params'
    rotation draw) reset alike before a run that is compared."""
    import numpy as np
    for ds in dbs:
        ds.rng = np.random.default_rng(seed)
    np.random.seed(seed)


def _first_batch(loader):
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()  # stops and joins the producer thread


def _leaves(batch) -> dict:
    inputs, targets, meta = batch
    return {**inputs, **targets, **meta}


def loader_ms(loader, epochs: int = 1) -> tuple:
    """(ms per batch the loader produces alone, batches): every batch of
    `epochs` epochs taken after one untimed epoch (the first launches of
    each op, the pinned buffers), nothing else run, the card synchronized
    at the end."""
    import torch
    for _batch in loader:
        pass
    torch.cuda.synchronize()
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for _batch in loader:
            n += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n, n


def data_train(data, card, resident_ms, device: str = "cuda") -> dict:
    """Phases 12.2-12.3: Trainer's default path, loader-fed steps, batches
    card vs CPU, the MANO step on its all-dense graph."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.data import BatchLoader, MultipleDatasets
    from pose2mesh_release_tpu_torch.data.loader import stack_samples, tree_to_device
    from pose2mesh_release_tpu_torch.train_setup import train_batch, train_setup_on
    dbs = data["dbs"]
    mix_dbs = [dbs["Human36M"], dbs["COCO"], dbs["MuCo"]]
    dev = torch.device(device)

    def mix_loader(workers, on=device, seed=0):
        return BatchLoader(MultipleDatasets(mix_dbs, make_same_len=True, seed=seed), BATCH,
                           shuffle=True, drop_last=True, num_workers=workers, seed=seed,
                           device=on)

    # the loaders alone: the per-sample path (a mix) and get_batch (one dataset)
    _reseed(mix_dbs, 0)
    per_sample_ms, n_ps = loader_ms(mix_loader(LOADER_WORKERS))
    one_thread_ms, _ = loader_ms(mix_loader(1))
    h36m_loader = BatchLoader(dbs["Human36M"], BATCH, shuffle=True, drop_last=True,
                              num_workers=LOADER_WORKERS, device=device)
    get_batch_ms, n_gb = loader_ms(h36m_loader, epochs=3)
    host = stack_samples([mix_dbs[0][i] for i in range(BATCH)])
    h2d = []
    for _ in range(10):
        t0 = time.perf_counter()
        tree_to_device(host, dev)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    h2d_bytes = sum(a.nbytes for part in host for a in part.values())
    log(f"phase 12: loader alone, batch {BATCH}: per-sample path ({LOADER_WORKERS} threads, "
        f"the mix) {per_sample_ms:.3f} ms per batch over {n_ps} (1 thread: "
        f"{one_thread_ms:.3f}); get_batch path (Human36M) "
        f"{get_batch_ms:.3f} ms per batch over {n_gb}; H2D (pin + copy) of a per-sample "
        f"batch, {h2d_bytes} bytes: min {min(h2d):.3f} ms, median "
        f"{sorted(h2d)[len(h2d) // 2]:.3f} ms ({card})")

    # Trainer's default path: the first loader batch's step against the
    # plain-K1/K2 step, then one epoch of loader-fed steps
    _reseed(mix_dbs, 1)
    first = _first_batch(mix_loader(LOADER_WORKERS, seed=1))
    setup = train_setup_on(dbs["Human36M"].graph, dbs["Human36M"].target_regressor(),
                           train_batch(*first), dtype=torch.bfloat16, device=device, seed=0)
    fresh = step_check("datasets' graph, first loader batch",
                       *train_step_vs_plain(setup, setup.state))
    state = setup.state
    loader = mix_loader(LOADER_WORKERS, seed=2)
    torch.cuda.synchronize()
    reset_launches()
    step_ms, wait_ms, losses = [], [], []
    t_all = t0 = time.perf_counter()
    for batch in loader:
        t_got = time.perf_counter()
        state, loss = setup.train_step(state, setup.art_compute, train_batch(*batch), LR, True,
                                       setup.generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step_ms.append((t1 - t0) * 1e3)
        wait_ms.append((t_got - t0) * 1e3)
        losses.append({k: float(v) for k, v in loss.items()})
        t0 = t1
    total_s = time.perf_counter() - t_all
    launches = read_launches()
    rate = len(step_ms) * BATCH / total_s
    log(f"  {len(step_ms)} loader-fed steps (bf16, RMSprop lr {LR}): ms per step "
        f"{[round(t, 3) for t in step_ms]}, of which waiting for the loader "
        f"{[round(t, 3) for t in wait_ms]}, against phase 5's resident-batch "
        f"{[round(t, 3) for t in resident_ms]}; {rate:.1f} samples/s; totals "
        f"{[round(l['total'], 5) for l in losses]}; launches {launches} ({card})")
    want = expect(fused_cheby_conv_train=DATA_TRAIN_CONVS * DATA_STEPS,
                  fused_cheby_conv_bwd=DATA_TRAIN_CONVS * DATA_STEPS)
    if len(step_ms) != DATA_STEPS or launches != want:
        raise SystemExit(f"loader-fed steps: {len(step_ms)} steps, launches {launches} "
                         f"!= {want}")
    if not all(math.isfinite(v) for l in losses for v in l.values()):
        raise SystemExit(f"loader-fed steps: non-finite loss: {losses}")
    del setup, state

    # the same seed's first batch on the card and on the CPU, one thread
    same = {}
    for label, make, dbs_of in (
            ("per-sample (the mix)", lambda d: mix_loader(1, d, seed=3), mix_dbs),
            ("get_batch (Human36M)", lambda d: BatchLoader(
                dbs["Human36M"], BATCH, shuffle=True, drop_last=True, num_workers=1,
                seed=3, device=d), [dbs["Human36M"]])):
        got = {}
        for d in ("card", "cpu"):
            _reseed(dbs_of, 3)
            got[d] = _leaves(_first_batch(make(device if d == "card" else "cpu")))
        errs = {k: rel_l2(got["card"][k].cpu(), got["cpu"][k]) for k in got["cpu"]}
        devices = {str(t.device.type) for t in got["card"].values()}
        log(f"  first batch, card vs CPU, {label}: rel_l2 {errs} (tolerance {BATCH_TOL}); "
            f"devices {devices}")
        if devices != {dev.type} or not all(e <= BATCH_TOL for e in errs.values()):
            raise SystemExit(f"{label}: the card's batch differs from the CPU's: {errs}")
        same[label] = errs

    # FreiHAND's MANO train step on its all-dense graph: no band kernel
    frei = dbs["FreiHAND"]
    hand_loader = BatchLoader(frei, BATCH, shuffle=True, drop_last=True,
                              num_workers=LOADER_WORKERS, device=device)
    hand = train_setup_on(frei.graph, frei.target_regressor(),
                          train_batch(*_first_batch(hand_loader)), mano=True,
                          dtype=torch.bfloat16, device=device, seed=0)
    hstate = hand.state
    torch.cuda.synchronize()
    reset_launches()
    hand_ms, hand_losses = [], []
    for _ in range(2):
        for batch in hand_loader:
            t0 = time.perf_counter()
            hstate, loss = hand.train_step(hstate, hand.art_compute, train_batch(*batch), LR,
                                           True, hand.generator)
            torch.cuda.synchronize()
            hand_ms.append((time.perf_counter() - t0) * 1e3)
            hand_losses.append(float(loss["total"]))
    hand_launches = read_launches()
    log(f"  FreiHAND (MANO, all-dense graph): {len(hand_ms)} steps, ms "
        f"{[round(t, 3) for t in hand_ms]}, totals {[round(v, 5) for v in hand_losses]}, "
        f"launches {hand_launches} ({card})")
    if len(hand_ms) != 2 or hand_launches != expect() or \
            not all(math.isfinite(v) for v in hand_losses):
        raise SystemExit(f"FreiHAND step: {hand_ms} ms, launches {hand_launches}, "
                         f"losses {hand_losses}")
    return {"loader_per_sample_ms": per_sample_ms, "loader_get_batch_ms": get_batch_ms,
            "loader_per_sample_1_thread_ms": one_thread_ms, "step_wait_ms": wait_ms,
            "h2d_ms": h2d, "h2d_bytes": h2d_bytes, "step_ms": step_ms,
            "resident_step_ms": resident_ms, "samples_per_s": rate, "losses": losses,
            "launches": launches, "first_batch_step": fresh, "card_vs_cpu": same,
            "mano_step_ms": hand_ms, "mano_launches": hand_launches}


def eval_loop(ds, d, device: str) -> tuple:
    """Tester.test's loop (the JAX package's core/engine.py:390-455): the
    test loader (no shuffle, the tail padded to BATCH) -> the deploy forward
    -> compute_both_err per batch, evaluate at the end.  Returns (results,
    ms per batch)."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.data import BatchLoader
    loader = BatchLoader(ds, BATCH, shuffle=False, drop_last=False,
                         num_workers=LOADER_WORKERS, device=device)
    j_errs, v_errs, meshes, targets, ms = [], [], [], [], []
    t0 = time.perf_counter()
    for inputs, tgt, _meta in loader:
        pose2d = inputs["pose2d"]
        n = pose2d.shape[0]
        if n < BATCH:  # pad the tail to the batch shape
            pose2d = torch.cat([pose2d, pose2d[-1:].expand(BATCH - n, -1, -1)])
        mesh_mm, reg_pose, _ = d.eval_step(d.art_compute, pose2d)
        mesh_mm = mesh_mm[:n].float().cpu().numpy()
        reg_pose = reg_pose[:n].float().cpu().numpy()
        gt_mesh = tgt["mesh"].float().cpu().numpy() * 1000.0
        gt_reg = tgt["reg_pose3d"].float().cpu().numpy()
        j, v = ds.compute_both_err(mesh_mm, gt_mesh, reg_pose, gt_reg)
        j_errs.append(j)
        v_errs.append(v)
        meshes.append(mesh_mm)
        targets.append(gt_mesh)
        t1 = time.perf_counter()
        ms.append((t1 - t0) * 1e3)
        t0 = t1
    res = {"joint_err": float(np.mean(j_errs)), "mesh_err": float(np.mean(v_errs))}
    res.update(ds.evaluate({"mesh_coord": np.concatenate(meshes),
                            "mesh_coord_target": np.concatenate(targets)}))
    return res, ms


def data_eval(data, card, device: str = "cuda") -> dict:
    """Phase 12.4: the evaluation loop on PW3D through the deploy forward
    (group path, BatchNorm folded) on the card, exactly 6 + 2 group convs a
    forward, against the same loop on the CPU through the plain versions."""
    import torch
    from pose2mesh_release_tpu_torch.deploy import deploy_forward_on
    ds = data["dbs"]["PW3D"]
    d = deploy_forward_on(ds.graph, ds.target_regressor(), dtype=torch.bfloat16,
                          device=device, seed=0)
    d.eval_step(d.art_compute, torch.zeros(BATCH, ds.joint_num, 2, device=device))  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    card_res, card_ms = eval_loop(ds, d, device)
    launches = read_launches()
    nb = len(card_ms)
    want = expect(**{k: v * nb for k, v in DATA_DEPLOY_LAUNCHES.items()})
    cpu = deploy_forward_on(ds.graph, ds.target_regressor(), dtype=torch.bfloat16,
                            device="cpu", seed=0)
    cpu.model.load_state_dict({k: v.cpu() for k, v in d.model.state_dict().items()})
    cpu_res, cpu_ms = eval_loop(ds, cpu, "cpu")
    errs = {k: abs(card_res[k] - cpu_res[k]) / abs(cpu_res[k])
            for k in ("mpjpe", "pa_mpjpe", "mpvpe")}
    log(f"phase 12: PW3D evaluation, {len(ds)} records, {nb} batches of {BATCH}: card "
        f"{ {k: round(v, 4) for k, v in card_res.items()} }, ms per batch "
        f"{[round(t, 3) for t in card_ms]} ({card}); CPU through the plain versions "
        f"{ {k: round(v, 4) for k, v in cpu_res.items()} }, ms per batch "
        f"{[round(t, 1) for t in cpu_ms]}; relative difference {errs} (tolerance "
        f"{EVAL_TOL}); launches {launches}")
    if launches != want:
        raise SystemExit(f"evaluation loop: launch counts {launches} != {want}")
    if not all(e <= EVAL_TOL for e in errs.values()):
        raise SystemExit(f"evaluation on the card disagrees with the CPU loop: {errs}")
    return {"card": card_res, "cpu": cpu_res, "rel_diff": errs, "ms_per_batch": card_ms,
            "cpu_ms_per_batch": cpu_ms, "launches": launches}


def data_layer(root: str, card, resident_ms, device: str = "cuda") -> dict:
    """Phase 12: the data layer on the card over the stand-in annotation
    files under `root`.  `device` is "cuda" but for a rehearsal of the
    phase's control flow on the CPU."""
    import torch
    data = build_datasets(root, device)
    report = {"build_s": data["build_s"], "levels": data["levels"],
              "valid_share": data["valid_share"], "valid": data["valid"]}
    report.update(data_train(data, card, resident_ms, device))
    report["eval"] = data_eval(data, card, device)
    del data
    if device == "cuda":
        torch.cuda.empty_cache()
    return report


def engine_cfg(path: str, root: str, out: str, **sections) -> str:
    """A JSON experiment file at `path`: the default mix (Human36M with the
    COCO input, COCO, MuCo) tested on PW3D, read from the stand-in files
    under `root`, batch BATCH, LOADER_WORKERS threads, ENGINE_EPOCHS epochs,
    seed 0, writing under `out`; `sections` override keys of a section."""
    cfg = {"DATASET": {"workers": LOADER_WORKERS},
           "TRAIN": {"batch_size": BATCH, "end_epoch": ENGINE_EPOCHS},
           "TEST": {"batch_size": BATCH},
           "data_dir": root, "output_dir": out, "seed": 0}
    for name, keys in sections.items():
        cfg[name] = {**cfg.get(name, {}), **keys}
    _dump(path, cfg)
    return path


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in read_launches().items() if v != before[k]}


class EngineProbe:
    """The kernel launches of each call of the engine's train and eval steps
    while an entry point runs: wraps core.engine's make_train_step and
    make_eval_step, leaving the steps themselves unchanged (an eval call is
    also timed, to a synchronize)."""

    def __enter__(self):
        from pose2mesh_release_tpu_torch.core import engine
        self.train, self.eval, self.eval_ms = [], [], []
        self._engine = engine
        self._orig = make_train, make_eval = engine.make_train_step, engine.make_eval_step

        def train_maker(*a, **kw):
            step = make_train(*a, **kw)

            def counted(*args):
                before = read_launches()
                out = step(*args)
                self.train.append(_delta(before))
                return out
            return counted

        def eval_maker(*a, **kw):
            step = make_eval(*a, **kw)

            def counted(*args):
                import torch
                before, t0 = read_launches(), time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                self.eval_ms.append((time.perf_counter() - t0) * 1e3)
                self.eval.append(_delta(before))
                return out
            return counted

        engine.make_train_step, engine.make_eval_step = train_maker, eval_maker
        return self

    def __exit__(self, *exc):
        self._engine.make_train_step, self._engine.make_eval_step = self._orig


def _same(a, b) -> bool:
    """Nested state dicts equal exactly (tensors compared on the CPU)."""
    import torch
    if torch.is_tensor(a) or torch.is_tensor(b):
        return torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype and \
            torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict) and isinstance(b, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _check_steps(label: str, records: list, want: dict, count: int) -> None:
    if len(records) != count or any(r != want for r in records):
        raise SystemExit(f"{label}: {len(records)} calls (want {count}), launches per call "
                         f"{records} (want {want} each)")


TRAIN_STEP_LAUNCHES = {"fused_cheby_conv_train": DATA_TRAIN_CONVS,
                       "fused_cheby_conv_bwd": DATA_TRAIN_CONVS}
EVAL_TRAIN_FORM_LAUNCHES = {"fused_cheby_conv_train": DATA_TRAIN_CONVS}


def engine_train(root: str, out: str, card, device: str) -> dict:
    """Phases 13.1-13.2: cli.train for ENGINE_EPOCHS epochs, its files, its
    launches per step and per in-epoch eval forward, then a resumed Trainer
    (state equal to the saved one exactly) for one more epoch."""
    import torch
    from pose2mesh_release_tpu_torch.cli import train as cli_train
    from pose2mesh_release_tpu_torch.config import load_config
    from pose2mesh_release_tpu_torch.core.engine import Trainer
    cfg_path = engine_cfg(os.path.join(root, "train.json"), root, out)
    reset_launches()
    t0 = time.time()
    with EngineProbe() as probe:
        result = cli_train.main(["--cfg", cfg_path, "--debug", "--device", device])
    wall = time.time() - t0
    total = read_launches()
    ck = os.path.join(out, "checkpoint")
    files = [os.path.join(ck, f"{n}.pth.tar") for n in
             ("checkpoint1", "checkpoint2", "best", "final")] + \
        [os.path.join(out, "metrics.jsonl")] + \
        [os.path.join(out, "graph", f"{t}.pdf") for t in ("train_loss", "test_joint_err")]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise SystemExit(f"cli.train: missing {missing}")
    with open(files[4]) as f:
        epochs = [json.loads(line) for line in f]
    steps, forwards = DATA_STEPS * ENGINE_EPOCHS, len(probe.eval)
    _check_steps("cli.train steps", probe.train, TRAIN_STEP_LAUNCHES, steps)
    _check_steps("cli.train in-epoch eval forwards", probe.eval, EVAL_TRAIN_FORM_LAUNCHES,
                 forwards)
    want = expect(fused_cheby_conv_train=DATA_TRAIN_CONVS * (steps + forwards),
                  fused_cheby_conv_bwd=DATA_TRAIN_CONVS * steps)
    if total != want or forwards == 0:
        raise SystemExit(f"cli.train launches {total} != {want} ({forwards} eval forwards)")
    if not all(math.isfinite(e["train_loss"]) and math.isfinite(e["joint_err"])
               for e in epochs):
        raise SystemExit(f"cli.train: non-finite loss or error {epochs}")
    step_ms = [e["train_s"] * 1e3 / DATA_STEPS for e in epochs]
    log(f"phase 13: cli.train, {ENGINE_EPOCHS} epochs of {DATA_STEPS} steps (batch {BATCH}, "
        f"bf16, RMSprop, {LOADER_WORKERS} loader threads) in {wall:.2f} s: epoch wall s "
        f"{[round(e['epoch_s'], 3) for e in epochs]}, training s "
        f"{[round(e['train_s'], 3) for e in epochs]}, ms per step {[round(t, 2) for t in step_ms]}, "
        f"samples/s {[round(BATCH * DATA_STEPS / e['train_s'], 1) for e in epochs]}; losses "
        f"{[round(e['train_loss'], 5) for e in epochs]}; joint err "
        f"{[round(e['joint_err'], 3) for e in epochs]} mm; launches per step "
        f"{probe.train[0]}, per eval forward {probe.eval[0]} ({forwards} forwards) ({card})")

    # resume: a Trainer from the latest checkpoint, state equal to the file's
    cfg = load_config(cfg_path)
    cfg.TRAIN.end_epoch = ENGINE_EPOCHS + 1
    saved = torch.load(os.path.join(ck, f"checkpoint{ENGINE_EPOCHS}.pth.tar"),
                       map_location="cpu", weights_only=True)
    with EngineProbe() as resumed_probe:
        t0 = time.time()
        tr = Trainer(cfg, resume=True, debug=True, device=device)
        build_s = time.time() - t0
        if tr.begin_epoch != ENGINE_EPOCHS + 1 or tr.state.step != steps:
            raise SystemExit(f"resume: begin_epoch {tr.begin_epoch}, step {tr.state.step}")
        if not _same(tr.model.state_dict(), saved["model_state_dict"]) or \
                not _same(tr.optimizer.state_dict(), saved["optim_state_dict"]):
            raise SystemExit("resume: the model or optimizer state differs from the checkpoint")
        reset_launches()
        t0 = time.time()
        resumed = tr.fit()
        resume_s = time.time() - t0
    _check_steps("resumed steps", resumed_probe.train, TRAIN_STEP_LAUNCHES, DATA_STEPS)
    _check_steps("resumed eval forwards", resumed_probe.eval, EVAL_TRAIN_FORM_LAUNCHES,
                 len(resumed_probe.eval))
    if not os.path.exists(os.path.join(ck, f"checkpoint{ENGINE_EPOCHS + 1}.pth.tar")) or \
            len(tr.train_log) != ENGINE_EPOCHS + 1:
        raise SystemExit(f"resume: no epoch {ENGINE_EPOCHS + 1} checkpoint or log")
    log(f"  resumed Trainer: built in {build_s:.2f} s at epoch {tr.begin_epoch}, model and "
        f"optimizer state equal to checkpoint{ENGINE_EPOCHS}'s; one epoch in {resume_s:.2f} s, "
        f"loss {tr.train_log[-1]:.5f}, joint err {resumed['joint_err']:.3f} mm")
    del tr
    return {"wall_s": wall, "epoch_s": [e["epoch_s"] for e in epochs],
            "train_s": [e["train_s"] for e in epochs], "ms_per_step": step_ms,
            "samples_per_s": [BATCH * DATA_STEPS / e["train_s"] for e in epochs],
            "losses": [e["train_loss"] for e in epochs], "result": result,
            "launches_per_step": probe.train[0], "launches_per_eval_forward": probe.eval[0],
            "in_epoch_eval_ms": probe.eval_ms, "resume_build_s": build_s,
            "resume_epoch_s": resume_s, "resumed_result": resumed}


def engine_test(root: str, out: str, card, device: str) -> dict:
    """Phase 13.3: cli.test from best.pth.tar through the deploy Tester
    (6 group + 2 commuted convs a forward) against the training-form eval
    of the same checkpoint (8 K1 a forward), within DEPLOY_VS_TRAIN_TOL."""
    from pose2mesh_release_tpu_torch.cli import test as cli_test
    best = os.path.join(out, "checkpoint", "best.pth.tar")
    runs = {}
    for form, deploy, want in (("deploy", True, DATA_DEPLOY_LAUNCHES),
                               ("training form", False, EVAL_TRAIN_FORM_LAUNCHES)):
        cfg_path = engine_cfg(os.path.join(root, f"test_{deploy}.json"), root, out,
                              TEST={"deploy": deploy})
        reset_launches()
        t0 = time.time()
        with EngineProbe() as probe:
            res = cli_test.main(["--cfg", cfg_path, "--weights", best, "--debug",
                                 "--device", device])
        wall = time.time() - t0
        _check_steps(f"cli.test ({form}) forwards", probe.eval, want, len(probe.eval))
        if read_launches() != expect(**{k: v * len(probe.eval) for k, v in want.items()}) \
                or not probe.eval:
            raise SystemExit(f"cli.test ({form}): launches {read_launches()}")
        runs[form] = {"result": res, "wall_s": wall, "eval_ms": probe.eval_ms,
                      "launches_per_forward": probe.eval[0]}
    keys = ("joint_err", "mesh_err", "mpjpe", "pa_mpjpe", "mpvpe")
    dep, tf = runs["deploy"]["result"], runs["training form"]["result"]
    rel = {k: abs(dep[k] - tf[k]) / abs(tf[k]) for k in keys}
    log(f"phase 13: cli.test from best.pth.tar: deploy "
        f"{ {k: round(dep[k], 4) for k in keys} }, eval-step ms per batch "
        f"{[round(t, 3) for t in runs['deploy']['eval_ms']]}, wall {runs['deploy']['wall_s']:.2f} s, "
        f"launches per forward {runs['deploy']['launches_per_forward']}; training form "
        f"{ {k: round(tf[k], 4) for k in keys} }, ms per batch "
        f"{[round(t, 3) for t in runs['training form']['eval_ms']]}, launches per forward "
        f"{runs['training form']['launches_per_forward']}; relative difference "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tolerance {DEPLOY_VS_TRAIN_TOL}) ({card})")
    if not all(v <= DEPLOY_VS_TRAIN_TOL for v in rel.values()):
        raise SystemExit(f"deploy Tester disagrees with the training-form eval: {rel}")
    return {"runs": runs, "rel_diff": rel}


def engine_lift(root: str, out: str, card, device: str) -> dict:
    """Phase 13.4: cli.train with MODEL.name posenet for one epoch, then
    cli.test on its best checkpoint; neither launches a band kernel."""
    from pose2mesh_release_tpu_torch.cli import test as cli_test
    from pose2mesh_release_tpu_torch.cli import train as cli_train
    cfg_path = engine_cfg(os.path.join(root, "lift.json"), root, out,
                          MODEL={"name": "posenet"}, TRAIN={"end_epoch": 1})
    reset_launches()
    t0 = time.time()
    trained = cli_train.main(["--cfg", cfg_path, "--debug", "--device", device])
    train_s = time.time() - t0
    t0 = time.time()
    tested = cli_test.main(["--cfg", cfg_path, "--debug", "--device", device, "--weights",
                            os.path.join(out, "checkpoint", "best.pth.tar")])
    test_s = time.time() - t0
    launches = read_launches()
    log(f"phase 13: PoseNet alone: cli.train 1 epoch in {train_s:.2f} s, loss "
        f"{trained['loss']:.4f}, MPJPE {trained['mpjpe']:.3f}; cli.test from best.pth.tar in "
        f"{test_s:.2f} s, MPJPE {tested['mpjpe']:.3f}, PA-MPJPE {tested['pa_mpjpe']:.3f}; "
        f"no band kernel on this path: launches {launches} ({card})")
    if launches != expect() or not math.isfinite(tested["mpjpe"]) or \
            abs(tested["mpjpe"] - trained["mpjpe"]) > 1e-3 * abs(trained["mpjpe"]):
        raise SystemExit(f"PoseNet alone: launches {launches}, train {trained}, test {tested}")
    return {"train_s": train_s, "test_s": test_s, "train": trained, "test": tested}


def _pixels(joints, offset=(0.0, 0.0)):
    """A stand-in body's joints (J, 3) metres as pixels: 400 px a metre, y
    down, centred at (500, 500) + offset."""
    import numpy as np
    return np.float32(joints[:, :2] * [400.0, -400.0] + [500.0 + offset[0], 500.0 + offset[1]])


def engine_demo(root: str, out: str, card, device: str) -> dict:
    """Phase 13.5: cli.demo on the card with best.pth.tar (the COCO-input
    cascade, 19 joints): a 17-keypoint COCO .npy, and a COCO detections
    .json (two people after the NMS, pelvis and neck completed); a 17-joint
    H36M .npy with --joint_set human36 and random weights (best.pth.tar
    holds a 19-joint lifter).  Each: .obj files of 6890 finite vertices,
    8 K1 a person, the card's camera fit within CAMERA_TOL of the same fit
    on the CPU."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.cli import demo
    from pose2mesh_release_tpu_torch.models.camera import fit_camera, project_weak
    best = os.path.join(out, "checkpoint", "best.pth.tar")
    smpl = SMPL(data_dir=root)  # the stand-in files' regressors: joints spread over the body
    coco = _pixels(smpl.joint_regressor_coco @ smpl.v_template)
    h36m = _pixels(smpl.joint_regressor_h36m @ smpl.v_template)
    np.save(os.path.join(root, "coco.npy"), coco)
    np.save(os.path.join(root, "h36m.npy"), h36m)
    kp = np.concatenate([coco, np.full((17, 1), 0.9, np.float32)], 1)
    dets = [kp, kp + [4.0, 3.0, -0.1], kp + [600.0, 0.0, -0.2], kp * [1, 1, 0.05]]
    _dump(os.path.join(root, "dets.json"), [{"keypoints": d.flatten().tolist()} for d in dets])
    runs = {}
    for label, pose, joint_set, weights, persons in (
            ("coco .npy", "coco.npy", "coco", best, 1),
            ("coco detections .json", "dets.json", "coco", best, 2),
            ("human36 .npy, random weights", "h36m.npy", "human36", "", 1)):
        argv = ["--input_pose", os.path.join(root, pose), "--joint_set", joint_set,
                "--out_dir", os.path.join(out, "demo", joint_set + pose[-4:]),
                "--device", device] + (["--weights", weights] if weights else [])
        reset_launches()
        t0 = time.time()
        res = demo.main(argv)
        wall = time.time() - t0
        launches = read_launches()
        people = res["people"]
        if len(people) != persons or \
                launches != expect(fused_cheby_conv_train=DATA_TRAIN_CONVS * persons):
            raise SystemExit(f"demo {label}: {len(people)} people, launches {launches}")
        fits = []
        for p in people:
            with open(p["obj"]) as f:
                verts = np.array([[float(x) for x in line.split()[1:]] for line in f
                                  if line.startswith("v ")])
            if verts.shape != (6890, 3) or not np.isfinite(verts).all():
                raise SystemExit(f"demo {label}: mesh {verts.shape}, finite "
                                 f"{np.isfinite(verts).all()}")
            fits.append(camera_vs_cpu(np.float32(p["joints3d"]), np.float32(p["target2d"]),
                                      torch.tensor(p["cam"]), demo.CROP_SIZE))
        runs[label] = {"wall_s": wall, "s_per_person": wall / persons,
                       "forward_s": [p["forward_s"] for p in people],
                       "camera_ms": [p["camera_s"] * 1e3 for p in people],
                       "cam": [p["cam"] for p in people], "camera_vs_cpu": fits,
                       "launches": launches}
        sci = {k: [format(f[k], ".2e") for f in fits] for k in ("loss", "params", "sensitivity")}
        log(f"phase 13: demo, {label}: {persons} people in {wall:.2f} s "
            f"({wall / persons:.2f} s a person; forward s "
            f"{[round(p['forward_s'], 4) for p in people]}, camera fit ms "
            f"{[round(p['camera_s'] * 1e3, 1) for p in people]}); launches {launches}; camera "
            f"card vs CPU: reprojection px {[round(f['card_px'], 3) for f in fits]} vs "
            f"{[round(f['cpu_px'], 3) for f in fits]} (relative {sci['loss']}, tolerance "
            f"{CAMERA_TOL}), parameters rel_l2 {sci['params']} against {sci['sensitivity']} "
            f"from a 1e-6 nudge of the joints on the CPU ({card})")
        if not all(f["loss"] <= CAMERA_TOL for f in fits):
            raise SystemExit(f"demo {label}: the card's camera fit reprojects worse or better "
                             f"than the CPU's: {fits}")
    # the camera fit where its optimum is well defined: the stand-in body's
    # COCO joints against their projection under a known camera, 2 px noise
    joints = smpl.joint_regressor_coco @ smpl.v_template
    joints = np.float32(joints - joints[:1])
    rng = np.random.default_rng(5)
    target = np.float32(project_weak(torch.from_numpy(joints), torch.tensor([1.6, 0.05, -0.1]),
                                     demo.CROP_SIZE).numpy() + rng.normal(0, 2, (17, 2)))
    cam_card = fit_camera(joints, target, img_res=demo.CROP_SIZE, device=device)
    posed = camera_vs_cpu(joints, target, cam_card.cpu(), demo.CROP_SIZE)
    log(f"  camera fit on the stand-in body's joints (true cam (1.6, 0.05, -0.1), 2 px noise): "
        f"card {cam_card.cpu().numpy().round(5).tolist()}, parameters rel_l2 vs the CPU "
        f"{posed['params']:.2e} (tolerance {CAMERA_TOL}; 1e-6 nudge on the CPU "
        f"{posed['sensitivity']:.2e}), reprojection {posed['card_px']:.3f} px")
    if posed["params"] > CAMERA_TOL:
        raise SystemExit(f"the card's camera fit differs from the CPU's: {posed}")
    runs["camera_well_posed"] = posed
    return runs


def camera_vs_cpu(joints, target, cam_card, img_res) -> dict:
    """The card's fitted camera against fit_camera on the CPU from the same
    inputs: the relative difference of the reprojection error (px), the
    parameters' relative L2, and the parameters' sensitivity (relative L2
    of the CPU fit after a 1e-6 relative nudge of the joints)."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.models.camera import fit_camera, project_weak
    cpu = fit_camera(joints, target, img_res=img_res, device="cpu")
    nudged = fit_camera(joints * np.float32(1 + 1e-6), target, img_res=img_res, device="cpu")

    def px(cam):
        return float((project_weak(torch.from_numpy(joints), cam, img_res)
                      - torch.from_numpy(target)).abs().mean())

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    card_px, cpu_px = px(cam_card), px(cpu)
    return {"card_px": card_px, "cpu_px": cpu_px, "loss": abs(card_px - cpu_px) / cpu_px,
            "params": rel(cam_card, cpu), "sensitivity": rel(nudged, cpu)}


def engine_layer(root: str, card, device: str = "cuda") -> dict:
    """Phase 13: the engine and the entry points (the CLIs, Trainer,
    Tester, LiftTrainer, LiftTester, the demo) over phase 12's stand-in
    files under `root`.  `device` is "cuda" but for a rehearsal of the
    phase's control flow on the CPU."""
    out = os.path.join(root, "experiment")
    report = {"train": engine_train(root, out, card, device),
              "test": engine_test(root, out, card, device),
              "lift": engine_lift(root, out + "_lift", card, device),
              "demo": engine_demo(root, out, card, device)}
    return report


def f32_kernels(by_v, mano_op, gen) -> tuple:
    """Phase 14.1: the float32 instances of the group and commuted convs, K1
    (with the statistics and the fold, and keep_basis), K2, the hop K4, the
    strip conv K5 (both orders, every epilogue) and the window conv K6
    against their plain versions on the same float32 inputs, at the main
    path's shapes, the band_k = 2 level (K5 also at 64-row strip tiles) and
    MANO's band level (K4, K5, K6); K1, K2, K4, K5 and K6 run twice to equal
    bits.  Returns (deploy rows, train rows, MANO rows)."""
    import torch
    f32 = torch.float32
    log(f"phase 14: the float32 instances vs plain (the same float32 inputs), batch "
        f"{BATCH}, tolerance rel_l2 <= {F32_KERNEL_TOL}; bound at {PEAK_3XTF32_FLOPS / 1e12:.0f} "
        f"TFLOP/s (3xTF32)")
    convs = list(enumerate(MAIN_PATH_CONVS))
    rows = [check_conv(by_v[V], name, fin, fout, ep, gen, f"f32main{i}", f32)
            for i, (V, name, fin, fout, ep) in convs]
    op2 = k2_level(3475)
    rows += [check_conv(op2, name, fin, fout, ep, gen, f"f32k2_{i}", f32)
             for i, (name, fin, fout, ep) in enumerate(K2_CONVS)]
    rows += [check_hop(by_v[V], fin, gen, f"f32hop{i}", f32) for i, (V, _, fin, _, _) in convs]
    rows.append(check_hop(op2, 128, gen, "f32k2_hop", f32))
    rows += [check_strip(by_v[V], fin, fout, ep, gen, f"f32strip{i}", f32)
             for i, (V, _, fin, fout, ep) in convs]
    # band_k 2 in both orders, commuted with the skip add and the skip
    # projection; 64-row strip tiles
    rows += [check_strip(op2, fin, fout, ep, gen, f"f32k2_strip{i}", f32)
             for i, (fin, fout, ep) in enumerate(F32_K2_STRIP_CONVS)]
    rows.append(check_strip(restrip(by_v[3475], 64), 128, 128, "skip_add", gen, "f32h64_strip",
                            f32))
    rows += [check_window(by_v[V], fin, fout, ep, gen, f"f32window{i}", f32)
             for i, (V, _, fin, fout, ep) in convs]
    rows += [check_window(op2, fin, fout, ep, gen, f"f32k2_window{i}", f32)
             for i, (_, fin, fout, ep) in enumerate(K2_CONVS)]
    train_rows = []
    for i, (V, fin, fout, fold, stats) in enumerate(TRAIN_CONVS):
        train_rows += check_train_conv(by_v[V], fin, fout, fold, stats, gen, f"f32train{i}",
                                       f32)
    train_rows += check_train_conv(op2, *K2_TRAIN_CONV, gen, "f32k2_train", f32)
    V, fin, fout = KEEP_BASIS_CONV
    train_rows.append(check_keep_basis(by_v[V], fin, fout, gen, "f32keep_basis", f32))
    mano_rows = [check_hop(mano_op, fin, gen, f"f32mano_hop{i}", f32)
                 for i, (_, fin, _, _) in enumerate(MANO_DEPLOY_CONVS)]
    mano_rows += [check_strip(mano_op, fin, fout, ep, gen, f"f32mano_strip{i}", f32)
                  for i, (_, fin, fout, ep) in enumerate(MANO_DEPLOY_CONVS)]
    mano_rows += [check_window(mano_op, fin, fout, ep, gen, f"f32mano_window{i}", f32)
                  for i, (_, fin, fout, ep) in enumerate(MANO_DEPLOY_CONVS)]
    bad = [(r["tag"], r["name"]) for r in rows + train_rows + mano_rows if not r["ok"]]
    if bad:
        raise SystemExit(f"float32 kernel check failed: {bad}")
    return rows, train_rows, mano_rows


def f32_forward(deploy, mano_deploy, card) -> dict:
    """Phase 14.2: the float32 deploy forward, REQUESTS requests of batch
    BATCH on the group path (exactly 8 group + 2 commuted convs each, the
    mesh and joints within F32_FORWARD_TOL of the plain float32 forward),
    then on the strip, window and unfused paths (PATHS' calls and
    PATH_CUDA_LAUNCHES' engine and projection launches a forward, within
    F32_FORWARD_TOL of the path's plain float32 forward and of the group
    forward); MANO's forward, one request on each path, likewise."""
    import torch
    step, art = deploy.eval_step, deploy.art_compute
    g = torch.Generator().manual_seed(1)
    batches = [torch.randn(BATCH, 17, 2, generator=g).cuda() for _ in range(REQUESTS)]
    step(art, batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    outs, times = [], []
    for p in batches:
        t0 = time.perf_counter()
        outs.append(step(art, p))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    log(f"phase 14: float32 deploy forward, {REQUESTS} requests of batch {BATCH}: ms per "
        f"batch {[round(t, 3) for t in times]} ({card}); launches {launches}")
    want = expect(fused_cheby_conv=8 * REQUESTS, fused_cheby_conv_commuted=2 * REQUESTS)
    if launches != want:
        raise SystemExit(f"float32 forward: launch counts {launches} != {want}")
    for out in outs:
        assert [tuple(t.shape) for t in out] == [(BATCH, 6890, 3), (BATCH, 17, 3),
                                                 (BATCH, 17, 3)]
        assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all()) for t in out)
    ref, plain_ms = plain_forward("group", step, art, batches[0])
    errs = {"mesh_vs_plain": rel_l2(outs[0][0], ref[0]),
            "reg_pose_vs_plain": rel_l2(outs[0][1], ref[1])}
    log(f"  float32 forward vs plain float32 forward: "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tolerance {F32_FORWARD_TOL}); plain forward {plain_ms:.3f} ms")
    if max(errs.values()) > F32_FORWARD_TOL:
        raise SystemExit(f"float32 forward disagrees with the plain forward: {errs}")
    report = {"card": card, "batch": BATCH, "ms_per_batch": times, "launches": launches,
              "plain_forward_ms": plain_ms, **errs}
    log("phase 14: float32 forward on the further paths")
    report["paths"] = {path: drive_path(path, deploy, batches, outs[0], card,
                                        tol=F32_FORWARD_TOL) for path in PATHS}
    mano_batch = torch.randn(BATCH, 21, 2, generator=g).cuda()
    mano_out = mano_deploy.eval_step(mano_deploy.art_compute, mano_batch)
    log("phase 14: float32 MANO forward on the further paths")
    report["mano_paths"] = {
        path: drive_path(path, mano_deploy, [mano_batch], mano_out, card, MANO_PATHS,
                         MANO_PATH_CUDA_LAUNCHES, MANO_SHAPES, tol=F32_FORWARD_TOL)
        for path in MANO_PATHS}
    return report


def f32_train(card) -> tuple:
    """Phase 14.3: the float32 train step (smpl_train_setup, float32
    compute): from the fresh state against the plain-K1/K2 float32 step
    (loss within F32_STEP_LOSS_TOL, gradients within F32_STEP_GRAD_TOL),
    then 1 warm-up and TRAIN_STEPS counted steps, exactly 10 K1 + 10 K2
    each.  Returns (setup, report)."""
    import torch
    from pose2mesh_release_tpu_torch.train_setup import smpl_train_setup
    t0 = time.time()
    setup = smpl_train_setup(dtype=torch.float32, device="cuda", seed=0, batch=BATCH)
    log(f"phase 14: float32 train setup in {time.time() - t0:.1f} s; batch {BATCH}, "
        f"RMSprop lr {LR}, edge loss on")
    state = setup.state
    fresh = step_check("float32, fresh state", *train_step_vs_plain(setup, state),
                       loss_tol=F32_STEP_LOSS_TOL, grad_tol=F32_STEP_GRAD_TOL)
    state, warm = setup.train_step(state, setup.art_compute, setup.batch, LR, True,
                                   setup.generator)
    torch.cuda.synchronize()
    reset_launches()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, out = setup.train_step(state, setup.art_compute, setup.batch, LR, True,
                                      setup.generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in out.items()})
    launches = read_launches()
    log(f"  float32 warm-up total {float(warm['total']):.5f}; {TRAIN_STEPS} steps: ms per "
        f"step {[round(t, 3) for t in step_ms]} ({card}); totals "
        f"{[round(l['total'], 5) for l in losses]}; launches {launches}")
    want = expect(fused_cheby_conv_train=10 * TRAIN_STEPS, fused_cheby_conv_bwd=10 * TRAIN_STEPS)
    if launches != want:
        raise SystemExit(f"float32 step: launch counts {launches} != {want}")
    if not all(math.isfinite(v) for l in losses for v in l.values()) or \
            not losses[-1]["total"] < losses[0]["total"]:
        raise SystemExit(f"float32 step: losses {losses}")
    return setup, {"card": card, "batch": BATCH, "ms_per_step": step_ms, "losses": losses,
                   "launches": launches, "fresh_state": fresh}


def f32_unfused_train(setup, card) -> dict:
    """Phase 14.3, the unfused training form (fused=False, inference_fused
    False; JAX P2M_FUSED=0) with setup's float32 weights: one step against
    the same step through the plain versions (loss within
    F32_STEP_LOSS_TOL, gradients within F32_STEP_GRAD_TOL) and its launches
    (every training conv carries the batch statistics or the previous
    conv's fold, so the step runs 10 K1 + 10 K2 and no hop); then its eval
    forward, where each band block's first conv is unfused: exactly
    UNFUSED_EVAL_LAUNCHES a forward, within F32_FORWARD_TOL of the same
    forward through the plain versions."""
    import dataclasses

    import torch
    from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
    from pose2mesh_release_tpu_torch.core.train import TrainState, make_eval_step, \
        make_train_step
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
    from pose2mesh_release_tpu_torch.ops import hop as hp
    base = setup.state.model
    model = Pose2Mesh(base.num_joint, setup.art_compute.mesh_ops[-1].num_vertices,
                      blocks=base.pose2mesh.blocks,
                      posenet_hidden=base.pose_lifter.w1.out_features, dtype=torch.float32,
                      inference_fused=False, fused=False, device="cuda")
    model.load_state_dict(base.state_dict())
    opt = make_preconditioner("rmsprop", model.parameters())
    unfused = dataclasses.replace(setup, state=TrainState(model, opt),
                                  train_step=make_train_step(model, opt, setup.j_regressor,
                                                             device="cuda"))
    log(f"phase 14: the float32 unfused training form (fused=False), batch {BATCH}")
    fresh = step_check("float32 unfused training form", *train_step_vs_plain(
        unfused, unfused.state), loss_tol=F32_STEP_LOSS_TOL, grad_tol=F32_STEP_GRAD_TOL)
    reset_launches()
    t0 = time.perf_counter()
    unfused.train_step(unfused.state, unfused.art_compute, unfused.batch, 0.0, True,
                       unfused.generator)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches = read_launches()
    if step_launches != expect(fused_cheby_conv_train=10, fused_cheby_conv_bwd=10):
        raise SystemExit(f"float32 unfused step: launches {step_launches}")
    ev = make_eval_step(model, setup.j_regressor, device="cuda")
    pose2d = setup.batch["pose2d"]
    ev(setup.art_compute, pose2d)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = ev(setup.art_compute, pose2d)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_launches = read_launches()
    if eval_launches != expect(**UNFUSED_EVAL_LAUNCHES):
        raise SystemExit(f"float32 unfused eval forward: launches {eval_launches}")
    kernels = hp.hop, ft.fused_cheby_conv_train
    hp.hop, ft.fused_cheby_conv_train = hp.hop_plain, ft.fused_cheby_conv_train_plain
    try:
        ref = ev(setup.art_compute, pose2d)
    finally:
        hp.hop, ft.fused_cheby_conv_train = kernels
    errs = {"mesh_vs_plain": rel_l2(out[0], ref[0]), "reg_pose_vs_plain": rel_l2(out[1], ref[1])}
    log(f"  unfused training form: step {step_ms:.3f} ms, launches {step_launches}; eval "
        f"forward {eval_ms:.3f} ms, launches {eval_launches}, "
        + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tolerance {F32_FORWARD_TOL}) ({card})")
    if max(errs.values()) > F32_FORWARD_TOL:
        raise SystemExit(f"float32 unfused eval forward disagrees with its plain forward: "
                         f"{errs}")
    return {"card": card, "step_ms": step_ms, "step_launches": step_launches,
            "fresh_state": fresh, "eval_ms": eval_ms, "eval_launches": eval_launches, **errs}


def f32_engine(root: str, card) -> dict:
    """Phase 14.4: the entry points with TPU.compute_dtype f32 over phase
    12's stand-in files: cli.train for one epoch (8 K1 + 8 K2 a step, 8 K1
    an in-epoch eval forward); cli.test of its best.pth.tar, deploy (6
    group + 2 commuted a forward) against the training form (8 K1), every
    metric within F32_DEPLOY_VS_TRAIN_TOL; cli.demo with that checkpoint on
    the stand-in body's COCO keypoints and --input_img a PNG written with
    PIL: 8 float32 K1 a person, the mesh before the camera fit within
    F32_DEMO_MESH_TOL of the same demo's on the CPU."""
    import importlib.util

    import numpy as np
    from PIL import Image
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.cli import demo
    from pose2mesh_release_tpu_torch.cli import test as cli_test
    from pose2mesh_release_tpu_torch.cli import train as cli_train
    out = os.path.join(root, "experiment_f32")
    f32 = {"TPU": {"compute_dtype": "f32"}}
    cfg_path = engine_cfg(os.path.join(root, "train_f32.json"), root, out,
                          TRAIN={"end_epoch": 1}, **f32)
    reset_launches()
    t0 = time.time()
    with EngineProbe() as probe:
        cli_train.main(["--cfg", cfg_path, "--debug", "--device", "cuda"])
    wall = time.time() - t0
    total, forwards = read_launches(), len(probe.eval)
    _check_steps("float32 cli.train steps", probe.train, TRAIN_STEP_LAUNCHES, DATA_STEPS)
    _check_steps("float32 cli.train in-epoch eval forwards", probe.eval,
                 EVAL_TRAIN_FORM_LAUNCHES, forwards)
    want = expect(fused_cheby_conv_train=DATA_TRAIN_CONVS * (DATA_STEPS + forwards),
                  fused_cheby_conv_bwd=DATA_TRAIN_CONVS * DATA_STEPS)
    if total != want or forwards == 0:
        raise SystemExit(f"float32 cli.train launches {total} != {want}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        epoch = [json.loads(line) for line in f][-1]
    if not (math.isfinite(epoch["train_loss"]) and math.isfinite(epoch["joint_err"])):
        raise SystemExit(f"float32 cli.train: {epoch}")
    train = {"wall_s": wall, "epoch_s": epoch["epoch_s"], "train_s": epoch["train_s"],
             "ms_per_step": epoch["train_s"] * 1e3 / DATA_STEPS, "loss": epoch["train_loss"],
             "launches_per_step": probe.train[0], "launches_per_eval_forward": probe.eval[0]}
    log(f"phase 14: float32 cli.train, 1 epoch of {DATA_STEPS} steps in {wall:.2f} s: epoch "
        f"wall {epoch['epoch_s']:.3f} s, {train['ms_per_step']:.2f} ms per step, loss "
        f"{epoch['train_loss']:.5f}; launches per step {probe.train[0]}, per eval forward "
        f"{probe.eval[0]} ({forwards} forwards) ({card})")

    best = os.path.join(out, "checkpoint", "best.pth.tar")
    runs = {}
    for form, deploy, want in (("deploy", True, DATA_DEPLOY_LAUNCHES),
                               ("training form", False, EVAL_TRAIN_FORM_LAUNCHES)):
        path = engine_cfg(os.path.join(root, f"test_f32_{deploy}.json"), root, out,
                          TEST={"deploy": deploy}, **f32)
        reset_launches()
        with EngineProbe() as probe:
            res = cli_test.main(["--cfg", path, "--weights", best, "--debug", "--device",
                                 "cuda"])
        _check_steps(f"float32 cli.test ({form}) forwards", probe.eval, want, len(probe.eval))
        if read_launches() != expect(**{k: v * len(probe.eval) for k, v in want.items()}) \
                or not probe.eval:
            raise SystemExit(f"float32 cli.test ({form}): launches {read_launches()}")
        runs[form] = {"result": res, "eval_ms": probe.eval_ms,
                      "launches_per_forward": probe.eval[0]}
    keys = ("joint_err", "mesh_err", "mpjpe", "pa_mpjpe", "mpvpe")
    dep, tf = runs["deploy"]["result"], runs["training form"]["result"]
    rel = {k: abs(dep[k] - tf[k]) / abs(tf[k]) for k in keys}
    log(f"phase 14: float32 cli.test: deploy eval-step ms per batch "
        f"{[round(t, 3) for t in runs['deploy']['eval_ms']]}, launches per forward "
        f"{runs['deploy']['launches_per_forward']}; training form ms per batch "
        f"{[round(t, 3) for t in runs['training form']['eval_ms']]}; deploy vs training form "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tolerance {F32_DEPLOY_VS_TRAIN_TOL}) "
        f"({card})")
    if not all(v <= F32_DEPLOY_VS_TRAIN_TOL for v in rel.values()):
        raise SystemExit(f"float32 deploy Tester disagrees with the training-form eval: {rel}")
    runs["paths"] = f32_path_testers(root, out, best, tf, keys, card)

    # the demo: the stand-in body's COCO keypoints, a PNG written with PIL
    smpl = SMPL(data_dir=root)
    np.save(os.path.join(root, "coco_f32.npy"), _pixels(smpl.joint_regressor_coco
                                                         @ smpl.v_template))
    img = np.random.default_rng(14).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    png = os.path.join(root, "photo.png")
    Image.fromarray(img).save(png)
    decoder = "matplotlib" if importlib.util.find_spec("matplotlib") else "PIL"
    if not np.array_equal(demo._read_image(png), img):
        raise SystemExit(f"--input_img: the {decoder} decode differs from the PNG's pixels")
    demo_runs = {}
    for device, extra in (("cuda", ["--input_img", png]), ("cpu", ["--cam_steps", "20"])):
        argv = ["--input_pose", os.path.join(root, "coco_f32.npy"), "--joint_set", "coco",
                "--weights", best, "--device", device,
                "--out_dir", os.path.join(out, f"demo_{device}")] + extra
        reset_launches()
        t0 = time.time()
        res = demo.main(argv)
        wall = time.time() - t0
        (person,) = res["people"]
        with open(person["obj"]) as f:
            verts = np.array([[float(v) for v in line.split()[1:]] for line in f
                              if line.startswith("v ")])
        demo_runs[device] = {"wall_s": wall, "forward_s": person["forward_s"],
                             "camera_ms": person["camera_s"] * 1e3, "launches": read_launches(),
                             "verts": verts, "joints3d": np.float64(person["joints3d"])}
    card_run = demo_runs["cuda"]
    if card_run["launches"] != expect(fused_cheby_conv_train=DATA_TRAIN_CONVS) or \
            demo_runs["cpu"]["launches"] != expect():
        raise SystemExit(f"float32 demo launches {card_run['launches']}")
    if not os.path.exists(os.path.join(out, "demo_cuda", "person_0_overlay.png")):
        raise SystemExit("float32 demo: no overlay on the --input_img photo")

    def rel_np(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    mesh_err = rel_np(card_run["verts"], demo_runs["cpu"]["verts"])
    joints_err = rel_np(card_run["joints3d"], demo_runs["cpu"]["joints3d"])
    log(f"phase 14: float32 demo, --input_img {decoder}-decoded PNG: {card_run['wall_s']:.2f} s "
        f"a person (forward {card_run['forward_s']:.4f} s, camera fit "
        f"{card_run['camera_ms']:.1f} ms); launches {card_run['launches']}; mesh card vs CPU "
        f"rel_l2 {mesh_err:.2e}, joints {joints_err:.2e} (tolerance {F32_DEMO_MESH_TOL}) "
        f"({card})")
    if not (mesh_err <= F32_DEMO_MESH_TOL and joints_err <= F32_DEMO_MESH_TOL):
        raise SystemExit(f"float32 demo: the card's mesh differs from the CPU's ({mesh_err}, "
                         f"{joints_err})")
    demo_out = {"decoder": decoder, "s_per_person": card_run["wall_s"],
                "forward_s": card_run["forward_s"], "camera_ms": card_run["camera_ms"],
                "launches": card_run["launches"], "mesh_vs_cpu": mesh_err,
                "joints_vs_cpu": joints_err}
    return {"train": train, "test": {"runs": runs, "rel_diff": rel}, "demo": demo_out}


# the deploy Tester's band-conv calls a forward on the datasets' graph (6
# basis-order + 2 narrowing convs): each further path's
DATA_PATH_LAUNCHES = {"strip": {"strip_cheby_conv": 8}, "window": {"window_cheby_conv": 8},
                      "unfused": {"banded_hop": 16}}


def f32_path_testers(root, out, best, train_form, keys, card) -> dict:
    """Phase 14.4 on the further paths: a float32 deploy Tester (Tester(cfg,
    model=...)) with best.pth.tar's folded weights on the strip, window and
    unfused paths, every metric within F32_DEPLOY_VS_TRAIN_TOL of the
    training-form eval `train_form`, DATA_PATH_LAUNCHES a forward."""
    from pose2mesh_release_tpu_torch.config import load_config
    from pose2mesh_release_tpu_torch.core import engine
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    cfg = load_config(engine_cfg(os.path.join(root, "test_f32_paths.json"), root, out,
                                 TEST={"deploy": True}, TPU={"compute_dtype": "f32"}))
    group = engine.Tester(cfg, load_path=best, debug=True, device="cuda")  # folded weights
    net = group.model
    runs = {}
    for path, (kw, _, _) in PATHS.items():
        model = Pose2Mesh(net.num_joint, group.dataset.graph.mesh_ops[-1].num_vertices,
                          blocks=net.pose2mesh.blocks,
                          posenet_hidden=net.pose_lifter.w1.out_features,
                          dtype=net.pose2mesh.dtype, device="cuda", **kw)
        model.load_state_dict(net.state_dict())
        reset_launches()
        with EngineProbe() as probe:  # wraps the step maker the Tester calls
            res = engine.Tester(cfg, dataset=group.dataset, model=model,
                                device="cuda").test(0)
        want = DATA_PATH_LAUNCHES[path]
        _check_steps(f"float32 Tester ({path}) forwards", probe.eval, want, len(probe.eval))
        if read_launches() != expect(**{k: v * len(probe.eval) for k, v in want.items()}) \
                or not probe.eval:
            raise SystemExit(f"float32 Tester ({path}): launches {read_launches()}")
        rel = {k: abs(res[k] - train_form[k]) / abs(train_form[k]) for k in keys}
        log(f"phase 14: float32 deploy Tester on the {path} path: eval-step ms per batch "
            f"{[round(t, 3) for t in probe.eval_ms]}, launches per forward {probe.eval[0]}; "
            f"vs training form { {k: f'{v:.2e}' for k, v in rel.items()} } (tolerance "
            f"{F32_DEPLOY_VS_TRAIN_TOL}) ({card})")
        if not all(v <= F32_DEPLOY_VS_TRAIN_TOL for v in rel.values()):
            raise SystemExit(f"float32 Tester ({path}) disagrees with the training-form eval: "
                             f"{rel}")
        runs[path] = {"result": res, "eval_ms": probe.eval_ms,
                      "launches_per_forward": probe.eval[0], "rel_diff": rel}
    return runs


def f32_layer(root: str, card) -> dict:
    """Phase 14: the float32 instances and the float32 paths at full SMPL
    width (14.1 kernels, 14.2 deploy forwards, 14.3 train steps, 14.4 the
    entry points over phase 12's stand-in files under `root`)."""
    import torch
    from pose2mesh_release_tpu_torch.deploy import mano_deploy_forward, smpl_deploy_forward
    precision = getattr(torch.backends.cuda.matmul, "fp32_precision", "ieee")
    log(f"phase 14: float32; matmul allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
        f"fp32_precision {precision}, cudnn allow_tf32 {torch.backends.cudnn.allow_tf32} "
        f"({card})")
    if torch.backends.cuda.matmul.allow_tf32 or precision != "ieee":
        raise SystemExit("phase 14: the plain float32 versions need full float32 matmuls")
    deploy = smpl_deploy_forward(dtype=torch.float32, device="cuda", seed=0)
    mano = mano_deploy_forward(dtype=torch.float32, device="cuda", seed=0)
    by_v = {op.num_vertices: op for op in deploy.art.mesh_ops}
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows, train_rows, mano_rows = f32_kernels(by_v, mano.art.mesh_ops[0], gen)
    report = {"convs": rows, "train_convs": train_rows, "mano_convs": mano_rows,
              "mano_kernels": mano_table(mano_rows), "forward": f32_forward(deploy, mano, card)}
    del deploy, mano
    torch.cuda.empty_cache()
    setup, report["train"] = f32_train(card)
    report["unfused_train"] = f32_unfused_train(setup, card)
    del setup
    torch.cuda.empty_cache()
    report["engine"] = f32_engine(root, card)
    return report


# ---- phase 15: multi-device ------------------------------------------------
# gloo ranks, every one on cuda:0 (NCCL puts one rank on a card): the halo
# hop at each SMPL band level and the band_k = 2 level on 2 and 4 graph
# ranks against the one-device K4 (forward and VJP, float32 rel_l2 1e-6,
# bf16 1e-2, two runs equal bits); the full-width SMPL train step (batch 64
# global, 32 a data rank, PoseNet 4096, SGD, dropout 0) on (2, 1) in float32
# and bf16 and on (2, 2) in float32 against the one-device step of the same
# weights, batch and dtype (MESH_STEP_TOLS), with each rank's launches and the
# census of its collectives; the float32 deploy Tester over phase 12's files
# on (2, 1) and (2, 2) against phase 14's 1 x 1 deploy Tester (every metric
# 1e-4); NCCL at world size 1.
MESH_SHAPES = {2: (2, 1), 4: (2, 2)}  # ranks a spawn -> the (data, graph) mesh
MESH_DTYPES = {2: ("float32", "bfloat16"), 4: ("float32",)}
# The mesh step against the one-device step: the loss (relative), and but
# for the cancelling biases (`cancelling_biases`, reported) the gradients as
# one vector, each gradient and each parameter after the step, all rel_l2.  float32: a
# fixed floor or MESH_F32_SCALE times the one-device step's own spread when
# only the batch's halves are swapped, whichever is larger (the mesh reorders
# the same float32 sums; that spread reaches 2.4e-2 for one gradient at full
# SMPL width on an H100, and the plain float32 step on the CPU shows the same,
# tools/step_spread.py).  bf16: fixed limits, set above what an H100 reads
# (6.6e-2 as one vector, at most 0.10 for a gradient or parameter): each data
# rank rounds its partial batch sums to bf16, which the one-device step does
# once.  A missing 1/D in the gradient sync reads 1.0 for every gradient.
MESH_STEP_TOLS = {
    "float32": {"loss": F32_STEP_LOSS_TOL, "whole": 1e-3, "grad": F32_STEP_GRAD_TOL,
                "param": 1e-4},
    "bfloat16": {"loss": STEP_LOSS_TOL, "whole": 0.15, "grad": 0.2, "param": 0.2}}
MESH_F32_SCALE = 4.0
HALO_TOLS = {"float32": 1e-6, "bfloat16": KERNEL_TOL}
HALO_F = 128
MESH_TIMED_STEPS = 2
MESH_JOIN_S = 480
MESH_LABEL = "gloo, {n} ranks on one card: not a scaling number"
# a rank's launches per step: (2, 1) K1 and K2 on the 10 band convs; (2, 2)
# two halo hops forward and two backward per band conv, nothing fused
MESH_STEP_LAUNCHES = {(2, 1): {"fused_cheby_conv_train": 10, "fused_cheby_conv_bwd": 10},
                      (2, 2): {"banded_hop": 40}}
# a rank's launches per deploy forward on the datasets' graph (3 band
# levels, 8 band convs): (2, 1) the group kernels, (2, 2) two halo hops a conv
MESH_DEPLOY_LAUNCHES = {(2, 1): DATA_DEPLOY_LAUNCHES, (2, 2): {"banded_hop": 16}}
MESH_METRICS = ("joint_err", "mesh_err", "mpjpe", "pa_mpjpe", "mpvpe")


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_halo(mesh, levels, dev) -> list:
    """Phase 15a on one rank: each level's halo hop and its VJP, in bf16 and
    float32, against the one-device K4 on the whole tensor (this rank's
    rows); its launches, equal bits, bytes a side, ms, and the ms of its
    exchange (gloo-staged) and of K4 on the slab apart (not counted)."""
    import torch
    from pose2mesh_release_tpu_torch.graphs.artifact import LevelOperator
    from pose2mesh_release_tpu_torch.ops import hop as hp
    from pose2mesh_release_tpu_torch.parallel.collectives import exchange_halo
    from pose2mesh_release_tpu_torch.parallel.halo import global_rows, halo_banded_hop
    from pose2mesh_release_tpu_torch.parallel.sharding import shard_level
    B_l, rows_out = BATCH // 2, []
    for name, band_np, V in levels:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            band = torch.from_numpy(band_np).to(dev, dtype)
            op = shard_level(LevelOperator(kind="band", band_val=band, num_vertices=V,
                                           block_size=128, band_k=band.shape[0] // 2), mesh)
            g = torch.Generator(device=dev).manual_seed(V)
            x = torch.randn(V, B_l, HALO_F, generator=g, device=dev).to(dtype)
            gy = torch.randn(V, B_l, HALO_F, generator=g, device=dev).to(dtype)
            want, want_dx = hp.hop(band, x), hp.hop(band, gy)
            rows, j = op.padded_vertices, mesh.graph_rank
            lo, hi = j * rows, min((j + 1) * rows, V)

            def local(t):
                t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, global_rows(op, mesh.graph) - V))
                return t[j * rows:(j + 1) * rows].contiguous()
            xl = local(x).requires_grad_()
            reset_launches()
            y = halo_banded_hop(op, xl, mesh)
            y.backward(local(gy))
            again = halo_banded_hop(op, xl.detach(), mesh)
            _sync(dev)
            launches = read_launches()
            t0 = time.perf_counter()
            for _ in range(3):
                halo_banded_hop(op, xl.detach(), mesh)
            _sync(dev)
            hop_ms = (time.perf_counter() - t0) * 1e3 / 3
            # the hop's two parts apart: the exchange (gloo-staged) and K4
            t0 = time.perf_counter()
            for _ in range(3):
                exchange_halo(xl.detach().reshape(rows // 128, 128, -1), op.band_k, mesh,
                              site="timing")
            _sync(dev)
            exchange_ms = (time.perf_counter() - t0) * 1e3 / 3
            k4_ms = None
            if dev.type == "cuda":
                ext = torch.zeros(op.band_val.shape[1] * 128, *x.shape[1:], device=dev,
                                  dtype=dtype)
                k4_ms = cuda_ms(lambda: hp.hop(op.band_val, ext), 5)
            n = hi - lo
            row = {"level": name, "dtype": dt, "ranks": mesh.graph,
                   "err": rel_l2(y.detach()[:n], want[lo:hi]),
                   "vjp_err": rel_l2(xl.grad[:n], want_dx[lo:hi]),
                   "equal_bits": bool(torch.equal(again, y.detach())),
                   "pad_rows_zero": not bool(y.detach()[n:].any()),
                   "launches": launches, "ms": hop_ms, "exchange_ms": exchange_ms,
                   "k4_ms": k4_ms,
                   "bytes_a_side": op.band_k * 128 * B_l * HALO_F * band.element_size()}
            row["ok"] = (row["err"] <= HALO_TOLS[dt] and row["vjp_err"] <= HALO_TOLS[dt]
                         and row["equal_bits"] and row["pad_rows_zero"]
                         and launches == expect(banded_hop=3 if dev.type == "cuda" else 0))
            rows_out.append(row)
    return rows_out


def cancelling_biases(model) -> set:
    """The biases whose output enters a training BatchNorm: MeshNet's convs
    but the last, PoseNet's first layer, each stage's w1 and the first
    stage's w2.  The BatchNorm removes any constant over the rows, so their
    gradient is zero up to the rounding of its sums or, where a residual
    bypasses the BatchNorm, what that path carries: a sum that cancels, whose
    rel_l2 measures rounding.  Phase 15b leaves them out of the per-parameter
    checks and from the gradients as one vector, and reports them."""
    stages = len(model.pose_lifter.linear_stages)
    return ({f"pose2mesh.cl.{i}.bias" for i in range(len(model.pose2mesh.cl) - 1)}
            | {"pose_lifter.w1.bias"}
            | {f"pose_lifter.linear_stages.{j}.w1.bias" for j in range(stages)}
            | {f"pose_lifter.linear_stages.{j}.w2.bias" for j in range(stages - 1)})


def _mesh_step(spec, graph_axis, dt, dev) -> dict:
    """Phase 15b on one rank: the one-device SGD step of the global batch in
    `dt` (float32: also the spread of its own rounding, the same step with
    the batch's halves swapped), then from the same state the step on the
    mesh (this rank's rows), held against it; the census of the mesh step;
    MESH_TIMED_STEPS more steps, each timed and its launches counted; the
    gradient sync alone, timed."""
    import copy

    import torch
    from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
    from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
    from pose2mesh_release_tpu_torch.graphs.artifact import load_artifact
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    from pose2mesh_release_tpu_torch.parallel.audit import (
        band_threshold, boundary_gathers, census,
    )
    from pose2mesh_release_tpu_torch.parallel.mesh import make_mesh
    from pose2mesh_release_tpu_torch.parallel.sharding import (
        shard_artifact, shard_batch, shard_state, sync_grads,
    )
    mesh = make_mesh(graph_axis)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in spec["batch"].items()}

    def cascade(dtype):
        art = load_artifact(spec["art"], device=dev).to(dev, dtype)
        return art, Pose2Mesh(art.joint_num, art.mesh_ops[-1].num_vertices, dtype=dtype,
                              posenet_hidden=spec["hidden"], blocks=spec["blocks"],
                              inference_fused=False, dropout=0.0, device=dev,
                              generator=torch.Generator().manual_seed(0))

    def one_device(model, art, b):
        """(loss, gradients, parameters after) of the one-device step."""
        model.load_state_dict(snapshot)
        opt = make_preconditioner("sgd", model.parameters())
        _, losses = make_train_step(model, opt, spec["jreg"], device=dev)(
            TrainState(model, opt), art, b, LR, True, None)
        return (float(losses["total"]),
                {n: p.grad.detach().float().clone() for n, p in model.named_parameters()},
                {n: p.detach().float().clone() for n, p in model.named_parameters()})
    art, model = cascade(getattr(torch, dt))
    snapshot = copy.deepcopy(model.state_dict())
    ref_loss, ref_grads, ref_params = one_device(model, art, batch)
    grad_scale = param_scale = dict.fromkeys(ref_grads)
    if dt == "float32":
        B = batch["pose2d"].shape[0]
        swap = torch.cat([torch.arange(B // 2, B), torch.arange(B // 2)]).to(dev)
        _, swap_grads, swap_params = one_device(model, art,
                                                {k: v[swap] for k, v in batch.items()})
        grad_scale = {n: rel_l2(ref_grads[n], swap_grads[n]) for n in ref_grads}
        param_scale = {n: rel_l2(ref_params[n], swap_params[n]) for n in ref_params}
    model.load_state_dict(snapshot)
    opt = make_preconditioner("sgd", model.parameters())
    state = TrainState(model, opt)
    shard_state(model.use_mesh(mesh), mesh)
    step = make_train_step(model, opt, spec["jreg"], device=dev, mesh=mesh)
    art_s, local = shard_artifact(art, mesh), shard_batch(batch, mesh)
    reset_launches()
    with census(mesh) as c:
        _, losses = step(state, art_s, local, LR, True, None)
        _sync(dev)
    first = read_launches()
    named = dict(model.named_parameters())
    cancelling = cancelling_biases(model)
    held = [n for n in named if n not in cancelling]
    grads = {n: (rel_l2(named[n].grad, ref_grads[n]), grad_scale[n]) for n in held}
    params = {n: (rel_l2(named[n].detach(), ref_params[n]), param_scale[n]) for n in held}
    cancelling_grads = {n: rel_l2(named[n].grad, ref_grads[n]) for n in sorted(cancelling)}

    def whole(a, b) -> float:
        """rel_l2 of the held gradients as one vector."""
        return math.sqrt(sum(float((a[n].float() - b[n]).square().sum()) for n in held)
                         / sum(float(b[n].square().sum()) for n in held))
    whole_grad = whole({n: named[n].grad for n in held}, ref_grads)
    whole_scale = whole(ref_grads, swap_grads) if dt == "float32" else None
    ms, per_step = [], []
    for _ in range(MESH_TIMED_STEPS):
        reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        step(state, art_s, local, LR, True, None)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append(read_launches())
    split = model.pose2mesh.graph_split_parameters(art_s)
    _sync(dev)
    t0 = time.perf_counter()
    sync_grads(model.parameters(), mesh, split)
    _sync(dev)
    sync_ms = (time.perf_counter() - t0) * 1e3
    return {"loss": float(losses["total"]), "one_device_loss": ref_loss,
            "loss_rel_err": abs(float(losses["total"]) - ref_loss) / abs(ref_loss),
            "grads": grads, "whole_grad_rel_l2": whole_grad,
            "whole_scale_rel_l2": whole_scale, "params": params,
            "cancelling_grads": cancelling_grads,
            "first_step_launches": first, "launches_per_step": per_step,
            "ms_per_step": ms, "grad_sync_ms": sync_ms,
            "census": c.summary(), "records": list(c.records),
            "checksum": float(sum(float(p.detach().double().sum()) for p in named.values())),
            "threshold": band_threshold(art, batch["pose2d"].shape[0] // mesh.data, 64),
            "allowed_gathers": boundary_gathers(art_s)}


def _mesh_tester(spec, shape, dev) -> dict:
    """Phase 15d on one rank: the float32 deploy Tester of best.pth.tar over
    phase 12's files on the mesh, its launches a forward and eval-step ms."""
    from pose2mesh_release_tpu_torch.config import load_config
    from pose2mesh_release_tpu_torch.core import engine
    cfg = load_config(spec["tester_cfg"])
    reset_launches()
    with EngineProbe() as probe:
        res = engine.Tester(cfg, load_path=spec["best"], debug=True, device=dev).test(0)
    return {"result": {k: res[k] for k in MESH_METRICS}, "forward_launches": probe.eval,
            "eval_ms": probe.eval_ms, "total_launches": read_launches()}


def mesh_rank(rank: int, world: int, spec: dict) -> dict:
    """One rank of phase 15 (a spawned process in a gloo group, on
    spec["device"]): the halo checks on a (1, world) mesh, the steps, the
    Tester.  spec: the SMPL artifact's npz, the global batch and regressor,
    the halo levels, the dtypes, the Tester's experiment file and checkpoint,
    PoseNet's width and MeshNet's blocks (None: SMPL_BLOCKS).  On the CPU
    (a rehearsal at small shapes) the kernels' plain versions run."""
    import torch
    from pose2mesh_release_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(spec["device"].format(rank=rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"halo": _mesh_halo(make_mesh(world), spec["halo"], dev) if spec["halo"] else []}
    shape = MESH_SHAPES[world]
    out["steps"] = {dt: _mesh_step(spec, shape[1], dt, dev) for dt in spec["dtypes"]}
    torch.cuda.empty_cache()
    out["tester"] = _mesh_tester(spec, shape, dev) if spec["tester_cfg"] else None
    return out


def _nccl_world_one(card) -> dict:
    """Phase 15e: NCCL at world size 1 on cuda:0: all_reduce_sum and the
    gradient sync leave their inputs as they are."""
    import torch
    import torch.distributed as dist
    from pose2mesh_release_tpu_torch.parallel.collectives import all_reduce_sum
    from pose2mesh_release_tpu_torch.parallel.distributed import init_distributed
    from pose2mesh_release_tpu_torch.parallel.mesh import make_mesh
    from pose2mesh_release_tpu_torch.parallel.sharding import sync_grads
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", "cuda", init_method=f"file://{tmp}/rendezvous", rank=0,
                         world_size=1)
        try:
            mesh = make_mesh(1)
            x = torch.randn(4096, device="cuda", requires_grad=True)
            y = all_reduce_sum(x, mesh, "data", site="check")
            y.backward(torch.ones_like(y))
            lin = torch.nn.Linear(256, 128).cuda()
            lin(torch.randn(8, 256, device="cuda")).square().sum().backward()
            want = [p.grad.clone() for p in lin.parameters()]
            sync_grads(lin.parameters(), mesh)
            torch.cuda.synchronize()
            ok = (torch.equal(y, x.detach()) and bool((x.grad == 1).all())
                  and all(torch.equal(p.grad, w) for p, w in zip(lin.parameters(), want)))
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    log(f"phase 15e: NCCL at world size 1 ({backend}): all_reduce_sum and the gradient "
        f"sync {'ok' if ok else 'FAILED'} ({card})")
    if not ok:
        raise SystemExit("phase 15e: NCCL at world size 1 changed its inputs")
    return {"backend": backend, "ok": ok}


def mesh_world(world: int, spec: dict, report: dict, deploy_result, card) -> None:
    """Phase 15a-d on `world` spawned ranks (the mesh MESH_SHAPES[world]):
    run mesh_rank, hold its results, add them to `report`.  deploy_result:
    the 1 x 1 deploy Tester's metrics (None when spec has no Tester)."""
    from pose2mesh_release_tpu_torch.parallel.audit import (
        Census, TRANSITION_SITES, assert_no_large_gather,
    )
    from pose2mesh_release_tpu_torch.parallel.distributed import spawn_ranks
    shape = MESH_SHAPES[world]
    batch = spec["batch"]["pose2d"].shape[0]
    tag = f"{shape[0]}x{shape[1]}"
    t0 = time.time()
    ranks = spawn_ranks(mesh_rank, world, (spec,), timeout=MESH_JOIN_S)
    wall = time.time() - t0
    label = MESH_LABEL.format(n=world)
    # (a) the halo hop on `world` graph ranks
    for rank, r in enumerate(ranks if spec["halo"] else []):
        for row in r["halo"]:
            report["halo"].append({**row, "rank": rank})
    bad = [(x["level"], x["dtype"], x["rank"]) for x in report["halo"]
           if x["ranks"] == world and not x["ok"]]
    worst = {dt: max((max(x["err"], x["vjp_err"]) for x in report["halo"]
                      if x["ranks"] == world and x["dtype"] == dt), default=0.0)
             for dt in HALO_TOLS}
    first = spec["halo"][0][0] if spec["halo"] else None
    ms6890 = [tuple(round(x[k], 3) for k in ("ms", "exchange_ms", "k4_ms") if x[k] is not None)
              for x in report["halo"] if x["ranks"] == world
              and x["level"] == first and x["dtype"] == "bfloat16"]
    if spec["halo"]:
        log(f"phase 15a: halo hop on {world} graph ranks at {[lv[0] for lv in spec['halo']]}: "
            f"worst rel_l2 (forward, VJP) bf16 {worst['bfloat16']:.2e}, float32 "
            f"{worst['float32']:.2e} (tolerances {HALO_TOLS}); first level's bf16 ms a hop "
            f"(the hop, its exchange, K4) by rank {ms6890} ({label}); "
            f"{ranks[0]['halo'][0]['bytes_a_side']} bytes a "
            f"side there ({card})")
    if bad:
        raise SystemExit(f"phase 15a: halo hop disagrees with K4 or launched wrong: {bad}")
    # (b) the train steps and (c) their census
    for dt in spec["dtypes"]:
        tol = MESH_STEP_TOLS[dt]
        steps = [r["steps"][dt] for r in ranks]
        key = f"{tag} {dt}"
        want = expect(**MESH_STEP_LAUNCHES[shape])

        def limit(kind: str, scale) -> float:
            """A float32 scale widens the fixed limit to MESH_F32_SCALE x it."""
            return tol[kind] if scale is None else max(tol[kind], MESH_F32_SCALE * scale)
        for rank, s in enumerate(steps):
            # (name, error, its float32 spread) nearest its limit
            s["worst_grad"] = max(((n, e, sp) for n, (e, sp) in s["grads"].items()),
                                  key=lambda x: x[1] / limit("grad", x[2]))
            s["worst_param"] = max(((n, e, sp) for n, (e, sp) in s["params"].items()),
                                   key=lambda x: x[1] / limit("param", x[2]))
            (_, e, sp), (_, pe, psp) = s["worst_grad"], s["worst_param"]
            ok = (s["loss_rel_err"] <= tol["loss"]
                  and s["whole_grad_rel_l2"] <= limit("whole", s["whole_scale_rel_l2"])
                  and e <= limit("grad", sp) and pe <= limit("param", psp)
                  and s["first_step_launches"] == want
                  and all(count == want for count in s["launches_per_step"]))
            if not ok:
                raise SystemExit(f"phase 15b: {key} rank {rank}: loss {s['loss_rel_err']}, "
                                 f"whole gradient {s['whole_grad_rel_l2']}, "
                                 f"grad {s['worst_grad']}, param {s['worst_param']}, "
                                 f"launches {s['first_step_launches']} != {want} "
                                 f"(limits {tol}, float32 scale x{MESH_F32_SCALE})")
        if len({s["checksum"] for s in steps}) != 1:
            raise SystemExit(f"phase 15b: {key}: the ranks' parameters differ after the "
                             f"step ({[s['checksum'] for s in steps]})")
        c = Census()
        c.records = [tuple(x) for x in steps[0]["records"]]
        allow = steps[0]["allowed_gathers"]
        assert_no_large_gather(c, steps[0]["threshold"], allow, context=key)
        gathers = [x for x in c.records if x[0] == "all_gather"
                   and x[3] >= steps[0]["threshold"]]
        report["steps"][key] = {
            "ms_per_step": [s["ms_per_step"] for s in steps],
            "grad_sync_ms": [s["grad_sync_ms"] for s in steps],
            "loss_rel_err": max(s["loss_rel_err"] for s in steps),
            "worst_grad_rel_l2": max((s["worst_grad"] for s in steps), key=lambda x: x[1]),
            "largest_grad_rel_l2": max(((n, e, sp) for s in steps
                                        for n, (e, sp) in s["grads"].items()),
                                       key=lambda x: x[1]),
            "whole_grad_rel_l2": max(s["whole_grad_rel_l2"] for s in steps),
            "whole_scale_rel_l2": steps[0]["whole_scale_rel_l2"],
            "worst_param_rel_l2": max((s["worst_param"] for s in steps),
                                      key=lambda x: x[1]),
            "cancelling_grad_rel_l2": {n: max(s["cancelling_grads"][n] for s in steps)
                                       for n in steps[0]["cancelling_grads"]},
            "limits": tol,
            "launches_per_step": steps[0]["launches_per_step"][0],
            "census": steps[0]["census"], "band_sized_gathers": len(gathers),
            "allowed_gathers": allow, "label": label}
        log(f"phase 15b: {key} step, global batch {batch} ({batch // shape[0]} a data "
            f"rank): ms per step by rank "
            f"{[[round(t, 1) for t in s['ms_per_step']] for s in steps]} "
            f"({label}; the gradient sync alone "
            f"{[round(s['grad_sync_ms'], 1) for s in steps]} ms); "
            f"loss {steps[0]['loss']:.6f} vs one device "
            f"{steps[0]['one_device_loss']:.6f} (rel {report['steps'][key]['loss_rel_err']:.2e}); "
            f"gradient (name, rel_l2, its float32 half-swap spread) nearest its limit "
            f"{report['steps'][key]['worst_grad_rel_l2']}, largest "
            f"{report['steps'][key]['largest_grad_rel_l2']}, all as one vector "
            f"{report['steps'][key]['whole_grad_rel_l2']:.2e} (spread "
            f"{report['steps'][key]['whole_scale_rel_l2']}); parameter "
            f"{report['steps'][key]['worst_param_rel_l2']} (limits {tol}); the cancelling "
            f"biases' largest "
            f"{max(report['steps'][key]['cancelling_grad_rel_l2'].items(), key=lambda x: x[1])}"
            f"; launches a step "
            f"{steps[0]['launches_per_step'][0]} ({card})")
        log(f"phase 15c: {key} census (rank 0): {steps[0]['census']['by_kind']}; "
            f"band-sized gathers {len(gathers)} at {sorted({x[1] for x in gathers})} "
            f"(allowed {allow}: sites {TRANSITION_SITES})")
    # (d) the float32 deploy Tester
    if spec["tester_cfg"] is None:
        return
    results = [r["tester"] for r in ranks]
    want_fwd = MESH_DEPLOY_LAUNCHES[shape]
    rel = {k: max(abs(t["result"][k] - deploy_result[k]) / abs(deploy_result[k])
                  for t in results) for k in MESH_METRICS}
    for rank, t in enumerate(results):
        if not t["forward_launches"] or any(
                f != {k: v for k, v in want_fwd.items()} for f in t["forward_launches"]):
            raise SystemExit(f"phase 15d: {tag} Tester rank {rank}: launches a forward "
                             f"{t['forward_launches']} != {want_fwd}")
    if not all(v <= F32_DEPLOY_VS_TRAIN_TOL for v in rel.values()):
        raise SystemExit(f"phase 15d: {tag} Tester disagrees with 1 x 1: {rel}")
    report["tester"][tag] = {"rel_diff": rel, "eval_ms": [t["eval_ms"] for t in results],
                             "launches_per_forward": results[0]["forward_launches"][0],
                             "label": label}
    log(f"phase 15d: float32 deploy Tester on {tag}: vs 1 x 1 "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tolerance "
        f"{F32_DEPLOY_VS_TRAIN_TOL}); launches a forward {results[0]['forward_launches'][0]}; "
        f"eval-step ms by rank {[[round(x, 1) for x in t['eval_ms']] for t in results]} "
        f"({label}); spawn wall {wall:.1f} s ({card})")


def mesh_layer(root: str, card, deploy_result: dict) -> dict:
    """Phase 15: multi-device (see MESH_SHAPES), in spawned gloo ranks on
    cuda:0; deploy_result: phase 14's 1 x 1 float32 deploy Tester metrics."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
    from pose2mesh_release_tpu_torch.deploy import build_artifact
    from pose2mesh_release_tpu_torch.graphs.artifact import save_artifact
    from pose2mesh_release_tpu_torch.parallel.distributed import spawn_ranks
    from pose2mesh_release_tpu_torch.train_setup import synthetic_batch
    t_start = time.time()
    torch.cuda.empty_cache()
    smpl = SMPL()
    art = build_artifact(smpl.face, HUMAN36, 9, torch.device("cpu"))
    art_path = os.path.join(root, "smpl_artifact.npz")
    save_artifact(art_path, art)
    rng = np.random.default_rng(0)
    jreg = rng.random((17, art.num_vertices)).astype(np.float32)
    jreg /= jreg.sum(axis=1, keepdims=True)
    batch = synthetic_batch(smpl.v_template, BATCH, jreg, rng)
    levels = [(str(op.num_vertices), op.band_val.numpy(), op.num_vertices)
              for op in art.mesh_ops if op.kind == "band"]
    levels.append(("3475 band_k 2", k2_level(3475).band_val.numpy(), 3475))
    best = os.path.join(root, "experiment_f32", "checkpoint", "best.pth.tar")
    report = {"label": MESH_LABEL, "card": card, "halo": [], "steps": {}, "tester": {}}
    for world, shape in MESH_SHAPES.items():
        tag = f"{shape[0]}x{shape[1]}"
        tester_cfg = engine_cfg(os.path.join(root, f"test_mesh_{tag}.json"), root,
                                os.path.join(root, f"experiment_mesh_{tag}"),
                                TEST={"deploy": True},
                                TPU={"compute_dtype": "f32", "data_axis": shape[0],
                                     "graph_axis": shape[1]})
        spec = {"device": "cuda:0", "art": art_path, "batch": batch, "jreg": jreg,
                "halo": levels, "dtypes": MESH_DTYPES[world], "tester_cfg": tester_cfg,
                "best": best, "hidden": 4096, "blocks": None}
        mesh_world(world, spec, report, deploy_result, card)
    # (e) NCCL
    report["nccl"] = _nccl_world_one(card)
    if torch.cuda.device_count() >= 2:
        spec = {"device": "cuda:{rank}", "art": art_path, "batch": batch, "jreg": jreg,
                "halo": [], "dtypes": ("float32",), "tester_cfg": None, "best": best,
                "hidden": 4096, "blocks": None}
        ranks = spawn_ranks(mesh_rank, 2, (spec,), timeout=MESH_JOIN_S, backend="nccl")
        s = ranks[0]["steps"]["float32"]
        report["nccl"]["two_cards_2x1"] = {"ms_per_step": s["ms_per_step"],
                                           "loss_rel_err": s["loss_rel_err"]}
        log(f"phase 15e: NCCL (2, 1) float32 step across two cards: ms {s['ms_per_step']}, "
            f"loss rel {s['loss_rel_err']:.2e}")
    else:
        log(f"phase 15e: NCCL across two cards did not run: "
            f"{torch.cuda.device_count()} card(s) here")
    report["wall_s"] = time.time() - t_start
    log(f"phase 15: {report['wall_s']:.1f} s")
    return report


# phase 16, the JAX package's last modules: (a) the published-checkpoint
# runbook (the port's RefCascade, a reference-layout .pth.tar, the deploy
# forward in bf16 and float32 against RefCascade's float32 forward: mesh and
# joints relative L2; then cli.test on it), (b) the JAX .ckpt fixture served
# and resumed, (c) the 3DPW converter on the card against the CPU, (d) the
# rooflines beside phase 2's kernel times
REF_BATCHES = 4
REF_TOLS = {"bfloat16": FORWARD_TOL, "float32": F32_FORWARD_TOL}
JAX_FIXTURE = os.path.join("tests", "data", "jax_ckpt")
# the fixture's 4 band convs (770 and 385 rows): a deploy forward's, a step's
FIXTURE_DEPLOY_LAUNCHES = {"fused_cheby_conv": 3, "fused_cheby_conv_commuted": 1}
FIXTURE_STEP_LAUNCHES = {"fused_cheby_conv_train": 4, "fused_cheby_conv_bwd": 4}
FIXTURE_STEP_TOLS = {"rtol": 1e-3, "atol": 1e-2, "step_rel_l2": 1e-2}
# RMSprop's largest step, in learning rates: |g| / sqrt(nu) <= 1 / sqrt(1 - 0.99)
RMS_BOUND = 1.0 / math.sqrt(1.0 - 0.99)
CONVERTER_TOL = 1e-5


def _randomize_batch_norms(model, generator) -> None:
    """Random affine and running statistics in every BatchNorm of `model`,
    so a folded deploy forward does real work."""
    import torch
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dtype == torch.long or not any(s in name for s in (".bn.", "batch_norm")):
                continue
            if name.endswith(("weight", "running_var")):
                t.copy_(torch.rand(t.shape, generator=generator) + 0.5)
            else:  # bias, running_mean
                t.copy_(torch.randn(t.shape, generator=generator) * 0.1)


def reference_checkpoint(path: str, joint_num: int, pyr, seed: int):
    """The port's RefCascade (SMPL_BLOCKS, PoseNet 4096) over `pyr`'s
    Laplacians with seeded weights, saved at `path` as the reference writes
    its checkpoints (DataParallel `module.` prefixes); returns the model on
    the card, float32, at eval."""
    import torch
    from pose2mesh_release_tpu_torch.models.meshnet import SMPL_BLOCKS
    from pose2mesh_release_tpu_torch.parity.torch_ref import RefCascade
    torch.manual_seed(seed)
    ref = RefCascade(joint_num, SMPL_BLOCKS, list(pyr.mesh_laplacians) + [pyr.joint_laplacian],
                     hidden=4096)
    _randomize_batch_norms(ref, torch.Generator().manual_seed(seed))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": 10, "model_state_dict": {f"module.{k}": v for k, v in
                                                  ref.state_dict().items()}}, path)
    return ref.cuda().eval()


class RefEval:
    """RefCascade as an eval step (eval_loop's `d`): mesh mm in the original
    vertex order, the regressed joints, the lifted pose."""

    def __init__(self, ref, vertex_slot, j_regressor):
        import torch
        self.ref, self.art_compute = ref, None
        self.slot = torch.as_tensor(vertex_slot, device="cuda")
        self.jreg = torch.as_tensor(j_regressor, dtype=torch.float32, device="cuda")

    def eval_step(self, _art, pose2d):
        import torch
        with torch.no_grad():
            mesh, pose3d = self.ref(pose2d.float())
        mesh_mm = mesh.index_select(1, self.slot) * 1000.0
        return mesh_mm, torch.einsum("jv,bvc->bjc", self.jreg, mesh_mm), pose3d


def ref_runbook(root: str, card) -> dict:
    """Phase 16 (a): a reference-layout final.pth.tar of the port's
    RefCascade over phase 3's SMPL pyramid (17 H36M joints, dense_threshold
    768) through the deploy forward (group path, BatchNorm folded at load):
    bf16 and float32, REF_BATCHES batches of BATCH, exactly 8 group + 2
    commuted convs a forward, each against RefCascade's float32 forward;
    then a 19-joint one over the datasets' graph through cli.test on phase
    12's PW3D files (6 + 2 a forward) against the same evaluation of
    RefCascade (EVAL_TOL, relative)."""
    import torch
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.cli import test as cli_test
    from pose2mesh_release_tpu_torch.core.checkpoint import load_checkpoint
    from pose2mesh_release_tpu_torch.core.train import make_eval_step
    from pose2mesh_release_tpu_torch.data import get_dataset_class
    from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
    from pose2mesh_release_tpu_torch.deploy import DENSE_THRESHOLD, POSENET_HIDDEN
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    smpl = SMPL()
    t0 = time.time()
    pyr = build_pyramid(smpl.face, joint_num=HUMAN36.joint_num, skeleton=HUMAN36.skeleton,
                        flip_pairs=HUMAN36.flip_pairs, levels=9,
                        extra_joint_edges=HUMAN36.extra_edges)
    art = pack_pyramid(pyr, smpl.face, dense_threshold=DENSE_THRESHOLD, device="cuda")
    ckpt = os.path.join(root, "reference", "final.pth.tar")
    ref = reference_checkpoint(ckpt, HUMAN36.joint_num, pyr, seed=16)
    setup_s = time.time() - t0
    g = torch.Generator().manual_seed(16)
    batches = [torch.randn(BATCH, HUMAN36.joint_num, 2, generator=g).cuda()
               for _ in range(REF_BATCHES)]
    ref_eval = RefEval(ref, pyr.vertex_slot, smpl.joint_regressor_h36m)
    want = [ref_eval.eval_step(None, p) for p in batches]
    torch.cuda.synchronize()
    ref_ms = cuda_ms(lambda: ref_eval.eval_step(None, batches[0]), 3)
    t0 = time.perf_counter()
    sd = load_checkpoint(ckpt, device="cuda")["model_state_dict"]
    load_s = time.perf_counter() - t0
    log(f"phase 16 (a): RefCascade (PoseNet 4096, SMPL_BLOCKS) over phase 3's pyramid, "
        f"final.pth.tar of {os.path.getsize(ckpt) / 2**20:.1f} MiB written and loaded onto "
        f"the card in {load_s:.3f} s (set-up {setup_s:.1f} s)")
    report = {"setup_s": setup_s, "load_s": load_s, "ref_ms_per_batch": ref_ms, "forward": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        model = Pose2Mesh(HUMAN36.joint_num, art.mesh_ops[-1].num_vertices,
                          posenet_hidden=POSENET_HIDDEN, dtype=dtype, device="cuda",
                          generator=torch.Generator().manual_seed(0))
        model.load_state_dict(fold_bn_variables(sd))
        step = make_eval_step(model, smpl.joint_regressor_h36m, device="cuda")
        art_c = art.to("cuda", dtype)
        step(art_c, batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        outs = [step(art_c, p) for p in batches]
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != expect(fused_cheby_conv=8 * REF_BATCHES,
                              fused_cheby_conv_commuted=2 * REF_BATCHES):
            raise SystemExit(f"phase 16 (a) {name}: launches {launches}")
        errs = {k: max(rel_l2(o[i], w[i]) for o, w in zip(outs, want))
                for i, k in enumerate(("mesh", "reg_joints", "lifted_joints"))}
        ms = cuda_ms(lambda: step(art_c, batches[0]), 3)
        report["forward"][name] = {"rel_l2": errs, "ms_per_batch": ms,
                                   "launches_per_forward": {k: v // REF_BATCHES for k, v in
                                                            launches.items() if v}}
        log(f"phase 16 (a): reference final.pth.tar through the {name} deploy forward, "
            f"{REF_BATCHES} batches of {BATCH}: rel_l2 vs RefCascade float32 "
            f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (tolerance {REF_TOLS[name]}); "
            f"{ms:.3f} ms a batch, RefCascade {ref_ms:.3f} ({card}); launches {launches}")
        if not all(e <= REF_TOLS[name] for e in errs.values()):
            raise SystemExit(f"phase 16 (a): the {name} deploy forward disagrees with "
                             f"RefCascade: {errs}")
        del model, outs
    del ref, ref_eval, want
    torch.cuda.empty_cache()

    # cli.test on a 19-joint reference checkpoint over the datasets' graph
    ds = get_dataset_class("PW3D")("test", data_dir=os.path.join(root, "PW3D"),
                                   mesh_model=SMPL(data_dir=root), device="cuda")
    js = ds.joint_set
    pyr = build_pyramid(smpl.face, joint_num=js.joint_num, skeleton=js.skeleton,
                        flip_pairs=js.flip_pairs, levels=ds.levels,
                        extra_joint_edges=js.extra_edges)
    ckpt = os.path.join(root, "reference", "pw3d_final.pth.tar")
    ref = reference_checkpoint(ckpt, js.joint_num, pyr, seed=17)
    want, _ = eval_loop(ds, RefEval(ref, pyr.vertex_slot, ds.target_regressor()), "cuda")
    del ref
    torch.cuda.empty_cache()
    out = os.path.join(root, "experiment_reference")
    cfg_path = engine_cfg(os.path.join(root, "test_reference.json"), root, out,
                          TEST={"deploy": True})
    reset_launches()
    with EngineProbe() as probe:
        got = cli_test.main(["--cfg", cfg_path, "--weights", ckpt, "--device", "cuda"])
    _check_steps("phase 16 (a) cli.test forwards", probe.eval, DATA_DEPLOY_LAUNCHES,
                 len(probe.eval))
    if not probe.eval:
        raise SystemExit("phase 16 (a): cli.test ran no forward")
    keys = ("joint_err", "mesh_err", "mpjpe", "pa_mpjpe", "mpvpe")
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in keys}
    log(f"phase 16 (a): cli.test on a reference pw3d_final.pth.tar (19 joints): "
        f"{ {k: round(got[k], 4) for k in keys} }, RefCascade's evaluation "
        f"{ {k: round(want[k], 4) for k in keys} }, relative difference "
        f"{ {k: f'{v:.2e}' for k, v in rel.items()} } (tolerance {EVAL_TOL}); eval-step ms "
        f"{[round(t, 3) for t in probe.eval_ms]}; launches per forward {probe.eval[0]} ({card})")
    if not all(v <= EVAL_TOL for v in rel.values()):
        raise SystemExit(f"phase 16 (a): cli.test disagrees with RefCascade: {rel}")
    report["cli_test"] = {"result": got, "reference": want, "rel_diff": rel,
                          "eval_ms": probe.eval_ms, "launches_per_forward": probe.eval[0]}
    return report


def read_jax_fixture(path: str, device: str = "cuda") -> dict:
    """Phase 16 (b)'s inputs: the fixture's config and arrays, its pyramid
    packed by the port (uv_sphere, the JAX package's packing), the .ckpt's
    payload on `device` (load_checkpoint, timed)."""
    import numpy as np
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    from pose2mesh_release_tpu_torch.core.checkpoint import load_checkpoint
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    arrays = dict(np.load(os.path.join(path, "fixture.npz")))
    c = json.loads(str(arrays.pop("config")))
    _, faces = uv_sphere(c["num_vertices"])
    pyr = build_pyramid(faces, joint_num=c["joint_num"],
                        skeleton=[tuple(e) for e in c["skeleton"]], levels=c["levels"])
    art = pack_pyramid(pyr, faces, dense_threshold=c["dense_threshold"], device=device)
    load_s = []
    for _ in range(2):  # the first load in a process includes torch.optim's one-time set-up
        t0 = time.perf_counter()
        payload = load_checkpoint(os.path.join(path, "checkpoint1.ckpt"), device=device)
        load_s.append(time.perf_counter() - t0)
    return {"config": c, "arrays": arrays, "art": art, "payload": payload, "load_s": load_s}


def _fixture_model(fx, device, dtype, deploy: bool):
    import torch
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    c = fx["config"]
    return Pose2Mesh(c["joint_num"], fx["art"].mesh_ops[-1].num_vertices,
                     posenet_hidden=c["posenet_hidden"],
                     blocks=tuple(tuple(b) for b in c["blocks"]), dtype=dtype,
                     inference_fused=deploy, dropout=0.0, device=device,
                     generator=torch.Generator().manual_seed(0))


def jax_fixture_forward(fx, dtype, device: str = "cuda") -> dict:
    """The fixture .ckpt's deploy forward (BatchNorm folded) in `dtype`
    against the JAX eval outputs: relative L2 per output."""
    import torch
    from pose2mesh_release_tpu_torch.core.train import make_eval_step
    from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
    a = fx["arrays"]
    model = _fixture_model(fx, device, dtype, deploy=True)
    model.load_state_dict(fold_bn_variables(fx["payload"]["model_state_dict"]))
    out = make_eval_step(model, a["jreg"], device=device)(
        fx["art"].to(device, dtype), torch.from_numpy(a["eval/pose2d"]).to(device))
    return {k: rel_l2(t.cpu(), torch.from_numpy(a[f"eval/{k}"]))
            for k, t in zip(("mesh_mm", "reg_pose", "pose3d"), out)}


def hold_step(got: dict, want: dict, before: dict, lr: float, cancelling: set,
              rtol: float, atol: float, step_rel_l2: float) -> list:
    """A state dict after a step (`got`) against another's (`want`), both
    from `before`: every entry within (rtol, atol) and its step (the change
    from `before`) within step_rel_l2 relative L2 of the other's step, except
    the `cancelling` biases (exact gradient zero), which each side must have
    moved by at most RMS_BOUND learning rates (RMSprop and Adam turn a
    gradient of rounding into steps up to that size; so do they for single
    elements whose gradient is mostly rounding, which atol covers).
    Returns the failures."""
    import torch
    bad = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].detach().double().cpu()
        w, b = torch.as_tensor(w).double(), torch.as_tensor(before[k]).double().cpu()
        if k in cancelling:
            moved = max(float((g - b).abs().max()), float((w - b).abs().max()))
            if moved > RMS_BOUND * lr * (1 + 1e-3):
                bad.append((k, "moved", moved))
            continue
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            bad.append((k, "value", float((g - w).abs().max())))
        step_err = float(((g - b) - (w - b)).norm() / (w - b).norm().clamp_min(1e-30))
        if step_err > step_rel_l2:
            bad.append((k, "step", step_err))
    return bad


def jax_fixture_step(fx, device: str = "cuda") -> dict:
    """The fixture .ckpt resumed as Trainer._resume does (weights, the
    optimizer state through optim_state_from_flax, the step) and one float32
    RMSprop step on the fixture's batch, against the JAX package's second
    step: losses (relative), every parameter and running statistic
    (`hold_step`)."""
    import numpy as np
    import torch
    from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
    from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
    from pose2mesh_release_tpu_torch.parity.from_jax import state_dict_from_flax
    a, c, payload = fx["arrays"], fx["config"], fx["payload"]
    model = _fixture_model(fx, device, torch.float32, deploy=False)
    model.load_state_dict(payload["model_state_dict"])
    opt = make_preconditioner("rmsprop", model.parameters())
    opt.load_state_dict(payload["optim_state_dict"])
    state = TrainState(model, opt, payload["step"])
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, opt, a["jreg"], device=device)
    batch = {k[len("batch/"):]: torch.from_numpy(v).to(device)
             for k, v in a.items() if k.startswith("batch/")}
    art = fx["art"].to(device, torch.float32)
    state, losses = step(state, art, batch, c["lr"], c["use_edge_loss"], None)
    loss_rel = {k: abs(float(v) - float(a[f"step2/loss/{k}"])) / abs(float(a[f"step2/loss/{k}"]))
                for k, v in losses.items()}

    def tree(prefix):
        out = {}
        for key, v in a.items():
            if key.startswith(prefix):
                node = out
                *path, leaf = key[len(prefix):].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = np.asarray(v)
        return out

    want = state_dict_from_flax({"params": tree("step2/params/"),
                                 "batch_stats": tree("step2/batch_stats/")})
    cancelling = cancelling_biases(model)
    got = model.state_dict()
    bad = hold_step(got, want, before, c["lr"], cancelling, **FIXTURE_STEP_TOLS)
    held = [k for k in want if k not in cancelling and not k.endswith("num_batches_tracked")]
    step_err = {k: float(((got[k].double().cpu() - want[k].double()).norm())
                         / (want[k].double() - before[k].double()).norm().clamp_min(1e-30))
                for k in held}
    worst = max(step_err, key=step_err.get)
    return {"ok": not bad and max(loss_rel.values()) <= 1e-4 and state.step == 2,
            "bad": bad, "loss_rel": loss_rel, "step": state.step,
            "worst_step_rel_l2": (worst, step_err[worst]), "cancelling": sorted(cancelling)}


def jax_ckpt_layer(card) -> dict:
    """Phase 16 (b): the committed JAX .ckpt fixture on the card: the deploy
    forward in float32 (F32_FORWARD_TOL) and bf16 (FORWARD_TOL) against the
    JAX eval outputs, each with exactly FIXTURE_DEPLOY_LAUNCHES; the resumed
    float32 step with exactly FIXTURE_STEP_LAUNCHES against the JAX step."""
    import torch
    fx = read_jax_fixture(JAX_FIXTURE, "cuda")
    report = {"load_s": fx["load_s"], "forward": {}}
    for dtype, tol in ((torch.float32, F32_FORWARD_TOL), (torch.bfloat16, FORWARD_TOL)):
        name = str(dtype).split(".")[-1]
        reset_launches()
        errs = jax_fixture_forward(fx, dtype)
        launches = read_launches()
        log(f"phase 16 (b): JAX checkpoint1.ckpt, {name} deploy forward vs the JAX eval "
            f"outputs: { {k: f'{v:.2e}' for k, v in errs.items()} } (tolerance {tol}); "
            f"band-kernel launches {launches}")
        if launches != expect(**FIXTURE_DEPLOY_LAUNCHES):
            raise SystemExit(f"phase 16 (b) {name} forward: launches {launches}")
        if not all(e <= tol for e in errs.values()):
            raise SystemExit(f"phase 16 (b): the {name} forward disagrees with JAX: {errs}")
        report["forward"][name] = {"rel_l2": errs, "launches": launches}
    reset_launches()
    res = jax_fixture_step(fx)
    launches = read_launches()
    log(f"phase 16 (b): resumed float32 RMSprop step (step {res['step']}) vs the JAX step: "
        f"loss rel { {k: f'{v:.1e}' for k, v in res['loss_rel'].items()} }, worst step "
        f"rel_l2 {res['worst_step_rel_l2'][0]} {res['worst_step_rel_l2'][1]:.2e} (limits "
        f"{FIXTURE_STEP_TOLS}), {len(res['cancelling'])} cancelling biases within "
        f"{RMS_BOUND:.0f} learning rates; failures {res['bad']}; "
        f"band-kernel launches {launches}; .ckpt loaded in {fx['load_s'][0]:.3f} s, then "
        f"{fx['load_s'][1]:.4f} s ({card})")
    if launches != expect(**FIXTURE_STEP_LAUNCHES):
        raise SystemExit(f"phase 16 (b) step: launches {launches}")
    if not res["ok"]:
        raise SystemExit(f"phase 16 (b): the resumed step disagrees with JAX: {res}")
    report["step"] = {k: res[k] for k in ("loss_rel", "worst_step_rel_l2", "step")}
    report["step"]["launches"] = launches
    return report


def write_pw3d_sequence(root: str) -> str:
    """The synthetic 3DPW sequence pickle of tests/test_data.py's converter
    test (3 frames, 2 people, camera 4 m away) under
    root/sequenceFiles/test; returns its path."""
    import pickle
    import numpy as np
    rng = np.random.default_rng(9)
    frames, people = 3, 2
    seq_dir = os.path.join(root, "sequenceFiles", "test")
    os.makedirs(seq_dir, exist_ok=True)
    ext = np.tile(np.eye(4, dtype=np.float32), (frames, 1, 1))
    ext[:, 2, 3] = 4.0
    data = {
        "sequence": "synth_seq_00",
        "betas": [rng.standard_normal(300).astype(np.float32) * 0.2 for _ in range(people)],
        "poses": [rng.standard_normal((frames, 72)).astype(np.float32) * 0.1
                  for _ in range(people)],
        "trans": [rng.standard_normal((frames, 3)).astype(np.float32) * 0.1
                  for _ in range(people)],
        "jointPositions": [rng.standard_normal((frames, 24 * 3)).astype(np.float32) * 0.3
                           for _ in range(people)],
        "genders": ["m", "f"],
        "campose_valid": np.ones((people, frames)),
        "cam_poses": ext,
        "cam_intrinsics": np.array([[1000.0, 0, 500], [0, 1000.0, 500], [0, 0, 1]],
                                   np.float32),
        "poses2d": rng.random((people, frames, 3, 18)).astype(np.float32),
    }
    path = os.path.join(seq_dir, "synth_seq_00.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def json_diff(a, b, tol: float = CONVERTER_TOL, path: str = "") -> list:
    """Where two JSON trees differ: keys, lengths, integers and strings
    exactly, floats beyond tol (relative above 1)."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or list(a) != list(b):
            return [path]
        return [d for k in b for d in json_diff(a[k], b[k], tol, f"{path}/{k}")]
    if isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in json_diff(x, y, tol, f"{path}[{i}]")]
    if isinstance(b, float) and isinstance(a, float):
        return [] if abs(a - b) <= tol * max(1.0, abs(b)) else [f"{path}: {a} vs {b}"]
    return [] if type(a) is type(b) and a == b else [f"{path}: {a!r} vs {b!r}"]


def converter_layer(root: str, card, device: str = "cuda") -> dict:
    """Phase 16 (c): the 3DPW converter on `device` and on the CPU over
    write_pw3d_sequence's pickle: the two JSON files agree (json_diff), and
    the port's PW3D loads the card's."""
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.pw3d import PW3D
    from pose2mesh_release_tpu_torch.data.tools.pw3d_to_coco import convert_split
    base = os.path.join(root, "pw3d_converter")
    write_pw3d_sequence(base)
    out, secs = {}, {}
    for dev in (device, "cpu"):
        path = os.path.join(base, f"3DPW_{dev.replace(':', '')}.json")
        t0 = time.time()
        stats = convert_split(base, "test", path, device=dev)
        secs[dev] = time.time() - t0
        with open(path) as f:
            out[dev] = json.load(f)
    diff = json_diff(out[device], out["cpu"])
    os.replace(os.path.join(base, f"3DPW_{device.replace(':', '')}.json"),
               os.path.join(base, "3DPW_latest_test.json"))
    ds = PW3D("test", data_dir=base, mesh_model=SMPL(), build_graph=False, device=device)
    inputs, _, _ = ds[0]
    log(f"phase 16 (c): 3DPW converter on {device} in {secs[device]:.2f} s, CPU "
        f"{secs['cpu']:.2f} s: {stats}; JSON differences beyond {CONVERTER_TOL}: "
        f"{diff[:5]}; PW3D loads {len(ds)} records, pose2d {tuple(inputs['pose2d'].shape)} "
        f"({card})")
    if diff or len(ds) != stats["annotations"] or stats["annotations"] == 0 \
            or tuple(inputs["pose2d"].shape) != (19, 2):
        raise SystemExit(f"phase 16 (c): converter check failed: {diff[:5]}, {len(ds)} "
                         f"records, {stats}")
    return {"stats": stats, "seconds": secs, "records": len(ds)}


def roofline_layer(art, rows, path_rows) -> dict:
    """Phase 16 (d): utils.profiling's rooflines for the SMPL artifact:
    pyramid_roofline(art, BATCH, 128) and, per band level, spmm_roofline's
    and sparse_conv_roofline's ideal_us beside phase 2's measured K4 and
    group-conv ms at that level's first group conv (and the bound_ms of
    those rows, which counts the nonzeros and the real rows)."""
    from pose2mesh_release_tpu_torch.utils.profiling import (
        pyramid_roofline, sparse_conv_roofline, spmm_roofline,
    )
    by_tag = {r["tag"]: r for r in list(rows) + list(path_rows)}
    pyramid = pyramid_roofline(art, BATCH, 128)
    log(f"phase 16 (d): pyramid_roofline(art, {BATCH}, 128): "
        f"{ {k: round(v['ideal_us'], 2) for k, v in pyramid.items()} } us")
    levels = []
    for i, (V, name, fin, fout, _) in enumerate(MAIN_PATH_CONVS):
        if name != "fused_cheby_conv" or any(l["V"] == V for l in levels):
            continue
        op = next(o for o in art.mesh_ops if o.num_vertices == V)
        hop, conv = by_tag[f"hop{i}"], by_tag[f"main{i}"]
        lvl = {"V": V, "fin": fin, "fout": fout,
               "spmm_ideal_us": spmm_roofline(op, BATCH, fin).ideal_us,
               "sparse_conv_ideal_us": sparse_conv_roofline(op, BATCH, fin, fout).ideal_us,
               "k4_ms": hop["ms"], "k4_bound_ms": hop["bound_ms"],
               "group_ms": conv["ms"], "group_bound_ms": conv["bound_ms"]}
        levels.append(lvl)
        log(f"  V={V} {fin}->{fout}: spmm_roofline {lvl['spmm_ideal_us']:.2f} us, K4 "
            f"{1e3 * lvl['k4_ms']:.2f} us (bound {1e3 * lvl['k4_bound_ms']:.2f}); "
            f"sparse_conv_roofline {lvl['sparse_conv_ideal_us']:.2f} us, group conv "
            f"{1e3 * lvl['group_ms']:.2f} us (bound {1e3 * lvl['group_bound_ms']:.2f})")
    return {"pyramid": pyramid, "levels": levels}


def port_complete_layer(root: str, card, art, rows, path_rows) -> dict:
    """Phase 16: (a) the reference runbook, (b) the JAX .ckpt, (c) the 3DPW
    converter, (d) the rooflines; any failed check exits non-zero."""
    import torch
    t0 = time.time()
    torch.cuda.empty_cache()
    report = {"reference": ref_runbook(root, card), "jax_ckpt": jax_ckpt_layer(card),
              "converter": converter_layer(root, card),
              "rooflines": roofline_layer(art, rows, path_rows)}
    report["wall_s"] = time.time() - t0
    log(f"phase 16: {report['wall_s']:.1f} s")
    return report


def kernel_table(rows, launches_of, main_tags, suffix="") -> list:
    """The {"kernels": ...} rows of SOURCES' kernels (name + suffix): per
    kernel its launches on its path, ms, plain ms, library ms and bound
    summed over the shapes of one pass of that path (the rows whose tags
    start with main_tags)."""
    kernels = []
    for name in SOURCES:
        every = [r for r in rows if r["name"] == name]
        if not every:
            continue
        main = [r for r in every if r["tag"].startswith(main_tags)]
        lib = [r["library_ms"] for r in main]
        kernels.append({
            "name": name + suffix, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches_of[name],
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": sum(r["ms"] for r in main),
            "plain_ms": sum(r["plain_ms"] for r in main),
            "bound_ms": sum(r["bound_ms"] for r in main),
            "bound_by": ("bytes" if sum(r["bound_by"] == "bytes" for r in main)
                         * 2 >= len(main) else "operations"),
            "library_ms": None if None in lib else sum(lib),
            "status": "ok",
            "shapes_per_pass": len(main),
        })
    return kernels


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
    report["ptxas"] = []
    for stem, text in _build.build_log.items():
        fn = ""
        for line in text.splitlines():
            props = re.search(r"Function properties for (\S+)", line)
            if props:
                fn = kernel_label(props.group(1))
            elif "registers" in line or "spill" in line or "error" in line:
                report["ptxas"].append(f"ptxas {stem} {fn}: {line.strip()}")
                log(f"  {report['ptxas'][-1]}")

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
    op2_64 = restrip(by_v[3475], 64)
    log(f"phase 2: the hop, strip and window kernels; strip widths "
        f"{[(op.num_vertices, tuple(op.strip_val.shape)) for op in art.mesh_ops[:4]]}, "
        f"strip_h 64 at 3475: {tuple(op2_64.strip_val.shape)}")
    occ = [subtile_occupancy(op) for op in art.mesh_ops if op.kind == "band"]
    occ.append(subtile_occupancy(op2))
    report["hop_subtiles"] = occ
    for o in occ:
        log(f"  hop engine sub-tiles at V={o['V']} band_k={o['band_k']}: "
            f"{o['occupancy']:.4f} nonzero, per 16-row group mean {o['per_group_mean']:.2f} "
            f"max {o['per_group_max']}, share over the register slots {o['over_cap']:.4f}")
    path_rows = [check_hop(by_v[V], fin, gen, f"hop{i}")
                 for i, (V, _, fin, _, _) in enumerate(MAIN_PATH_CONVS)]
    path_rows += [check_strip(by_v[V], fin, fout, ep, gen, f"strip{i}")
                  for i, (V, _, fin, fout, ep) in enumerate(MAIN_PATH_CONVS)]
    path_rows += [check_strip(op2_64, 128, 128, "skip_add", gen, "h64_strip"),
                  check_strip(op2, 128, 128, "skip_proj", gen, "k2_strip0"),
                  check_strip(op2, 256, 128, "relu", gen, "k2_strip1"),
                  check_strip(op2, 256, 128, "skip_proj", gen, "k2_strip2")]
    path_rows += [check_window(by_v[V], fin, fout, ep, gen, f"window{i}")
                  for i, (V, _, fin, fout, ep) in enumerate(MAIN_PATH_CONVS)]
    path_rows += [check_window(op2, fin, fout, ep, gen, f"k2_window{i}")
                  for i, (_, fin, fout, ep) in enumerate(K2_CONVS)]
    path_rows.append(check_hop(op2, 128, gen, "k2_hop"))
    report["path_convs"] = path_rows
    bad = [r["tag"] for r in path_rows if not r["ok"]]
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
    want = expect(fused_cheby_conv=8 * REQUESTS, fused_cheby_conv_commuted=2 * REQUESTS)
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
    path_launches = {}
    for path in PATHS:
        report[f"forward_{path}"] = drive_path(path, deploy, batches, outs[0], card)
        path_launches.update({PATHS[path][1]: report[f"forward_{path}"]["launches"]})

    # -- phase 4: the training kernels at the train step's shapes ---------
    log(f"phase 4: K1/K2 vs plain (f32 from the same bf16 inputs), batch {BATCH}, "
        f"tolerance rel_l2 <= {KERNEL_TOL}")
    train_rows = []
    for i, (V, fin, fout, fold, stats) in enumerate(TRAIN_CONVS):
        train_rows += check_train_conv(by_v[V], fin, fout, fold, stats, gen, f"train{i}")
    train_rows += check_train_conv(op2, *K2_TRAIN_CONV, gen, "k2_train")
    V, fin, fout = KEEP_BASIS_CONV
    keep_row = check_keep_basis(by_v[V], fin, fout, gen, "keep_basis")
    train_rows.append(keep_row)
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
    fresh = step_check("fresh state", *train_step_vs_plain(setup, state))
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
    want = expect(fused_cheby_conv_train=10 * TRAIN_STEPS,
                  fused_cheby_conv_bwd=10 * TRAIN_STEPS)
    if train_launches != want:
        raise SystemExit(f"launch counts {train_launches} != {want}")
    if not all(math.isfinite(v) for l in step_losses for v in l.values()):
        raise SystemExit(f"non-finite loss: {step_losses}")
    if not step_losses[-1]["total"] < step_losses[0]["total"]:
        raise SystemExit("the total loss did not fall over the steps")
    after = step_check(f"after {TRAIN_STEPS + 1} steps", *train_step_vs_plain(setup, state))
    log(f"  step vs plain-version step, worst gradient rel_l2: fresh state "
        f"{fresh['worst'][0][1]:.3e} ({fresh['worst'][0][0]}), after {TRAIN_STEPS + 1} "
        f"steps {after['worst'][0][1]:.3e} ({after['worst'][0][0]})")
    report["train"] = {"card": card, "batch": BATCH, "lr": LR, "ms_per_step": step_ms,
                       "losses": step_losses, "launches": train_launches,
                       "plain_step_ms": after["plain_step_ms"],
                       "loss_rel_err": after["loss_rel_err"],
                       "grad_rel_l2": after["grad_rel_l2"],
                       "zero_grad_biases": after["zero_grad_biases"],
                       "fresh_state": fresh}

    # -- phases 6-10: the MANO hand ------------------------------------------
    smpl_art = setup.art_compute
    del setup, state
    torch.cuda.empty_cache()
    mano_deploy, mano_rows = mano_kernels(gen, card)
    report["mano_convs"] = mano_rows
    report["mano_forward"] = mano_forward(mano_deploy, card)
    del mano_deploy
    mano_setup, report["mano_train"] = mano_train(card)
    log(f"phase 9: the face corners' backward, batch {BATCH}, float32 ({card})")
    report["face_backward"] = {
        "smpl": face_backward("SMPL", smpl_art, gen),
        "mano": face_backward("MANO", mano_setup.art_compute, gen)}
    del mano_setup, smpl_art
    from pose2mesh_release_tpu_torch.body.mano import MANO
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    log(f"phase 10: GT synthesis (posed_mesh_rotated), batch {BATCH}, float32 ({card})")
    report["gt_synthesis"] = {"mano": gt_synthesis("MANO", MANO().params, gen),
                              "smpl": gt_synthesis("SMPL", SMPL().layer(), gen)}
    report["mano_kernels"] = mano_table(mano_rows)

    # -- phase 11: the kernel table ----------------------------------------
    # per kernel: its launches on its path; ms, plain ms, library ms and
    # bound summed over the shapes of one pass of that path (one forward,
    # one train step; K1b: its one training shape)
    launches_of = {**{n: launches[n] for n in DEPLOY_KERNELS},
                   **{n: train_launches[n] for n in TRAIN_KERNELS},
                   **{n: c[n] for n, c in path_launches.items()},
                   "fused_cheby_conv_train(keep_basis)": keep_row["launches"]}
    main_tags = ("main", "train", "hop", "strip", "window", "keep_basis")
    kernels = kernel_table(rows + path_rows + train_rows, launches_of, main_tags)
    report["kernels"] = kernels

    # -- phases 12-13: the data layer, then the engine and the entry points,
    # over stand-in annotation files in a temporary directory
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        write_stand_in_data(root)
        log(f"phase 12: stand-in annotation files written in {time.time() - t0:.2f} s")
        data = report["data"] = data_layer(root, card, report["train"]["ms_per_step"])
        eng = report["engine"] = engine_layer(root, card)
        # -- phase 14: the float32 instances and paths --------------------------
        f32 = report["f32"] = f32_layer(root, card)
        # -- phase 15: multi-device ---------------------------------------------
        multi = report["multi_device"] = mesh_layer(
            root, card, f32["engine"]["test"]["runs"]["deploy"]["result"])
        # -- phase 16: the JAX package's last modules ----------------------------
        done = report["port_complete"] = port_complete_layer(root, card, art, rows, path_rows)
    f32_launches = {"fused_cheby_conv": f32["forward"]["launches"]["fused_cheby_conv"],
                    "fused_cheby_conv_commuted":
                        f32["forward"]["launches"]["fused_cheby_conv_commuted"],
                    **{n: f32["train"]["launches"][n] for n in TRAIN_KERNELS},
                    **{PATHS[p][1]: f32["forward"]["paths"][p]["launches"][PATHS[p][1]]
                       for p in PATHS},
                    "fused_cheby_conv_train(keep_basis)": f32["train_convs"][-1]["launches"]}
    kernels += kernel_table(f32["convs"] + f32["train_convs"], f32_launches,
                            ("f32main", "f32train", "f32keep_basis", "f32hop", "f32strip",
                             "f32window"), "[f32]")
    report["kernels"] = kernels
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"mano_kernels": report["mano_kernels"], "card": card}), flush=True)
    print(json.dumps({"data": {
        "card": card, "build_s": data["build_s"], "valid_share": data["valid_share"],
        "loader_ms_per_batch": {"per_sample": data["loader_per_sample_ms"],
                                "per_sample_1_thread": data["loader_per_sample_1_thread_ms"],
                                "get_batch": data["loader_get_batch_ms"]},
        "h2d_ms": min(data["h2d_ms"]), "h2d_bytes": data["h2d_bytes"],
        "step_ms": data["step_ms"], "step_wait_ms": data["step_wait_ms"],
        "resident_step_ms": data["resident_step_ms"],
        "samples_per_s": data["samples_per_s"], "train_launches": data["launches"],
        "mano_step_launches": data["mano_launches"],
        "eval_ms_per_batch": data["eval"]["ms_per_batch"],
        "eval_launches": data["eval"]["launches"], "eval_card": data["eval"]["card"],
        "eval_rel_diff": data["eval"]["rel_diff"],
        "card_vs_cpu_batch_rel_l2": data["card_vs_cpu"]}}), flush=True)
    tr, te = eng["train"], eng["test"]["runs"]
    print(json.dumps({"engine": {
        "card": card, "fit_ms_per_step": tr["ms_per_step"], "fit_epoch_s": tr["epoch_s"],
        "fit_samples_per_s": tr["samples_per_s"], "fit_losses": tr["losses"],
        "launches_per_step": tr["launches_per_step"],
        "launches_per_in_epoch_eval_forward": tr["launches_per_eval_forward"],
        "resume_epoch_s": tr["resume_epoch_s"],
        "test_deploy_ms_per_batch": te["deploy"]["eval_ms"],
        "test_deploy_launches_per_forward": te["deploy"]["launches_per_forward"],
        "test_training_form_ms_per_batch": te["training form"]["eval_ms"],
        "deploy_vs_training_form_rel": eng["test"]["rel_diff"],
        "lift_train_s": eng["lift"]["train_s"], "lift_test_s": eng["lift"]["test_s"],
        "demo": {k: {"s_per_person": v["s_per_person"], "forward_s": v["forward_s"],
                     "camera_ms": v["camera_ms"], "camera_vs_cpu": v["camera_vs_cpu"],
                     "launches": v["launches"]}
                 for k, v in eng["demo"].items() if k != "camera_well_posed"},
        "camera_well_posed_vs_cpu": eng["demo"]["camera_well_posed"]}}),
        flush=True)
    f32_eng = f32["engine"]
    errs = ("mesh_vs_plain", "reg_pose_vs_plain", "mesh_vs_group", "reg_pose_vs_group")
    print(json.dumps({"f32": {
        "card": card, "forward_ms_per_batch": f32["forward"]["ms_per_batch"],
        "forward_launches": f32["forward"]["launches"],
        "forward_vs_plain": {k: f32["forward"][k] for k in ("mesh_vs_plain",
                                                             "reg_pose_vs_plain")},
        "paths": {model: {p: {"ms_per_batch": r["ms_per_batch"], "launches": r["launches"],
                              "engine_launches_per_forward": r["engine_launches_per_forward"],
                              "plain_forward_ms": r["plain_forward_ms"],
                              **{k: r[k] for k in errs}}
                          for p, r in f32["forward"][key].items()}
                  for model, key in (("smpl", "paths"), ("mano", "mano_paths"))},
        "mano_kernels": f32["mano_kernels"],
        "unfused_train": {k: v for k, v in f32["unfused_train"].items() if k != "fresh_state"},
        "unfused_step_loss_rel_err": f32["unfused_train"]["fresh_state"]["loss_rel_err"],
        "unfused_step_worst_grad_rel_l2": f32["unfused_train"]["fresh_state"]["worst"][0],
        "test_paths": {p: {"eval_ms": r["eval_ms"], "launches_per_forward":
                           r["launches_per_forward"], "rel_diff": r["rel_diff"]}
                       for p, r in f32_eng["test"]["runs"]["paths"].items()},
        "step_ms": f32["train"]["ms_per_step"], "step_launches": f32["train"]["launches"],
        "step_loss_rel_err": f32["train"]["fresh_state"]["loss_rel_err"],
        "step_worst_grad_rel_l2": f32["train"]["fresh_state"]["worst"][0],
        "fit_ms_per_step": f32_eng["train"]["ms_per_step"],
        "fit_launches_per_step": f32_eng["train"]["launches_per_step"],
        "test_deploy_ms_per_batch": f32_eng["test"]["runs"]["deploy"]["eval_ms"],
        "test_deploy_launches_per_forward":
            f32_eng["test"]["runs"]["deploy"]["launches_per_forward"],
        "deploy_vs_training_form_rel": f32_eng["test"]["rel_diff"],
        "demo": f32_eng["demo"]}}), flush=True)
    print(json.dumps({"multi_device": {
        "card": card, "label": multi["label"], "wall_s": multi["wall_s"],
        "halo_worst": {f"{n} ranks {dt}": max(max(x["err"], x["vjp_err"]) for x in multi["halo"]
                                              if x["ranks"] == n and x["dtype"] == dt)
                       for n in MESH_SHAPES for dt in HALO_TOLS},
        "halo_ms_6890_bf16": {n: [x["ms"] for x in multi["halo"] if x["ranks"] == n
                                  and x["level"] == "6890" and x["dtype"] == "bfloat16"]
                              for n in MESH_SHAPES},
        "steps": {k: {f: v[f] for f in ("ms_per_step", "loss_rel_err",
                                        "worst_grad_rel_l2", "largest_grad_rel_l2",
                                        "whole_grad_rel_l2", "whole_scale_rel_l2",
                                        "grad_sync_ms",
                                        "worst_param_rel_l2", "limits",
                                        "launches_per_step", "band_sized_gathers",
                                        "allowed_gathers")}
                  | {"census": v["census"]["by_kind"]}
                  for k, v in multi["steps"].items()},
        "tester": multi["tester"], "nccl": multi["nccl"]}}), flush=True)
    ref, jck = done["reference"], done["jax_ckpt"]
    print(json.dumps({"port_complete": {
        "card": card, "wall_s": done["wall_s"],
        "reference_forward": ref["forward"], "reference_ms_per_batch": ref["ref_ms_per_batch"],
        "reference_pth_load_s": ref["load_s"],
        "reference_cli_test": {k: ref["cli_test"][k] for k in ("result", "rel_diff", "eval_ms",
                                                               "launches_per_forward")},
        "jax_ckpt": jck, "converter": done["converter"],
        "rooflines": done["rooflines"]["levels"]}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
