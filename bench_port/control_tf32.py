"""The control of a float32 configuration, and its planted fault, for the
calibration of its limits (`calibrate_f32.py`).

Control: the plain reference (`reference.model.RefModel`, float32) with TF32
on for its dense products while it steps, the nearest precision below
float32 that a float32 program on this card could slip into.  TF32 is turned
on around each step and restored after it, so the reference that the
harness then builds for the comparison runs with TF32 off, as always.

Fault: the port at bf16 (the bf16 configuration's system) in the float32
cell's place, the lower precision that a float32 cell exists to tell apart.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from .control import RefServe, RefTrain
from .system import ServeSystem, TrainSystem

__all__ = ["tf32", "Tf32Serve", "Tf32Train", "bf16_serve", "bf16_train"]


@contextlib.contextmanager
def tf32():
    """float32 matrix products in TF32 (cuBLAS and cuDNN) for the block."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    old = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = True
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = old


class Tf32Serve(RefServe):
    def __init__(self, cfg: Dict, mesh, state, device):
        super().__init__(cfg, mesh, state, device, precision="f32")

    def step(self, pose2d: torch.Tensor):
        with tf32():
            return super().step(pose2d)


class Tf32Train(RefTrain):
    def __init__(self, cfg: Dict, mesh, state, device, dropout_seed: int):
        super().__init__(cfg, mesh, state, device, dropout_seed, precision="f32")

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with tf32():
            return super().step(batch)


def bf16_serve(cfg: Dict, *args) -> ServeSystem:
    return ServeSystem(dict(cfg, compute_dtype="bfloat16"), *args)


def bf16_train(cfg: Dict, *args) -> TrainSystem:
    return TrainSystem(dict(cfg, compute_dtype="bfloat16"), *args)
