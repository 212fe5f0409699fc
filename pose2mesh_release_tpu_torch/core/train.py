"""Training and evaluation steps of the cascade (`Trainer`'s and `Tester`'s
per-batch compute).

The train step is one forward in training mode, the joint regressor, the
five losses, one backward and one optimizer step.  As in the JAX package the
learning rate and the edge-loss gate are arguments of every step, and the
dropout noise comes from the generator the caller passes.  BatchNorm
running statistics move inside the forward (momentum 0.1, biased batch
variance, as flax stores them).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.artifact import PyramidArtifact
from ..models.meshnet import extract_mesh
from .losses import coord_l1, pose2mesh_loss
from .optim import set_lr

__all__ = ["TrainState", "make_train_step", "make_multi_train_step",
           "make_eval_step", "make_posenet_steps"]

Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainState:
    """The model (parameters and BatchNorm statistics, updated in place), its
    optimizer (and the optimizer's state) and the number of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _model_device(model: torch.nn.Module, device) -> torch.device:
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model is on {p.device}, step on {dev}")
    return p.device


def _check_state(state: TrainState, model, optimizer):
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state holds another model or optimizer than the "
                         "step was built for")


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    j_regressor: np.ndarray | torch.Tensor, *,
                    normal_weight: float = 0.1, edge_weight: float = 20.0,
                    joint_weight: float = 1e-3,
                    device: str | torch.device | None = "cuda") -> Callable:
    """The cascade's train step: `step(state, art, batch, lr, use_edge_loss,
    generator) -> (state, losses)`.  `model` (a `Pose2Mesh` with
    inference_fused=False) must already live on `device`; j_regressor is the
    (J_target, V) dense regressor of the mesh-to-joint loss."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    def train_step(state: TrainState, art: PyramidArtifact, batch: Batch, lr: float,
                   use_edge_loss: bool | torch.Tensor,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _check_state(state, model, optimizer)
        if batch["mesh"].dtype != torch.float32:
            # half-precision targets: upcast once so the face losses run in f32
            batch = dict(batch, mesh=batch["mesh"].float())
        optimizer.zero_grad(set_to_none=True)
        mesh_dev, pose3d = model(art, batch["pose2d"], train=True, generator=generator)
        mesh = extract_mesh(art, mesh_dev)  # (B, V, 3), meters
        reg_pose = torch.einsum("jv,bvc->bjc", jreg, mesh * 1000.0)
        losses = pose2mesh_loss(
            mesh, pose3d, reg_pose, batch, art.faces, normal_weight=normal_weight,
            edge_weight=edge_weight, joint_weight=joint_weight,
            use_edge_loss=use_edge_loss)
        losses["total"].backward()
        set_lr(optimizer, lr)
        optimizer.step()
        return (dataclasses.replace(state, step=state.step + 1),
                {k: v.detach() for k, v in losses.items()})

    return train_step


def make_multi_train_step(train_step: Callable) -> Callable:
    """k train steps over a stacked batch (leaves (k, B, ...)), one after the
    other; returns the state and the losses stacked (k,) per key."""

    def multi_step(state, art, batches: Batch, lr, use_edge_loss, generator):
        k = next(iter(batches.values())).shape[0]
        history = []
        for i in range(k):
            state, losses = train_step(state, art, {n: v[i] for n, v in batches.items()},
                                       lr, use_edge_loss, generator)
            history.append(losses)
        return state, {n: torch.stack([h[n] for h in history]) for n in history[0]}

    return multi_step


def make_eval_step(model: torch.nn.Module, j_regressor: np.ndarray | torch.Tensor,
                   *, device: str | torch.device | None = "cuda") -> Callable:
    """Eval forward returning (pred_mesh mm (B, V, 3), pred_reg_pose mm
    (B, J, 3), lifted pose mm (B, J, 3)), for the deploy form or the
    training form at eval.  `model` must already live on `device`;
    j_regressor is the (J_target, V) dense regressor."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    @torch.inference_mode()
    def eval_step(art: PyramidArtifact, pose2d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mesh_dev, pose3d = model(art, pose2d)
        mesh_mm = extract_mesh(art, mesh_dev) * 1000.0
        reg_pose = torch.einsum("jv,bvc->bjc", jreg, mesh_mm)
        return mesh_mm, reg_pose, pose3d

    return eval_step


def make_posenet_steps(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """Train and eval steps of the standalone PoseNet lifter: masked L1 on the
    3D joints.  `train_step(state, batch, lr, generator) -> (state, loss)`,
    `eval_step(state, pose2d) -> (B, J, 3)`."""

    def train_step(state: TrainState, batch: Batch, lr: float,
                   generator: Optional[torch.Generator]):
        _check_state(state, model, optimizer)
        optimizer.zero_grad(set_to_none=True)
        pred = model(batch["pose2d"], train=True, generator=generator)
        pred = pred.reshape(pred.shape[0], -1, 3)
        loss = coord_l1(pred, batch["pose3d"], batch["pose3d_valid"])
        loss.backward()
        set_lr(optimizer, lr)
        optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), loss.detach()

    @torch.inference_mode()
    def eval_step(state: TrainState, pose2d: torch.Tensor) -> torch.Tensor:
        pred = state.model(pose2d)
        return pred.reshape(pred.shape[0], -1, 3)

    return train_step, eval_step
