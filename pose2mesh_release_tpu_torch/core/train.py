"""Training and evaluation steps of the cascade (`Trainer`'s and `Tester`'s
per-batch compute).

The train step is one forward in training mode, the joint regressor, the
five losses, one backward and one optimizer step.  As in the JAX package the
learning rate and the edge-loss gate are arguments of every step, and the
dropout noise comes from the generator the caller passes.  BatchNorm
running statistics move inside the forward (momentum 0.1, biased batch
variance, as flax stores them).

On a mesh (`mesh=`, the model's): a train step takes this data rank's rows
of the global batch (`parallel.sharding.shard_batch`), the mean of each loss
over them, and before the optimizer step averages the gradients over the
data ranks (`parallel.sharding.sync_grads`; the graph-split convs' also
summed over the graph ranks), so every rank takes the single-device step of
the global batch; the losses it returns are the global means.  An eval step
takes the global batch, evaluates this data rank's rows and gathers the
predictions of every data rank.
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
from ..parallel.collectives import all_reduce_sum, gather_rows
from ..parallel.sharding import sync_grads
from ..utils.profiling import span
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


def _global_means(losses: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The per-rank means of equal shards -> the means over the global batch."""
    if mesh is None:
        return {k: v.detach() for k, v in losses.items()}
    vals = all_reduce_sum(torch.stack([v.detach() for v in losses.values()]), mesh,
                          "data", site="losses") / mesh.data
    return dict(zip(losses, vals.unbind(0)))


def _data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of the global batch x, padded with its last row
    to a multiple of the data ranks (the gathered tail is cut again)."""
    per = -(-x.shape[0] // mesh.data)
    pad = per * mesh.data - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def _gather_data(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    return gather_rows(t.contiguous(), mesh, "data", site="predictions")[:n]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    j_regressor: np.ndarray | torch.Tensor, *,
                    normal_weight: float = 0.1, edge_weight: float = 20.0,
                    joint_weight: float = 1e-3,
                    device: str | torch.device | None = "cuda", mesh=None) -> Callable:
    """The cascade's train step: `step(state, art, batch, lr, use_edge_loss,
    generator) -> (state, losses)`.  `model` (a `Pose2Mesh` with
    inference_fused=False) must already live on `device`; j_regressor is the
    (J_target, V) dense regressor of the mesh-to-joint loss.  On `mesh`
    (the model's) art is `shard_artifact`'s and batch this data rank's rows."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    def train_step(state: TrainState, art: PyramidArtifact, batch: Batch, lr: float,
                   use_edge_loss: bool | torch.Tensor,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _check_state(state, model, optimizer)
        with span("p2m.step", kind="train"):
            if batch["mesh"].dtype != torch.float32:
                # half-precision targets: upcast once so the face losses run in f32
                batch = dict(batch, mesh=batch["mesh"].float())
            optimizer.zero_grad(set_to_none=True)
            mesh_dev, pose3d = model(art, batch["pose2d"], train=True, generator=generator)
            with span("p2m.extract_mesh"):
                verts = extract_mesh(art, mesh_dev)  # (B, V, 3), meters
            with span("p2m.regressor"):
                reg_pose = torch.einsum("jv,bvc->bjc", jreg, verts * 1000.0)
            # the face corners' backward: the banded selector product over the
            # artifact's tables, as the JAX step's
            with span("p2m.losses"):
                losses = pose2mesh_loss(
                    verts, pose3d, reg_pose, batch, art.faces, normal_weight=normal_weight,
                    edge_weight=edge_weight, joint_weight=joint_weight,
                    use_edge_loss=use_edge_loss,
                    face_band=(art.face_perm, art.face_sel, art.vertex_gather))
            with span("p2m.backward"):
                losses["total"].backward()
            if mesh is not None:
                with span("p2m.grad_sync"):
                    sync_grads(model.parameters(), mesh,
                               model.pose2mesh.graph_split_parameters(art))
            with span("p2m.optimizer"):
                set_lr(optimizer, lr)
                optimizer.step()
            return (dataclasses.replace(state, step=state.step + 1),
                    _global_means(losses, mesh))

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
                   *, device: str | torch.device | None = "cuda", mesh=None) -> Callable:
    """Eval forward returning (pred_mesh mm (B, V, 3), pred_reg_pose mm
    (B, J, 3), lifted pose mm (B, J, 3)), for the deploy form or the
    training form at eval.  `model` must already live on `device`;
    j_regressor is the (J_target, V) dense regressor.  On `mesh` (the
    model's) pose2d is the global batch and so are the predictions."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    @torch.inference_mode()
    def eval_step(art: PyramidArtifact, pose2d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = pose2d.shape[0]
        with span("p2m.step", kind="eval"):
            if mesh is not None:
                pose2d = _data_rows(pose2d, mesh)
            mesh_dev, pose3d = model(art, pose2d)
            with span("p2m.extract_mesh"):
                mesh_mm = extract_mesh(art, mesh_dev) * 1000.0
            with span("p2m.regressor"):
                reg_pose = torch.einsum("jv,bvc->bjc", jreg, mesh_mm)
            if mesh is None:
                return mesh_mm, reg_pose, pose3d
            return tuple(_gather_data(t, mesh, n) for t in (mesh_mm, reg_pose, pose3d))

    return eval_step


def make_posenet_steps(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       mesh=None):
    """Train and eval steps of the standalone PoseNet lifter: masked L1 on the
    3D joints.  `train_step(state, batch, lr, generator) -> (state, loss)`,
    `eval_step(state, pose2d) -> (B, J, 3)`.  On `mesh` (the model's) as
    `make_train_step` and `make_eval_step` are."""

    def train_step(state: TrainState, batch: Batch, lr: float,
                   generator: Optional[torch.Generator]):
        _check_state(state, model, optimizer)
        with span("p2m.step", kind="train"):
            optimizer.zero_grad(set_to_none=True)
            with span("p2m.posenet"):
                pred = model(batch["pose2d"], train=True, generator=generator)
            pred = pred.reshape(pred.shape[0], -1, 3)
            with span("p2m.losses"):
                loss = coord_l1(pred, batch["pose3d"], batch["pose3d_valid"])
            with span("p2m.backward"):
                loss.backward()
            if mesh is not None:
                with span("p2m.grad_sync"):
                    sync_grads(model.parameters(), mesh)
            with span("p2m.optimizer"):
                set_lr(optimizer, lr)
                optimizer.step()
            return (dataclasses.replace(state, step=state.step + 1),
                    _global_means({"loss": loss}, mesh)["loss"])

    @torch.inference_mode()
    def eval_step(state: TrainState, pose2d: torch.Tensor) -> torch.Tensor:
        n = pose2d.shape[0]
        with span("p2m.step", kind="eval"):
            with span("p2m.posenet"):
                pred = state.model(pose2d if mesh is None else _data_rows(pose2d, mesh))
            pred = pred.reshape(pred.shape[0], -1, 3)
            return pred if mesh is None else _gather_data(pred, mesh, n)

    return train_step, eval_step
