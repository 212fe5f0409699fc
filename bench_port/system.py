"""The system under test: the port's own entries, built as its users build
them.  The only module of the benchmark that imports the port.

serve: the deploy-form eval step that `Tester` runs
    (`core/train.py::make_eval_step` on a `Pose2Mesh` built with
    `inference_fused=True`, BatchNorm folded by `models/fold.py`), as
    `deploy.py::deploy_forward_on` builds it.
train: `core/train.py::make_train_step` with the optimizer of
    `core/optim.py::make_preconditioner`, as `train_setup.py` builds it.

Both pack the pyramid with the port's `graphs/build.py` and
`graphs/artifact.py::pack_pyramid` from the configuration's frozen mesh: the
port's own set-up.  The weights are the benchmark's, loaded with
`load_state_dict`.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict

import numpy as np
import torch

PORT = "pose2mesh_release_tpu_torch"

__all__ = ["PORT", "port_root", "ServeSystem", "TrainSystem", "launch_counters"]


def port_root() -> Path:
    """The directory the port is imported from (the checkout's root)."""
    return Path(importlib.import_module(PORT).__file__).resolve().parents[1]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _artifact(cfg: Dict, mesh: Dict[str, np.ndarray], device: torch.device):
    """The port's packed pyramid of the configuration's frozen mesh, in the
    compute dtype."""
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    js = cfg["joint_set"]
    pyr = build_pyramid(mesh["faces"].astype(np.int64), joint_num=js["joint_num"],
                        skeleton=[tuple(e) for e in js["skeleton"]],
                        flip_pairs=[tuple(e) for e in js["flip_pairs"]],
                        levels=cfg["levels"],
                        extra_joint_edges=[tuple(e) for e in js["extra_edges"]])
    art = pack_pyramid(pyr, mesh["faces"].astype(np.int64),
                       dense_threshold=cfg["dense_threshold"],
                       block_size=cfg["block_size"], device=device)
    return art.to(device, _dtype(cfg["compute_dtype"]))


def _model(cfg: Dict, art, device, *, inference_fused: bool):
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    d = cfg["deploy"]
    return Pose2Mesh(cfg["joint_set"]["joint_num"], art.mesh_ops[-1].num_vertices,
                     blocks=[tuple(b) for b in cfg["blocks"]],
                     posenet_hidden=cfg["posenet_hidden"],
                     dtype=_dtype(cfg["compute_dtype"]), inference_fused=inference_fused,
                     flat_impl=d["flat_impl"], fused=d["fused"], dropout=cfg["dropout"],
                     device=device)


class ServeSystem:
    """step(pose2d on the device (B, J, 2)) -> (mesh mm (B, V, 3), regressed
    joints mm (B, J, 3), lifted pose mm (B, J, 3)), on the device."""

    def __init__(self, cfg: Dict, mesh: Dict[str, np.ndarray], state: Dict[str, torch.Tensor],
                 device: torch.device):
        from pose2mesh_release_tpu_torch.core.train import make_eval_step
        from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
        self.art = _artifact(cfg, mesh, device)
        self.model = _model(cfg, self.art, device, inference_fused=True)
        self.model.load_state_dict(fold_bn_variables(state))
        self.eval_step = make_eval_step(self.model, mesh["j_regressor"], device=device)

    def step(self, pose2d: torch.Tensor):
        return self.eval_step(self.art, pose2d)


class TrainSystem:
    """step(batch) -> the losses (device scalars); the optimizer's state,
    the parameters by name."""

    def __init__(self, cfg: Dict, mesh: Dict[str, np.ndarray], state: Dict[str, torch.Tensor],
                 device: torch.device, dropout_seed: int):
        from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
        from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
        self.art = _artifact(cfg, mesh, device)
        self.model = _model(cfg, self.art, device, inference_fused=False)
        self.model.load_state_dict(state)
        opt = cfg["optimizer"]
        self.optimizer = make_preconditioner(opt["name"], self.model.parameters())
        w = cfg["loss_weights"]
        self.train_step = make_train_step(self.model, self.optimizer, mesh["j_regressor"],
                                          normal_weight=w["normal"], edge_weight=w["edge"],
                                          joint_weight=w["joint"], device=device)
        self.state = TrainState(self.model, self.optimizer)
        self.generator = torch.Generator(device=device).manual_seed(dropout_seed)
        self.lr = float(opt["lr"])

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # the edge loss on, as in epochs >= 15 of the published schedule
        self.state, losses = self.train_step(self.state, self.art, batch, self.lr, True,
                                             self.generator)
        return losses

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def grad_norms_from_state(self) -> Dict[str, float]:
        """Each parameter's first gradient's norm, worked out from RMSprop's
        state after one step: square_avg = (1 - alpha) g^2."""
        alpha = float(self.optimizer.param_groups[0]["alpha"])
        out = {}
        for name, p in self.model.named_parameters():
            sq = self.optimizer.state[p]["square_avg"]
            out[name] = float(torch.sqrt(sq.double().sum() / (1.0 - alpha)))
        return out


def launch_counters() -> Dict[str, int]:
    """The ops modules' launch counters (wrapper name -> calls so far)."""
    from pose2mesh_release_tpu_torch.ops import (fused_cheby, fused_cheby_train, hop,
                                                 strip_cheby, window_cheby)
    out = {}
    for m in (fused_cheby, fused_cheby_train, hop, strip_cheby, window_cheby):
        out.update(m.launches)
    return out
