"""Evaluation step of the cascade (the deploy forward a Tester serves).

The training steps come with the training slice of the port.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.artifact import PyramidArtifact
from ..models.meshnet import extract_mesh

__all__ = ["make_eval_step"]


def make_eval_step(model: torch.nn.Module, j_regressor: np.ndarray | torch.Tensor,
                   *, device: str | torch.device | None = "cuda") -> Callable:
    """Eval forward returning (pred_mesh mm (B, V, 3), pred_reg_pose mm
    (B, J, 3), lifted pose mm (B, J, 3)).  `model` must already live on
    `device`; j_regressor is the (J_target, V) dense regressor."""
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model is on {p.device}, eval step on {dev}")
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    @torch.inference_mode()
    def eval_step(art: PyramidArtifact, pose2d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mesh_dev, pose3d = model(art, pose2d)
        mesh_mm = extract_mesh(art, mesh_dev) * 1000.0
        reg_pose = torch.einsum("jv,bvc->bjc", jreg, mesh_mm)
        return mesh_mm, reg_pose, pose3d

    return eval_step
