"""Evaluation metrics: MPJPE, PA-MPJPE (Procrustes), MPVPE, acceleration
error, as the JAX package's `core/metrics.py` defines them.  The Procrustes
solve is one batched SVD."""
from __future__ import annotations

import torch

__all__ = ["mpjpe", "rigid_align", "pa_mpjpe", "mpvpe", "accel_error"]


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error: pred/gt (..., J, 3)."""
    return torch.linalg.norm(pred - gt, dim=-1).mean()


def rigid_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Align pred to gt with the least-squares similarity transform (scale,
    rotation, translation); shapes (..., J, 3)."""
    J = pred.shape[-2]
    mu_p, mu_g = pred.mean(-2, keepdim=True), gt.mean(-2, keepdim=True)
    pc, gc = pred - mu_p, gt - mu_g
    var_p = (pc ** 2).sum((-2, -1))
    H = pc.transpose(-1, -2) @ gc / J
    U, S, Vt = torch.linalg.svd(H)
    R0 = Vt.transpose(-1, -2) @ U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(R0))
    D = torch.ones_like(S)
    D[..., 2] = d
    R = Vt.transpose(-1, -2) @ torch.diag_embed(D) @ U.transpose(-1, -2)
    scale = (S * D).sum(-1) * J / var_p
    t = mu_g - scale[..., None, None] * (mu_p @ R.transpose(-1, -2))
    return scale[..., None, None] * pred @ R.transpose(-1, -2) + t


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE over a batch: (B, J, 3)."""
    return torch.linalg.norm(rigid_align(pred, gt) - gt, dim=-1).mean()


def mpvpe(pred_mesh: torch.Tensor, gt_mesh: torch.Tensor) -> torch.Tensor:
    """Mean per-vertex position error: (B, V, 3)."""
    return torch.linalg.norm(pred_mesh - gt_mesh, dim=-1).mean()


def accel_error(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Acceleration error over a time sequence (T, J, 3)."""
    accel_p = pred[:-2] - 2 * pred[1:-1] + pred[2:]
    accel_g = gt[:-2] - 2 * gt[1:-1] + gt[2:]
    return torch.linalg.norm(accel_p - accel_g, dim=-1).mean()
