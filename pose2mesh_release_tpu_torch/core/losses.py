"""Training losses of the cascade.

Same definitions as the JAX package's `core/losses.py` (the reference's
CoordLoss, normal-vector, edge-length and Laplacian losses and their
weighting).  The validity mask of the L1 losses scales both operands before
the mean over every element, masked ones included.  `_normalize` and the
edge length keep the JAX package's grad-safe forms: a zero-length edge or a
collapsed triangle yields zero, not NaN, in the forward and the gradient.

Face corners are index gathers (`pred[:, faces[:, c]]`) whose backward is
autograd's index-add.  The JAX train step routes them through
`face_take3_band` (a banded selector-matmul VJP over tables the port's
artifact does not build yet); the forward values are identical, and the
gradients agree up to the order of summation.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["coord_l1", "normal_vector_loss", "edge_length_loss",
           "pose2mesh_loss", "make_laplacian_loss"]


def coord_l1(pred: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Masked L1: mean over all elements, masked ones contributing zero."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / ||v|| with a grad-safe zero branch: 0 where ||v|| <= eps (torch's
    F.normalize returns v / eps there; unreachable in float32 for distinct
    points, see the JAX package's note)."""
    n2 = (v * v).sum(-1, keepdim=True)
    ok = n2 > eps * eps
    inv = torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return torch.where(ok, v * inv, torch.zeros_like(v))


def _corners(pred: torch.Tensor, faces: torch.Tensor):
    return tuple(pred[:, faces[:, c]] for c in range(3))


def normal_vector_loss(pred: torch.Tensor, gt: torch.Tensor, faces: torch.Tensor,
                       corners=None) -> torch.Tensor:
    """|cos| between predicted edge vectors and ground-truth face normals,
    averaged over faces.  corners: precomputed (p0, p1, p2) gathers."""
    p0, p1, p2 = corners if corners is not None else _corners(pred, faces)
    v1o = _normalize(p1 - p0)
    v2o = _normalize(p2 - p0)
    v3o = _normalize(p2 - p1)
    g0, g1, g2 = _corners(gt, faces)
    v1g = _normalize(g1 - g0)
    v2g = _normalize(g2 - g0)
    ng = _normalize(torch.linalg.cross(v1g, v2g, dim=-1))
    cos = [((v * ng).sum(-1)).abs() for v in (v1o, v2o, v3o)]
    return torch.stack(cos).mean()


def _edge_len(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| with a grad-safe zero at coincident points."""
    n2 = ((a - b) ** 2).sum(-1)
    ok = n2 > 1e-24
    return torch.where(ok, torch.sqrt(torch.where(ok, n2, torch.ones_like(n2))),
                       torch.zeros_like(n2))


def edge_length_loss(pred: torch.Tensor, gt: torch.Tensor, faces: torch.Tensor,
                     corners=None) -> torch.Tensor:
    """Edge-length preservation against the ground-truth mesh."""
    p = corners if corners is not None else _corners(pred, faces)
    g = _corners(gt, faces)
    d = [(_edge_len(p[a], p[b]) - _edge_len(g[a], g[b])).abs()
         for a, b in ((0, 1), (0, 2), (1, 2))]
    return torch.stack(d).mean()


def make_laplacian_loss(faces):
    """Uniform-Laplacian smoothness loss: delta_i = x_i - mean of x over the
    neighbours of i (an index-add over the undirected edge list), loss =
    mean_i ||delta_i||^2, or sum / batch with average=True."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    src = torch.from_numpy(np.concatenate([e[:, 0], e[:, 1]]))
    dst = torch.from_numpy(np.concatenate([e[:, 1], e[:, 0]]))
    num_v = int(f.max()) + 1
    deg = np.bincount(src.numpy(), minlength=num_v).astype(np.float32)
    inv_deg = torch.from_numpy(1.0 / (deg + 1e-8))

    def loss(x: torch.Tensor, average: bool = False) -> torch.Tensor:
        s, d = src.to(x.device), dst.to(x.device)
        nbr = torch.zeros_like(x).index_add_(1, s, x[:, d])
        delta = x - nbr * inv_deg.to(x.device)[None, :, None]
        sq = (delta ** 2).sum(-1)
        return sq.sum() / x.shape[0] if average else sq.mean()

    return loss


def pose2mesh_loss(pred_mesh: torch.Tensor, lift_pose: torch.Tensor,
                   pred_reg_pose: torch.Tensor, targets: Dict[str, torch.Tensor],
                   faces: torch.Tensor, *, normal_weight: float = 0.1,
                   edge_weight: float = 20.0, joint_weight: float = 1e-3,
                   use_edge_loss: bool | torch.Tensor = False
                   ) -> Dict[str, torch.Tensor]:
    """The full training objective.

    pred_mesh (B, V, 3) m in original vertex order; lift_pose (B, J, 3) mm;
    pred_reg_pose (B, J_t, 3) mm; targets: mesh, mesh_valid, reg_pose3d,
    reg_pose3d_valid, lift_pose3d, lift_pose3d_valid.  `use_edge_loss`
    gates the edge term."""
    l_vert = coord_l1(pred_mesh, targets["mesh"], targets["mesh_valid"])
    corners = _corners(pred_mesh, faces)
    l_norm = normal_weight * normal_vector_loss(pred_mesh, targets["mesh"], faces,
                                                corners=corners)
    l_edge = edge_weight * edge_length_loss(pred_mesh, targets["mesh"], faces,
                                            corners=corners)
    gate = torch.as_tensor(use_edge_loss, dtype=torch.bool, device=l_edge.device)
    l_edge = torch.where(gate, l_edge, torch.zeros_like(l_edge))
    l_reg = joint_weight * coord_l1(pred_reg_pose, targets["reg_pose3d"],
                                    targets["reg_pose3d_valid"])
    l_lift = joint_weight * coord_l1(lift_pose, targets["lift_pose3d"],
                                     targets["lift_pose3d_valid"])
    return {
        "total": l_vert + l_norm + l_edge + l_reg + l_lift,
        "vertex": l_vert,
        "normal": l_norm,
        "edge": l_edge,
        "reg_joint": l_reg,
        "lift_joint": l_lift,
    }
