"""Batched ground-truth mesh synthesis.

The reference runs a full SMPL LBS per sample inside its data loader
workers; here GT synthesis is one batched LBS evaluated in large chunks
(`batched_gt`) on the card, once when a dataset is built.  Same math as the
JAX package's `data/gt_synth.py`: for the H36M camera the world-to-camera
rotation is folded into the root joint's axis-angle and the translation is
compensated for the root-rotation pivot; outputs are millimetres.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ..body.model import BodyModelParams, lbs_forward, rodrigues
from ..device import resolve_device

__all__ = [
    "mat2axisang", "posed_mesh_cam", "posed_mesh_world", "posed_mesh_rotated",
    "regress_joints", "project_perspective", "add_pelvis_and_neck",
    "batched_gt",
]


def mat2axisang(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3) (the log map).

    Safe at angle ~ 0 (returns the skew part) and guarded at angle ~ pi
    (the axis from the diagonal of (R + I) / 2, signs from the skew part)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    angle = torch.arccos(cos)
    # skew-symmetric part: the rotation axis times 2 sin(angle)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin = torch.sin(angle)
    small = angle < 1e-5
    near_pi = angle > math.pi - 1e-4
    one = torch.ones_like(sin)
    axis_gen = v / torch.where(small | near_pi, one, 2.0 * sin)[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_pi = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    ones = torch.ones_like(v)
    sign = torch.sign(torch.where(
        small[..., None], ones,
        torch.where(near_pi[..., None], torch.where(v == 0, ones, torch.sign(v)), ones)))
    axis_pi = axis_pi * sign
    axis_pi = axis_pi / torch.linalg.vector_norm(axis_pi + 1e-12, dim=-1, keepdim=True)
    axis = torch.where(near_pi[..., None], axis_pi, axis_gen)
    out = axis * angle[..., None]
    return torch.where(small[..., None], v * 0.5, out)


def _root_to_cam(pose: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """pose with the rotation R folded into its root axis-angle."""
    root_cam = mat2axisang(R @ rodrigues(pose[:, :3]))
    return torch.cat([root_cam, pose[:, 3:]], dim=1)


def posed_mesh_cam(params: BodyModelParams, pose: torch.Tensor, shape: torch.Tensor,
                   trans: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World-frame SMPL parameters -> camera-frame (mesh mm, joints mm).

    pose (B, J*3) axis-angle, world frame; shape (B, n_betas); trans (B, 3)
    model-to-world translation in metres; R (B, 3, 3), t (B, 3) mm the
    world-to-camera transform.  Betas with any |beta| > 3 reset to the mean
    shape; the translation is compensated for the root-rotation pivot."""
    pose, shape, trans, R, t = (a.float() for a in (pose, shape, trans, R, t))
    shape = torch.where((shape.abs() > 3).any(dim=1, keepdim=True),
                        torch.zeros_like(shape), shape)
    verts, joints = lbs_forward(params, _root_to_cam(pose, R), shape)  # metres
    trans_cam = torch.einsum("nab,nb->na", R, trans) + t / 1000.0
    root_joint = joints[:, :1]
    trans_cam = (trans_cam[:, None] - root_joint
                 + torch.einsum("nab,njb->nja", R, root_joint))
    return (verts + trans_cam) * 1000.0, (joints + trans_cam) * 1000.0


def posed_mesh_rotated(params: BodyModelParams, pose: torch.Tensor, shape: torch.Tensor,
                       R: torch.Tensor, t_mm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Root-rotated LBS plus a direct translation, millimetres (the AMASS
    camera model: no root-pivot compensation, t added to the rotated mesh)."""
    pose, shape, R, t_mm = (a.float() for a in (pose, shape, R, t_mm))
    verts, joints = lbs_forward(params, _root_to_cam(pose, R), shape)
    return verts * 1000.0 + t_mm[:, None], joints * 1000.0 + t_mm[:, None]


def posed_mesh_world(params: BodyModelParams, pose: torch.Tensor, shape: torch.Tensor,
                     trans: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain posed mesh with translation, millimetres (the PW3D / SURREAL GT)."""
    verts, joints = lbs_forward(params, pose, shape, trans)
    return verts * 1000.0, joints * 1000.0


def regress_joints(regressor: torch.Tensor, mesh: torch.Tensor) -> torch.Tensor:
    """(J, V) x (..., V, 3) -> (..., J, 3)."""
    return torch.einsum("jv,...vc->...jc", regressor, mesh)


def add_pelvis_and_neck(joints: torch.Tensor, lhip: int, rhip: int,
                        lsho: int, rsho: int) -> torch.Tensor:
    """Append pelvis = (L_Hip + R_Hip) / 2 and neck = (L_Sho + R_Sho) / 2."""
    pelvis = (joints[..., lhip, :] + joints[..., rhip, :]) * 0.5
    neck = (joints[..., lsho, :] + joints[..., rsho, :]) * 0.5
    return torch.cat([joints, pelvis[..., None, :], neck[..., None, :]], dim=-2)


def project_perspective(cam_mm: torch.Tensor, focal: torch.Tensor,
                        princpt: torch.Tensor) -> torch.Tensor:
    """Perspective projection: cam_mm (..., J, 3), focal / princpt (..., 2)
    -> (..., J, 2) pixels."""
    z = cam_mm[..., 2:]
    xy = cam_mm[..., :2] / torch.where(z == 0, torch.full_like(z, 1e-8), z)
    return xy * focal[..., None, :] + princpt[..., None, :]


def batched_gt(fn: Callable, arrays: Tuple[np.ndarray, ...], batch: int = 512,
               device: str | torch.device | None = "cuda",
               out_dtype=np.float32):
    """Run a GT-synthesis fn over a large record set in chunks of `batch` on
    `device`, the tail padded with copies of its last record so every chunk
    has one shape; returns numpy.

    fn(*chunk_tensors) -> tensor or tuple of tensors, leading dim = batch."""
    dev = resolve_device(device)
    n = arrays[0].shape[0]
    outs = None
    with torch.no_grad():
        for start in range(0, n, batch):
            end = min(start + batch, n)
            chunk = [np.asarray(a[start:end]) for a in arrays]
            if end - start < batch:
                pad = batch - (end - start)
                chunk = [np.concatenate([c, np.repeat(c[-1:], pad, 0)]) for c in chunk]
            res = fn(*[torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in chunk])
            if not isinstance(res, tuple):
                res = (res,)
            res = [r[: end - start].cpu().numpy().astype(out_dtype) for r in res]
            if outs is None:
                outs = [[] for _ in res]
            for o, r in zip(outs, res):
                o.append(r)
    if outs is None:
        return None
    outs = [np.concatenate(o) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)
