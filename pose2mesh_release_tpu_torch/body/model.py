"""Body model parameter container and vectorized linear blend skinning.

One batched LBS for every joint at once: Rodrigues on all joints, the
kinematic chain composed in depth order (every parent before its children,
one batched 4 x 4 product per depth), skinning as one (V, J) x (J, 4, 4)
contraction.  Same math as the JAX package's `body/model.py` (the
reference's smplpytorch / manopth layers), in float32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["BodyModelParams", "rodrigues", "lbs_forward"]


@dataclass(frozen=True)
class BodyModelParams:
    """SMPL/MANO-style LBS parameters; arrays may be numpy or tensors.

    v_template: (V, 3) rest vertices
    shapedirs:  (V, 3, B) shape blendshapes
    posedirs:   (V, 3, 9*(J-1)) pose blendshapes (flattened rotmat deltas)
    J_regressor:(J, V) rest-joint regressor
    lbs_weights:(V, J) skinning weights
    parents:    (J,) kinematic tree, parents[0] == 0
    faces:      (T, 3) triangles
    pose_mean:  optional (3*(J-1),) rest-pose mean added to the articulated
                pose (MANO's hands_mean)
    """

    v_template: Any
    shapedirs: Any
    posedirs: Any
    J_regressor: Any
    lbs_weights: Any
    parents: Tuple[int, ...] = ()
    faces: Any = None
    pose_mean: Any = None

    def __post_init__(self):
        if not isinstance(self.parents, tuple):
            object.__setattr__(self, "parents", tuple(int(p) for p in self.parents))

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def to(self, device) -> "BodyModelParams":
        """Every float array as a float32 tensor on `device` (faces stay
        as they are)."""
        moved = {}
        for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "pose_mean"):
            a = getattr(self, f)
            if a is not None:
                moved[f] = torch.as_tensor(a, dtype=torch.float32, device=device)
        return dataclasses.replace(self, **moved)


def _f32(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), the quaternion
    form (safe at the zero-angle limit)."""
    angle = torch.linalg.vector_norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    w = torch.cos(half)[..., 0]
    xyz = torch.sin(half) * axis
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = torch.stack([
        w2 + x2 - y2 - z2, 2 * (xy - wz), 2 * (wy + xz),
        2 * (wz + xy), w2 - x2 + y2 - z2, 2 * (yz - wx),
        2 * (xz - wy), 2 * (wx + yz), w2 - x2 - y2 + z2,
    ], dim=-1)
    return R.reshape(axisang.shape[:-1] + (3, 3))


def _depth_levels(parents: Tuple[int, ...]):
    """Joints 1.. grouped by their depth in the tree, shallowest first."""
    depth = np.zeros(len(parents), dtype=np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return [np.flatnonzero(depth == d) for d in range(1, int(depth.max(initial=0)) + 1)]


def lbs_forward(params: BodyModelParams, pose_axisang: torch.Tensor,
                betas: torch.Tensor, trans: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear blend skinning.

    pose_axisang: (B, J*3) axis-angle, joint 0 = global rotation
    betas: (B, num_betas)
    trans: optional (B, 3) translation
    Returns (verts (B, V, 3), joints (B, J, 3)) in model units (metres for
    SMPL; the MANO wrapper converts to millimetres)."""
    pose_axisang = pose_axisang.float()
    betas = betas.float()
    B, J = pose_axisang.shape[0], params.num_joints
    V = params.num_vertices
    if params.pose_mean is not None:
        pose_axisang = torch.cat(
            [pose_axisang[:, :3],
             pose_axisang[:, 3:] + _f32(params.pose_mean, pose_axisang)[None]], dim=1)
    rots = rodrigues(pose_axisang.reshape(B, J, 3))  # (B, J, 3, 3)

    v_template = _f32(params.v_template, betas)
    v_shaped = v_template[None] + torch.einsum(
        "vcb,nb->nvc", _f32(params.shapedirs, betas), betas)
    j_rest = torch.einsum("jv,nvc->njc", _f32(params.J_regressor, betas), v_shaped)

    # pose blendshapes from the non-root rotations minus the identity
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_feat = (rots[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + torch.einsum("vcp,np->nvc", _f32(params.posedirs, betas),
                                      pose_feat)

    # kinematic chain: local transforms, composed one depth at a time
    parents = np.asarray(params.parents, dtype=np.int64)
    rel_t = torch.cat([j_rest[:, :1], j_rest[:, 1:] - j_rest[:, parents[1:]]], dim=1)
    local = torch.zeros(B, J, 4, 4, dtype=rots.dtype, device=rots.device)
    local[:, :, :3, :3] = rots
    local[:, :, :3, 3] = rel_t
    local[:, :, 3, 3] = 1.0
    G = local.clone()
    for joints in _depth_levels(params.parents):
        idx = torch.from_numpy(joints).to(rots.device)
        par = torch.from_numpy(parents[joints]).to(rots.device)
        G[:, idx] = G[:, par] @ local[:, idx]

    joints = G[:, :, :3, 3]

    # take the rest-pose joint location out of each transform so skinning
    # maps rest-pose vertices
    j_rest_h = torch.cat([j_rest, torch.zeros(B, J, 1, dtype=G.dtype, device=G.device)],
                         dim=-1)
    correction = torch.einsum("njab,njb->nja", G, j_rest_h)
    G_skin = G.clone()
    G_skin[:, :, :, 3] = G[:, :, :, 3] - correction

    T = torch.einsum("vj,njab->nvab", _f32(params.lbs_weights, betas), G_skin)
    v_h = torch.cat([v_posed, torch.ones(B, V, 1, dtype=v_posed.dtype,
                                         device=v_posed.device)], dim=-1)
    verts = torch.einsum("nvab,nvb->nva", T, v_h)[..., :3]

    if trans is not None:
        trans = trans.float()
        verts = verts + trans[:, None]
        joints = joints + trans[:, None]
    return verts, joints
