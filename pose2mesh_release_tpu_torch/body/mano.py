"""MANO right-hand wrapper: the 21-joint regressor with fingertips, output in
millimetres.

The layer comes from `body.loader` (MANO_RIGHT.pkl in `model_dir`) or is
the deterministic stand-in of `body.synthetic` (seed 7, scale 0.1) with the
true MANO finger-chain tree.  The 16 regressed joints gain 5 fingertip
one-hot rows and are reordered wrist -> thumb -> index -> middle -> ring ->
pinky.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .loader import load_mano_params
from .model import BodyModelParams, lbs_forward
from .synthetic import MANO_VERTS, synthetic_body_params

__all__ = ["MANO", "JOINT_REORDER", "HORI_CONN"]

# fingertip mesh vertex ids (right hand)
FINGERTIP_VERTEX = (745, 317, 445, 556, 673)

# regressor row order wrist -> thumb -> index -> middle -> ring -> pinky
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20)

# the MANO kinematic tree: five 3-joint finger chains off the wrist
MANO_PARENTS = (0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)

JOINTS_NAME = (
    "Wrist", "Thumb_1", "Thumb_2", "Thumb_3", "Thumb_4", "Index_1",
    "Index_2", "Index_3", "Index_4", "Middle_1", "Middle_2", "Middle_3",
    "Middle_4", "Ring_1", "Ring_2", "Ring_3", "Ring_4", "Pinky_1",
    "Pinky_2", "Pinky_3", "Pinky_4",
)
SKELETON = (
    (0, 1), (0, 5), (0, 9), (0, 13), (0, 17), (1, 2), (2, 3), (3, 4),
    (5, 6), (6, 7), (7, 8), (9, 10), (10, 11), (11, 12), (13, 14),
    (14, 15), (15, 16), (17, 18), (18, 19), (19, 20),
)
# horizontal finger-base connections of the FreiHAND joint graph
HORI_CONN = (
    (1, 5), (5, 9), (9, 13), (13, 17),
    (2, 6), (6, 10), (10, 14), (14, 18),
    (3, 7), (7, 11), (11, 15), (15, 19),
    (4, 8), (8, 12), (12, 16), (16, 20),
)


class MANO:
    """The MANO right hand: face (F, 3) int64, joint_regressor_mano
    (21, 778) float32 (also `joint_regressor`), `forward` in millimetres."""

    vertex_num = MANO_VERTS
    joint_num = 21
    joints_name = JOINTS_NAME
    skeleton = SKELETON
    hori_conn = HORI_CONN
    flip_pairs = ()
    root_joint_idx = 0  # Wrist

    def __init__(self, model_dir: Optional[str] = None,
                 params: Optional[BodyModelParams] = None):
        if params is None:
            params = load_mano_params(model_dir)
        if params is None:
            params = dataclasses.replace(
                synthetic_body_params(num_vertices=MANO_VERTS, num_joints=16,
                                      seed=7, scale=0.1),
                parents=MANO_PARENTS)
        self.params = params
        self.face = np.asarray(params.faces, dtype=np.int64)

        base_reg = np.asarray(params.J_regressor)  # (16, V)
        onehots = np.zeros((5, self.vertex_num), dtype=np.float32)
        for i, v in enumerate(FINGERTIP_VERTEX):
            onehots[i, v % self.vertex_num] = 1.0
        reg = np.concatenate([base_reg, onehots])
        self.joint_regressor = reg[list(JOINT_REORDER)].astype(np.float32)
        self.joint_regressor_mano = self.joint_regressor

    def layer(self, gender: str = "right") -> BodyModelParams:
        return self.params

    def forward(self, pose: torch.Tensor, betas: torch.Tensor,
                trans: Optional[torch.Tensor] = None):
        """LBS forward in millimetres: (verts (B, 778, 3), joints (B, 16, 3))."""
        verts, joints = lbs_forward(self.params, pose, betas, trans)
        return verts * 1000.0, joints * 1000.0
