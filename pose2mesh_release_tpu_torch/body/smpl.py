"""SMPL wrapper: gendered layers, the extended 29-joint regressor, skeleton.

The base 24-joint SMPL regressor is extended with 5 one-hot rows picking
the nose, eye and ear vertices.  The layers come from `body.loader` (real
.pkl files in `model_dir`) or `body.synthetic` (deterministic stand-ins of
identical shapes, seeds 0 / 1 / 2 for neutral / male / female).  The H36M
and COCO regressors load from `data_dir` (the reference's
Human36M/J_regressor_h36m_correct.npy and COCO/J_regressor_coco.npy) when
given; otherwise each is a row-stochastic (17, V) stand-in drawn from a
fixed numpy seed, the same on every run and in every process.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, Optional

import numpy as np

from .loader import load_smpl_params
from .model import BodyModelParams
from .synthetic import SMPL_VERTS, synthetic_body_params

__all__ = ["SMPL", "stand_in_regressor"]

H36M_REGRESSOR_SEED = 17
COCO_REGRESSOR_SEED = 18
GENDER_SEEDS = {"neutral": 0, "male": 1, "female": 2}

# mesh vertex indices of nose, L eye, R eye, L ear, R ear
FACE_KPS_VERTEX = (331, 2802, 6262, 3489, 3990)

JOINTS_NAME = (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Knee", "R_Knee", "Spine",
    "L_Ankle", "R_Ankle", "Chest", "L_Toe", "R_Toe", "Neck", "L_Thorax",
    "R_Thorax", "Head", "L_Shoulder", "R_Shoulder", "L_Elbow", "R_Elbow",
    "L_Wrist", "R_Wrist", "L_Hand", "R_Hand", "Nose", "L_Eye", "R_Eye",
    "L_Ear", "R_Ear",
)
FLIP_PAIRS = (
    (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
    (20, 21), (22, 23), (25, 26), (27, 28),
)
SKELETON = (
    (0, 1), (1, 4), (4, 7), (7, 10), (0, 2), (2, 5), (5, 8), (8, 11),
    (0, 3), (3, 6), (6, 9), (9, 14), (14, 17), (17, 19), (21, 23),
    (9, 13), (13, 16), (16, 18), (18, 20), (20, 22), (9, 12), (12, 24),
    (24, 14), (24, 25), (24, 26), (25, 27), (26, 28),
)


def stand_in_regressor(num_joints: int, num_vertices: int,
                       seed: int = H36M_REGRESSOR_SEED) -> np.ndarray:
    """(num_joints, num_vertices) float32 regressor with rows summing to 1,
    each concentrated on a few vertices (the `w ** 8` sharpening)."""
    rng = np.random.default_rng(seed)
    w = rng.random((num_joints, num_vertices)).astype(np.float32) ** 8
    return w / w.sum(axis=1, keepdims=True)


class SMPL:
    """The SMPL body model family (the gendered layers share topology).

    face (F, 3) int64, v_template (6890, 3) float32 (the neutral layer's),
    joint_regressor (29, V), joint_regressor_smpl (24, V),
    joint_regressor_h36m / joint_regressor_coco (17, V), all float32."""

    vertex_num = SMPL_VERTS
    joint_num = 29
    joints_name = JOINTS_NAME
    flip_pairs = FLIP_PAIRS
    skeleton = SKELETON
    root_joint_idx = 0  # Pelvis

    def __init__(self, model_dir: Optional[str] = None, data_dir: Optional[str] = None):
        self.data_dir = data_dir
        self.layers: Dict[str, BodyModelParams] = {}
        for gender, seed in GENDER_SEEDS.items():
            params = load_smpl_params(model_dir, gender)
            if params is None:
                params = synthetic_body_params(num_vertices=SMPL_VERTS, num_joints=24,
                                               seed=seed)
            self.layers[gender] = params

        neutral = self.layers["neutral"]
        self.face = np.asarray(neutral.faces, dtype=np.int64)
        self.v_template = np.asarray(neutral.v_template, dtype=np.float32)
        base_reg = np.asarray(neutral.J_regressor)  # (24, V)
        onehots = np.zeros((5, self.vertex_num), dtype=np.float32)
        for i, v in enumerate(FACE_KPS_VERTEX):
            onehots[i, v] = 1.0
        self.joint_regressor = np.concatenate([base_reg, onehots]).astype(np.float32)
        self.joint_regressor_smpl = base_reg
        self.joint_regressor_h36m = self._load_npy(
            "Human36M/J_regressor_h36m_correct.npy", 17, H36M_REGRESSOR_SEED)
        # the datasets' name for the H36M set
        self.joint_regressor_human36 = self.joint_regressor_h36m
        self.joint_regressor_coco = self._load_npy(
            "COCO/J_regressor_coco.npy", 17, COCO_REGRESSOR_SEED)

    def _load_npy(self, rel: str, num_joints: int, seed: int) -> np.ndarray:
        if self.data_dir:
            path = osp.join(self.data_dir, rel)
            if osp.exists(path):
                return np.load(path).astype(np.float32)
        return stand_in_regressor(num_joints, self.vertex_num, seed)

    def layer(self, gender: str = "neutral") -> BodyModelParams:
        return self.layers[gender]
