"""Minimal SMPL body model for the deploy forward and the train step: faces,
the rest mesh and the 17-joint Human3.6M joint regressor.

The real SMPL templates and the H36M regressor `.npy` are not shipped, so
this is the deterministic stand-in of identical shape: the UV-sphere mesh
of `body.synthetic` and a row-stochastic (17, V) regressor drawn from a
fixed numpy seed (the same on every run and in every process).
"""
from __future__ import annotations

import numpy as np

from .synthetic import SMPL_VERTS, stand_in_template, uv_sphere

__all__ = ["SMPL", "stand_in_regressor"]

H36M_REGRESSOR_SEED = 17


def stand_in_regressor(num_joints: int, num_vertices: int,
                       seed: int = H36M_REGRESSOR_SEED) -> np.ndarray:
    """(num_joints, num_vertices) float32 regressor with rows summing to 1,
    each concentrated on a few vertices (the `w ** 8` sharpening)."""
    rng = np.random.default_rng(seed)
    w = rng.random((num_joints, num_vertices)).astype(np.float32) ** 8
    return w / w.sum(axis=1, keepdims=True)


class SMPL:
    """SMPL topology: `face` (F, 3) int64, the rest mesh `v_template`
    (6890, 3) float32 and `joint_regressor_h36m` (17, 6890) float32."""

    vertex_num = SMPL_VERTS

    def __init__(self):
        _, faces = uv_sphere(SMPL_VERTS)
        self.face = faces
        self.v_template = stand_in_template(SMPL_VERTS)
        self.joint_regressor_h36m = stand_in_regressor(17, SMPL_VERTS)
