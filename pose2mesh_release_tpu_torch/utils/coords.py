"""Camera / geometry utilities (host-side, NumPy).

As the JAX package's `utils/coords.py` (the reference's lib/coord_utils.py).
These run in the data pipeline and evaluators; the batched Procrustes on
the card lives in core.metrics (one batched SVD).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "get_center_scale", "get_bbox", "process_bbox",
    "cam2pixel", "pixel2cam", "world2cam",
    "rigid_transform_3d", "rigid_align", "euler2mat", "compute_error_accel",
]


def get_center_scale(box_info: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """bbox (x, y, w, h) -> (center, scale) (coord_utils.py:7-18)."""
    x, y, w, h = box_info
    center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
    scale = np.array([w, h], dtype=np.float32)
    return center, scale


def get_bbox(joint_img: np.ndarray) -> np.ndarray:
    """Tight bbox around 2D joints (coord_utils.py:21-39)."""
    x, y = joint_img[:, 0], joint_img[:, 1]
    xmin, xmax = float(x.min()), float(x.max())
    ymin, ymax = float(y.min()), float(y.max())
    return np.array([xmin, ymin, xmax - xmin, ymax - ymin], dtype=np.float32)


def process_bbox(
    bbox: np.ndarray, aspect_ratio: float, scale: float = 1.0
) -> Optional[np.ndarray]:
    """Sanitize + make aspect-ratio-preserving (coord_utils.py:42-66).

    aspect_ratio = input_width / input_height (cfg.MODEL.input_shape[1]/[0]).
    """
    x, y, w, h = bbox
    x1, y1, x2, y2 = x, y, x + (w - 1), y + (h - 1)
    if w * h > 0 and x2 >= x1 and y2 >= y1:
        bbox = np.array([x1, y1, x2 - x1, y2 - y1], dtype=np.float64)
    else:
        return None
    w, h = bbox[2], bbox[3]
    c_x, c_y = bbox[0] + w / 2.0, bbox[1] + h / 2.0
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    bbox[2] = w * scale
    bbox[3] = h * scale
    bbox[0] = c_x - bbox[2] / 2.0
    bbox[1] = c_y - bbox[3] / 2.0
    return bbox.astype(np.float32)


def cam2pixel(cam_coord: np.ndarray, f, c) -> np.ndarray:
    """Perspective projection, keeps depth (coord_utils.py:104-109)."""
    x = cam_coord[:, 0] / cam_coord[:, 2] * f[0] + c[0]
    y = cam_coord[:, 1] / cam_coord[:, 2] * f[1] + c[1]
    return np.stack([x, y, cam_coord[:, 2]], axis=1)


def world2cam(world_coord: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return world_coord @ np.asarray(R).T + np.asarray(t).reshape(1, 3)


def pixel2cam(coords: np.ndarray, c, f) -> np.ndarray:
    """Back-projection (coord_utils.py:117-124)."""
    out = np.zeros((len(coords), 3))
    z = coords[..., 2].reshape(-1, 1)
    out[..., :2] = (coords[..., :2] - np.asarray(c)) * z / np.asarray(f)
    out[..., 2] = coords[..., 2]
    return out


def rigid_transform_3d(A: np.ndarray, B: np.ndarray):
    """Least-squares similarity transform A -> B (coord_utils.py:127-144)."""
    n = A.shape[0]
    mu_a, mu_b = A.mean(0), B.mean(0)
    H = (A - mu_a).T @ (B - mu_b) / n
    U, s, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        s = s.copy()
        s[-1] = -s[-1]
        Vt = Vt.copy()
        Vt[2] = -Vt[2]
        R = Vt.T @ U.T
    var_a = A.var(axis=0).sum()
    c = s.sum() / var_a
    t = mu_b - c * R @ mu_a
    return c, R, t


def rigid_align(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Procrustes-align A onto B (coord_utils.py:147-149)."""
    c, R, t = rigid_transform_3d(A, B)
    return A @ (c * R).T + t


def euler2mat(theta: np.ndarray) -> np.ndarray:
    """XYZ Euler angles (..., 3) -> rotation matrices R_z @ R_y @ R_x
    (coord_utils.py:152-191)."""
    theta = np.asarray(theta, dtype=np.float64)
    shape = theta.shape[:-1]
    tx, ty, tz = (theta.reshape(-1, 3)[:, i] for i in range(3))
    cx, sx, cy, sy, cz, sz = np.cos(tx), np.sin(tx), np.cos(ty), np.sin(ty), np.cos(tz), np.sin(tz)
    n = len(tx)
    Rx = np.zeros((n, 3, 3)); Ry = np.zeros((n, 3, 3)); Rz = np.zeros((n, 3, 3))
    Rx[:, 0, 0] = 1; Rx[:, 1, 1] = cx; Rx[:, 1, 2] = -sx; Rx[:, 2, 1] = sx; Rx[:, 2, 2] = cx
    Ry[:, 0, 0] = cy; Ry[:, 0, 2] = sy; Ry[:, 1, 1] = 1; Ry[:, 2, 0] = -sy; Ry[:, 2, 2] = cy
    Rz[:, 0, 0] = cz; Rz[:, 0, 1] = -sz; Rz[:, 1, 0] = sz; Rz[:, 1, 1] = cz; Rz[:, 2, 2] = 1
    R = Rz @ Ry @ Rx
    return R.reshape(shape + (3, 3))


def compute_error_accel(
    joints_gt: np.ndarray, joints_pred: np.ndarray, vis: Optional[np.ndarray] = None
) -> np.ndarray:
    """Acceleration error per frame (coord_utils.py:194-222)."""
    accel_gt = joints_gt[:-2] - 2 * joints_gt[1:-1] + joints_gt[2:]
    accel_pred = joints_pred[:-2] - 2 * joints_pred[1:-1] + joints_pred[2:]
    normed = np.linalg.norm(accel_pred - accel_gt, axis=2)
    if vis is None:
        mask = np.ones(len(normed), dtype=bool)
    else:
        invis = ~np.asarray(vis, dtype=bool)
        new_invis = invis | np.roll(invis, -1) | np.roll(invis, -2)
        mask = ~new_invis[:-2]
    return normed[mask].mean(axis=1)
