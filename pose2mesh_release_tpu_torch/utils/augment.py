"""2D/3D pose augmentation (host-side, NumPy; cv2-free), as the JAX
package's `utils/augment.py` (the reference's lib/aug_utils.py).  The
affine-crop transform is computed by solving the 3-point correspondence
directly instead of cv2.getAffineTransform (identical result, no OpenCV
dependency in the hot input path).
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

from .coords import get_center_scale

__all__ = [
    "transform_joint_to_other_db", "flip_2d_joint", "flip_3d_joint",
    "get_affine_transform", "affine_transform", "j2d_processing",
    "j3d_processing", "augm_params",
]


def transform_joint_to_other_db(src_joint, src_name, dst_name):
    """Remap joints between joint-set conventions by name
    (aug_utils.py:10-21)."""
    new_joint = np.zeros((len(dst_name),) + src_joint.shape[1:], dtype=np.float32)
    for src_idx, name in enumerate(src_name):
        if name in dst_name:
            new_joint[dst_name.index(name)] = src_joint[src_idx]
    return new_joint


def flip_2d_joint(kp, width, flip_pairs):
    kp = kp.copy()
    kp[:, 0] = width - kp[:, 0] - 1
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    return kp


def flip_3d_joint(kp, flip_pairs):
    kp = kp.copy()
    for a, b in flip_pairs:
        kp[[a, b]] = kp[[b, a]]
    kp[:, 0] = -kp[:, 0]
    return kp


def _rotate_2d(pt, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([pt[0] * cs - pt[1] * sn, pt[0] * sn + pt[1] * cs], np.float32)


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 3-point affine solve (replaces cv2.getAffineTransform)."""
    A = np.concatenate([src, np.ones((3, 1))], axis=1)  # (3, 3)
    # M @ [x; y; 1] = [x'; y'] -> solve A @ M.T = dst
    M_T = np.linalg.solve(A, dst)  # (3, 2)
    return M_T.T.astype(np.float64)  # (2, 3)


def get_affine_transform(center, scale, rot, output_size,
                         shift=np.zeros(2, np.float32), inv=False):
    """Crop transform (aug_utils.py:145-180): maps the scaled/rotated box
    around `center` onto the output resolution."""
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale, np.float32)
    if scale.ndim == 0:
        scale = np.array([scale, scale], np.float32)
    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_2d(np.array([0, src_w * -0.5], np.float32), rot_rad)
    dst_dir = np.array([0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    return _solve_affine(dst, src) if inv else _solve_affine(src, dst)


def affine_transform(pt, t):
    return (t @ np.array([pt[0], pt[1], 1.0]))[:2]


def j2d_processing(kp, res, bbox, rot, flip, flip_pairs):
    """GT 2D keypoint crop + augmentation (aug_utils.py:58-71).

    res: (width, height) of the crop.  Returns (kp, trans)."""
    center, scale = get_center_scale(bbox)
    trans = get_affine_transform(center, scale, rot, res)
    kp = kp.copy().astype(np.float64)
    ones = np.ones((len(kp), 1))
    kp[:, :2] = np.concatenate([kp[:, :2], ones], axis=1) @ trans.T
    if flip:
        kp = flip_2d_joint(kp, res[0], flip_pairs)
    return kp.astype(np.float32), trans


def j3d_processing(S, rot, flip, flip_pairs):
    """GT 3D keypoint in-plane rotation + flip (aug_utils.py:74-89)."""
    rot_mat = np.eye(3)
    if rot != 0:
        rot_rad = -rot * np.pi / 180
        sn, cs = np.sin(rot_rad), np.cos(rot_rad)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
    S = S @ rot_mat.T
    if flip:
        S = flip_3d_joint(S, flip_pairs)
    return S.astype(np.float32)


def augm_params(is_train: bool, flip_enabled: bool, rotate_factor: float,
                rng: Optional[random.Random] = None) -> Tuple[int, float]:
    """Draw (flip, rot) augmentation parameters (aug_utils.py:98-117)."""
    if not is_train:
        return 0, 0.0
    r = rng or random
    flip = 1 if (flip_enabled and r.uniform(0, 1) <= 0.5) else 0
    rot = min(2 * rotate_factor,
              max(-2 * rotate_factor, np.random.randn() * rotate_factor))
    if r.uniform(0, 1) <= 0.5:
        rot = 0.0
    return flip, rot
