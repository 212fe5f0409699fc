"""Vectorized batch input pipeline.

The per-sample `MeshDataset.__getitem__` (data/base.py) mirrors the
reference's worker pipeline 1:1; this module is the same math over a whole
batch, as the JAX package's `data/pipeline.py`:

  * on the host (numpy, float64): the augmentation draws from the dataset's
    Generator in the JAX order (`uniform(B)` flip, `standard_normal(B)`
    rotation, `uniform(B)` zero-rotation mask), the tight boxes and the B
    3x3 affine solves;
  * torch ops on the device of their inputs: the affine apply, the 2D flip,
    the standardization, and the 3D rotation and flip of the joints and of
    the (B, V, 3) mesh.  These four ops stand where the JAX package runs
    its host C++ (`native/`).

`MeshDataset.get_batch` calls `batch_pipeline`; `BatchLoader` uses it when
the dataset supports it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device

__all__ = ["draw_augmentation", "batched_bbox", "batched_affine", "affine_apply",
           "flip_2d", "standardize", "rot_flip_3d", "batch_pipeline"]


def draw_augmentation(B: int, rng: np.random.Generator, *, is_train: bool,
                      flip_enabled: bool = True, rotate_factor: float = 30.0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(flip (B,) uint8, rotation (B,) float64 degrees), drawn from `rng`
    in the JAX package's order; no draw and no augmentation at eval."""
    if not is_train:
        return np.zeros(B, np.uint8), np.zeros(B, np.float64)
    flip = (rng.uniform(size=B) <= 0.5).astype(np.uint8) \
        if flip_enabled else np.zeros(B, np.uint8)
    rot = np.clip(rng.standard_normal(B) * rotate_factor,
                  -2 * rotate_factor, 2 * rotate_factor)
    rot = np.where(rng.uniform(size=B) <= 0.5, 0.0, rot)
    return flip, rot


def _rotate_2d_batch(pts: np.ndarray, rot_rad: np.ndarray) -> np.ndarray:
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.stack([pts[:, 0] * cs - pts[:, 1] * sn,
                     pts[:, 0] * sn + pts[:, 1] * cs], axis=1)


def batched_bbox(joint_img: np.ndarray, aspect: float) -> Tuple[np.ndarray, np.ndarray]:
    """Tight bbox -> aspect-preserving (center, scale) per sample
    (coord_utils.py:21-66 batched).  joint_img (B, J, 2)."""
    mn = joint_img.min(axis=1)
    mx = joint_img.max(axis=1)
    # process_bbox first shrinks to (w-1, h-1) (x2 = x+w-1), THEN
    # aspect-adjusts; center lands at (mn+mx-1)/2
    w = mx[:, 0] - mn[:, 0] - 1.0
    h = mx[:, 1] - mn[:, 1] - 1.0
    c = (mn + mx) * 0.5 - 0.5
    w2 = np.where(w > aspect * h, w, h * aspect)
    h2 = np.where(w > aspect * h, w / aspect, h)
    return c, np.stack([w2, h2], axis=1)


def batched_affine(center: np.ndarray, scale: np.ndarray, rot_deg: np.ndarray,
                   out_size: Tuple[int, int]) -> np.ndarray:
    """(B,) crop transforms -> (B, 2, 3) float64 matrices
    (aug_utils.py:145-180 / utils.augment.get_affine_transform batched)."""
    B = len(center)
    dst_w, dst_h = out_size
    rot_rad = np.pi * rot_deg / 180.0
    src_dir = _rotate_2d_batch(
        np.stack([np.zeros(B), scale[:, 0] * -0.5], axis=1), rot_rad
    )
    dst_dir = np.array([0.0, dst_w * -0.5], np.float64)

    src = np.zeros((B, 3, 2), np.float64)
    dst = np.zeros((B, 3, 2), np.float64)
    src[:, 0] = center
    src[:, 1] = center + src_dir
    dst[:, 0] = [dst_w * 0.5, dst_h * 0.5]
    dst[:, 1] = np.array([dst_w * 0.5, dst_h * 0.5]) + dst_dir

    def third(a, b):
        d = a - b
        return b + np.stack([-d[:, 1], d[:, 0]], axis=1)

    src[:, 2] = third(src[:, 0], src[:, 1])
    dst[:, 2] = third(dst[:, 0], dst[:, 1])

    A = np.concatenate([src, np.ones((B, 3, 1))], axis=2)  # (B, 3, 3)
    M_T = np.linalg.solve(A, dst)                          # (B, 3, 2)
    return M_T.transpose(0, 2, 1)                          # (B, 2, 3)


def affine_apply(joints: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """(B, J, 2) points through (B, 2, 3) affine maps, in the maps' dtype;
    float32 out."""
    homo = torch.cat([joints.to(mats.dtype),
                      torch.ones_like(joints[..., :1], dtype=mats.dtype)], dim=2)
    return torch.einsum("bij,bkj->bki", mats, homo).float()


def _swap(x: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """x (B, J, C) with the joints of each pair swapped."""
    if not len(pairs):
        return x
    perm = np.arange(x.shape[1])
    pa = np.asarray(pairs, np.int64).reshape(-1, 2)
    perm[pa[:, 0]], perm[pa[:, 1]] = pa[:, 1], pa[:, 0]
    return x.index_select(1, to_device(perm, x.device))


def flip_2d(p2d: torch.Tensor, flip: torch.Tensor, width: int,
            pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Mirror the samples where `flip` (B,) bool is set: x -> width - x - 1
    and the pairs swapped (aug_utils.py:33-40)."""
    mirrored = torch.cat([width - p2d[..., :1] - 1, p2d[..., 1:]], dim=2)
    return torch.where(flip[:, None, None], _swap(mirrored, pairs), p2d)


def standardize(joints: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """Pixels -> [0, 1] -> per-sample zero mean, unit (population) std,
    the std floored at 1e-6 (Human36M/dataset.py:383-388).  The mean and
    std accumulate in float64."""
    # scalar divisors: a (w, h) tensor built from a list would be a pageable
    # copy, which synchronizes the stream on the card
    x = torch.cat([joints[..., :1] / w, joints[..., 1:] / h], dim=2)
    x64 = x.double()
    mean = x64.mean(dim=1, keepdim=True)
    std = torch.sqrt(((x64 - mean) ** 2).mean(dim=1, keepdim=True)).clamp_min(1e-6)
    return (x - mean.float()) / std.float()


def rot_flip_3d(joints: torch.Tensor, rot_deg: torch.Tensor, flip: torch.Tensor,
                pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(B, J, 3) float32 points rotated in-plane by -rot_deg (B,) float64
    degrees (products in float64, one rounding to float32), then, where
    `flip` (B,) is set, the pairs swapped and x negated
    (aug_utils.py:74-89 batched)."""
    rot_rad = -torch.deg2rad(rot_deg)
    sn, cs = torch.sin(rot_rad)[:, None], torch.cos(rot_rad)[:, None]
    x, y = joints[..., 0].double(), joints[..., 1].double()
    out = torch.stack([(cs * x - sn * y).float(), (sn * x + cs * y).float(),
                       joints[..., 2]], dim=2)
    swapped = _swap(out, pairs)
    mirrored = torch.cat([-swapped[..., :1], swapped[..., 1:]], dim=2)
    return torch.where(flip[:, None, None], mirrored, out)


def batch_pipeline(
    joint_img: np.ndarray,         # (B, J, 2) pixels
    joint_cam: np.ndarray,         # (B, J, 3) mm
    input_shape: Tuple[int, int],  # (H, W)
    flip_pairs,
    *,
    is_train: bool,
    rng: Optional[np.random.Generator] = None,
    mesh_cam: Optional[np.ndarray] = None,     # (B, V, 3)
    reg3d: Optional[np.ndarray] = None,        # (B, Jt, 3)
    target_flip_pairs=(),
    flip_enabled: bool = True,
    rotate_factor: float = 30.0,
    device: str | torch.device | None = "cuda",
) -> dict:
    """Full augmentation pipeline for one batch of host arrays.

    Returns float32 tensors on `device`: 'pose2d' (standardized),
    'lift_pose3d', and the augmented 'mesh' / 'reg_pose3d' when given (a
    float16 mesh is copied as float16 and rotated in float32).  Semantics
    identical to MeshDataset.__getitem__ (the per-sample path)."""
    dev = resolve_device(device)
    B = joint_img.shape[0]
    H, W = input_shape
    rng = rng or np.random.default_rng()
    flip, rot = draw_augmentation(B, rng, is_train=is_train, flip_enabled=flip_enabled,
                                  rotate_factor=rotate_factor)
    center, scale = batched_bbox(joint_img, W / H)
    mats = batched_affine(center, scale, rot, (W, H))

    flip_t = to_device(flip.astype(bool), dev)
    rot_t = to_device(rot, dev)
    p2d = affine_apply(to_device(joint_img.astype(np.float32), dev), to_device(mats, dev))
    out = {
        "pose2d": standardize(flip_2d(p2d, flip_t, W, flip_pairs), W, H),
        "lift_pose3d": rot_flip_3d(to_device(joint_cam.astype(np.float32), dev),
                                   rot_t, flip_t, flip_pairs),
    }
    if mesh_cam is not None:
        out["mesh"] = rot_flip_3d(to_device(mesh_cam, dev).float(), rot_t, flip_t, ())
    if reg3d is not None:
        out["reg_pose3d"] = rot_flip_3d(to_device(reg3d.astype(np.float32), dev),
                                        rot_t, flip_t, target_flip_pairs)
    return out
