"""Weak-perspective camera fitting for demo-time overlay.

Reference: lib/models/project_net.py:7-25: cam = (s, tx, ty) in normalized
crop coordinates, pixels = ((xy + t) * s) * res/2 + res/2; and the demo's
1500-step Adam fit with lr 0.1 -> 0.05@500 -> 0.001@1000 (demo/run.py:
149-197).  The fit runs on the device over all persons at once, the
gradient of the mean |projection - target| written out and Adam's update
by hand (optax.adam's b1 0.9, b2 0.999, eps 1e-8, bias corrections in
float32).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["project_weak", "fit_camera", "cam_to_pixel_params", "crop_cam_to_orig_params"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def project_weak(joints3d: torch.Tensor, cam: torch.Tensor,
                 img_res: float = 250.0) -> torch.Tensor:
    """(..., J, 3) x (..., 3) (s, tx, ty) -> (..., J, 2) crop pixels
    (project_net.py:14-17: ((xy + t) * s) * res/2 + res/2)."""
    s = cam[..., :1]
    t = cam[..., 1:]
    half = img_res * 0.5
    return (joints3d[..., :2] + t[..., None, :]) * s[..., None, :] * half + half


def cam_to_pixel_params(cam, img_res: float = 250.0):
    """(s, tx, ty) normalized -> pixel-space (scale, tx_px, ty_px) for the
    rasterizer: xy_px = xy * scale + t_px."""
    half = img_res * 0.5
    s, tx, ty = float(cam[0]), float(cam[1]), float(cam[2])
    return s * half, tx * s * half + half, ty * s * half + half


def crop_cam_to_orig_params(cam, bbox):
    """Fitted crop camera -> pixel params on the ORIGINAL image.

    cam: (s, tx, ty) weak-perspective fitted against the square fit-crop;
    bbox: (x, y, w, h) of that crop in original-image pixels (w == h).
    Composing the crop projection with the inverse crop affine gives
    xy_px = xy * (s*h/2) + (cx + t*s*h/2), the reference's
    convert_crop_cam_to_orig_img (demo/run.py:24-43) in this renderer's
    pixel convention, so the overlay lands on the input photo.
    """
    x, y, w, h = (float(v) for v in bbox)
    cx, cy = x + w * 0.5, y + h * 0.5
    s, tx, ty = float(cam[0]), float(cam[1]), float(cam[2])
    scale = s * h * 0.5
    return scale, cx + tx * scale, cy + ty * scale


def _lr(step: int) -> float:
    """demo/run.py:178-189: 0.1, 0.05 from step 500, 0.001 from step 1000."""
    return 0.1 if step < 500 else 0.05 if step < 1000 else 0.001


def fit_camera(
    joints3d,                 # (J, 3) or (P, J, 3) root-relative, meters
    target2d,                 # matching (..., J, 2) crop pixels
    num_steps: int = 1500,
    img_res: float = 250.0,
    init: Tuple[float, float, float] = (1.0, 0.0, 0.0),
    device: str | torch.device | None = "cuda",
) -> torch.Tensor:
    """Fit (s, tx, ty) minimizing mean |project - target| for each person;
    returns float32 cam params (..., 3) on `device`."""
    dev = resolve_device(device)
    j3d = torch.as_tensor(np.asarray(joints3d, np.float32) if not torch.is_tensor(joints3d)
                          else joints3d, dtype=torch.float32, device=dev)
    tgt = torch.as_tensor(np.asarray(target2d, np.float32) if not torch.is_tensor(target2d)
                          else target2d, dtype=torch.float32, device=dev)
    half = img_res * 0.5
    n = tgt.shape[-2] * tgt.shape[-1]
    xy = j3d[..., :2]
    cam = torch.tensor(init, dtype=torch.float32, device=dev).expand(
        *j3d.shape[:-2], 3).clone()
    mu = torch.zeros_like(cam)
    nu = torch.zeros_like(cam)
    b1, b2 = (torch.tensor(b, dtype=torch.float32, device=dev) for b in (_B1, _B2))
    for step in range(num_steps):
        s, t = cam[..., :1], cam[..., 1:]
        r = (xy + t[..., None, :]) * s[..., None, :] * half + half - tgt
        # d mean|r| / d ((xy + t) s), rounded as the JAX gradient is
        g1 = torch.where(r >= 0, 1.0, -1.0) * (1.0 / n) * half
        ds = (g1 * (xy + t[..., None, :])).sum((-2, -1))[..., None]
        dt = (g1 * s[..., None, :]).sum(-2)
        g = torch.cat([ds, dt], dim=-1)
        mu.mul_(_B1).add_(g, alpha=1 - _B1)
        nu.mul_(_B2).add_(g * g * (1 - _B2))
        mu_hat = mu / (1 - b1 ** (step + 1))
        nu_hat = nu / (1 - b2 ** (step + 1))
        cam -= _lr(step) * (mu_hat / (nu_hat.sqrt() + _EPS))
    return cam
