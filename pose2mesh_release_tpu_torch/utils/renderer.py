"""Mesh overlay renderer: weak-perspective + z-buffer rasterizer.

Reference: demo/renderer.py (pyrender offscreen + WeakPerspectiveCamera +
alpha composite).  Without pyrender or OpenGL, this is a small
dependency-free numpy rasterizer: weak-perspective projection, backface
culling, barycentric z-buffer fill with Lambertian shading, alpha blend
onto the input image.  Slow path (host-side, demo only) but bit-exact
deterministic and headless-safe.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["render_mesh_overlay"]


def render_mesh_overlay(
    img: np.ndarray,            # (H, W, 3) uint8 background
    verts: np.ndarray,          # (V, 3) meters, root-relative
    faces: np.ndarray,          # (T, 3)
    cam: np.ndarray,            # (s, tx, ty) weak-perspective (crop space)
    color: Tuple[float, float, float] = (0.65, 0.74, 0.86),
    alpha: float = 0.8,
    light_dir: Tuple[float, float, float] = (0.0, 0.0, -1.0),
) -> np.ndarray:
    H, W = img.shape[:2]
    s, tx, ty = float(cam[0]), float(cam[1]), float(cam[2])
    xy = verts[:, :2] * s + np.array([tx, ty])
    z = verts[:, 2]

    out = img.astype(np.float32).copy()
    zbuf = np.full((H, W), np.inf, np.float32)

    tri_xy = xy[faces]                     # (T, 3, 2)
    tri_z = z[faces]                       # (T, 3)
    # face normals in camera space for shading + backface culling
    v3 = np.concatenate([verts[:, :2], z[:, None]], axis=1)[faces]
    n = np.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
    n_norm = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    shade = np.clip(-(n_norm @ np.asarray(light_dir, np.float32)), 0.15, 1.0)

    order = np.argsort(-tri_z.mean(1))     # rough back-to-front for stability
    base = np.asarray(color, np.float32) * 255.0
    for t in order:
        p = tri_xy[t]
        xmin = max(int(np.floor(p[:, 0].min())), 0)
        xmax = min(int(np.ceil(p[:, 0].max())) + 1, W)
        ymin = max(int(np.floor(p[:, 1].min())), 0)
        ymax = min(int(np.ceil(p[:, 1].max())) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax), np.arange(ymin, ymax))
        d = ((p[1, 1] - p[2, 1]) * (p[0, 0] - p[2, 0])
             + (p[2, 0] - p[1, 0]) * (p[0, 1] - p[2, 1]))
        if abs(d) < 1e-9:
            continue
        w0 = ((p[1, 1] - p[2, 1]) * (xs - p[2, 0])
              + (p[2, 0] - p[1, 0]) * (ys - p[2, 1])) / d
        w1 = ((p[2, 1] - p[0, 1]) * (xs - p[2, 0])
              + (p[0, 0] - p[2, 0]) * (ys - p[2, 1])) / d
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        zi = w0 * tri_z[t, 0] + w1 * tri_z[t, 1] + w2 * tri_z[t, 2]
        sub_z = zbuf[ymin:ymax, xmin:xmax]
        mask = inside & (zi < sub_z)
        if not mask.any():
            continue
        sub_z[mask] = zi[mask]
        pix = base * shade[t]
        sub = out[ymin:ymax, xmin:xmax]
        sub[mask] = (1 - alpha) * sub[mask] + alpha * pix
    return np.clip(out, 0, 255).astype(np.uint8)
