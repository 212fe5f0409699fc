"""Visualization: 2D/3D skeleton drawings written as PNG.

Reference: lib/vis.py (198 LoC; cv2 + matplotlib).  The API mirrors the
reference's (vis_2d_pose / vis_3d_pose / vis_2d_keypoints), but the drawing
is a small numpy rasterizer and the PNG is written with zlib and struct, so
the demo needs no imaging package: each bone a 2-pixel line in its own hue,
each joint a black 3 x 3 dot, over the image or a white canvas.  The 3-D
pose is drawn in its front view (x right, y down).
"""
from __future__ import annotations

import colorsys
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["vis_2d_pose", "vis_3d_pose", "vis_2d_keypoints", "write_png"]


def write_png(path: str, rgb: np.ndarray) -> str:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(rgb, np.uint8)
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return path


def _colors(n: int):
    return [np.array(colorsys.hsv_to_rgb(i / max(n, 1), 1.0, 1.0)) * 255 for i in range(n)]


def _dot(canvas: np.ndarray, x: float, y: float, color, r: int) -> None:
    h, w = canvas.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    canvas[max(yi - r, 0):min(yi + r + 1, h), max(xi - r, 0):min(xi + r + 1, w)] = color


def _line(canvas: np.ndarray, a, b, color) -> None:
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return
    span = max(abs(b[0] - a[0]), abs(b[1] - a[1]))
    n = int(min(span, 4 * sum(canvas.shape[:2]))) + 1
    for t in np.linspace(0.0, 1.0, n + 1):
        _dot(canvas, a[0] + t * (b[0] - a[0]), a[1] + t * (b[1] - a[1]), color, 1)


def _draw(points: np.ndarray, canvas: np.ndarray,
          skeleton: Sequence[Tuple[int, int]]) -> np.ndarray:
    for c, (a, b) in zip(_colors(len(skeleton)), skeleton):
        _line(canvas, points[a], points[b], c.astype(np.uint8))
    for p in points[np.isfinite(points).all(1)]:
        _dot(canvas, p[0], p[1], 0, 1)
    return canvas


def vis_2d_pose(pose2d: np.ndarray, img_or_shape, skeleton: Sequence[Tuple[int, int]],
                prefix: str = "pose2d", out_path: Optional[str] = None):
    """Draw a 2-D skeleton over an image array (H, W, 3) or a white canvas
    of shape img_or_shape[:2]; returns out_path once written, else the
    drawing (H, W, 3) uint8."""
    if isinstance(img_or_shape, np.ndarray) and img_or_shape.ndim == 3:
        canvas = np.array(img_or_shape[..., :3], np.uint8)
    else:
        h, w = img_or_shape[:2]
        canvas = np.full((int(h), int(w), 3), 255, np.uint8)
    _draw(np.asarray(pose2d, np.float64)[:, :2], canvas, skeleton)
    return write_png(out_path, canvas) if out_path else canvas


vis_2d_keypoints = vis_2d_pose  # reference alias (lib/vis.py:77)


def vis_3d_pose(pose3d: np.ndarray, skeleton: Sequence[Tuple[int, int]],
                prefix: str = "pose3d", out_path: Optional[str] = None, size: int = 480):
    """The 3-D skeleton's front view on a white size x size canvas, scaled
    to fit (lib/vis.py:146-198 draws it in a 3-D axis)."""
    xy = np.asarray(pose3d, np.float64)[:, :2]
    lo, hi = xy.min(0), xy.max(0)
    scale = 0.8 * size / max(float((hi - lo).max()), 1e-9)
    pts = (xy - (lo + hi) / 2) * scale + size / 2
    canvas = _draw(pts, np.full((size, size, 3), 255, np.uint8), skeleton)
    return write_png(out_path, canvas) if out_path else canvas
