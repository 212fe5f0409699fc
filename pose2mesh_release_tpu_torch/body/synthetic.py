"""Deterministic synthetic body mesh.

The real SMPL/MANO parameter files are license-gated downloads.  The stand-in
is a triangulated UV sphere with the body model's exact vertex count and
mesh statistics (average degree ~6), so the compute path runs at the real
shapes.  Same construction as the JAX package's `body/synthetic.py`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["uv_sphere", "stand_in_template", "SMPL_VERTS"]

SMPL_VERTS = 6890


def stand_in_template(num_vertices: int = SMPL_VERTS) -> np.ndarray:
    """(V, 3) float32 rest mesh of the stand-in body: the UV sphere stretched
    to a body-like aspect (the JAX package's `synthetic_body_params`
    v_template)."""
    verts, _ = uv_sphere(num_vertices)
    return (verts * np.array([0.3, 0.2, 0.9])).astype(np.float32)


def uv_sphere(num_vertices: int) -> Tuple[np.ndarray, np.ndarray]:
    """Triangulated UV sphere with exactly `num_vertices` vertices.

    Vertices: 2 poles + rings*segments, so we factor num_vertices-2 into
    rings*segments with aspect close to square.  Returns (verts (V,3) f64,
    faces (T,3) i64).  Average vertex degree ~6, matching a body mesh.
    """
    interior = num_vertices - 2
    best = None
    for rings in range(2, interior + 1):
        if interior % rings:
            continue
        segs = interior // rings
        if segs < 3:
            break
        score = abs(np.log(rings / segs))
        if best is None or score < best[0]:
            best = (score, rings, segs)
    if best is None:
        raise ValueError(f"cannot factor {interior} into rings*segments")
    _, rings, segs = best

    verts = [np.array([0.0, 0.0, 1.0])]
    for r in range(rings):
        phi = np.pi * (r + 1) / (rings + 1)
        for s in range(segs):
            theta = 2 * np.pi * s / segs
            verts.append(
                np.array(
                    [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)]
                )
            )
    verts.append(np.array([0.0, 0.0, -1.0]))
    verts = np.stack(verts)

    faces = []
    def vid(r, s):  # ring r in [0, rings), segment s (wraps)
        return 1 + r * segs + (s % segs)
    for s in range(segs):  # top cap
        faces.append([0, vid(0, s), vid(0, s + 1)])
    for r in range(rings - 1):
        for s in range(segs):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            faces.append([a, c, b])
            faces.append([b, c, d])
    bottom = len(verts) - 1
    for s in range(segs):  # bottom cap
        faces.append([bottom, vid(rings - 1, s + 1), vid(rings - 1, s)])
    return verts, np.asarray(faces, dtype=np.int64)
