"""Deterministic synthetic body models.

The real SMPL/MANO parameter files are license-gated downloads.  The stand-in
is a triangulated UV sphere with the body model's exact vertex count and
mesh statistics (average degree ~6), and LBS parameters of SMPL's exact
tensor shapes, so the compute path runs at the real shapes.  Same
construction as the JAX package's `body/synthetic.py`, drawing from the
numpy generator in the same order, so the stand-ins are equal bit for bit.
`body.loader` loads the real .pkl files when present.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .model import BodyModelParams

__all__ = ["uv_sphere", "stand_in_template", "synthetic_body_params", "SMPL_VERTS",
           "MANO_VERTS"]

SMPL_VERTS = 6890
MANO_VERTS = 778


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


def _kinematic_tree(num_joints: int, rng: np.random.Generator) -> np.ndarray:
    """Chain-with-branches parents array, parent[0] = 0 (root), depth like SMPL."""
    parents = np.zeros(num_joints, dtype=np.int64)
    for j in range(1, num_joints):
        parents[j] = rng.integers(max(0, j - 4), j)
    return parents


def synthetic_body_params(num_vertices: int = SMPL_VERTS, num_joints: int = 24,
                          num_betas: int = 10, seed: int = 0,
                          scale: float = 1.0) -> BodyModelParams:
    """Deterministic LBS parameter set over a UV-sphere mesh, of SMPL's
    shapes: v_template (V, 3), shapedirs (V, 3, B), posedirs (V, 3, 9*(J-1)),
    J_regressor (J, V), lbs_weights (V, J), parents (J,), faces (T, 3)."""
    rng = np.random.default_rng(seed)
    verts, faces = uv_sphere(num_vertices)
    V, J = num_vertices, num_joints

    v_template = verts * scale * np.array([0.3, 0.2, 0.9])  # body-ish aspect
    shapedirs = 0.03 * rng.standard_normal((V, 3, num_betas))
    posedirs = 0.001 * rng.standard_normal((V, 3, 9 * (J - 1)))

    # joints regress from localized vertex clusters along the z axis
    centers = np.linspace(verts[:, 2].min(), verts[:, 2].max(), J)
    J_regressor = np.zeros((J, V))
    for j in range(J):
        w = np.exp(-((verts[:, 2] - centers[j]) ** 2) / 0.02)
        J_regressor[j] = w / w.sum()

    joints_rest = J_regressor @ v_template
    # skinning weights: softmax over the distance to the nearest joints,
    # the top 4 per vertex kept (SMPL's sparse skinning weights)
    d2 = ((v_template[:, None, :] - joints_rest[None, :, :]) ** 2).sum(-1)
    logits = -d2 / (d2.min(axis=1, keepdims=True) + 1e-6) * 2.0
    lbs_weights = np.exp(logits)
    order = np.argsort(-lbs_weights, axis=1)
    mask = np.zeros_like(lbs_weights)
    np.put_along_axis(mask, order[:, :4], 1.0, axis=1)
    lbs_weights = lbs_weights * mask
    lbs_weights /= lbs_weights.sum(axis=1, keepdims=True)

    parents = _kinematic_tree(J, rng)

    return BodyModelParams(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=J_regressor.astype(np.float32),
        lbs_weights=lbs_weights.astype(np.float32),
        parents=parents,
        faces=faces.astype(np.int32),
    )
