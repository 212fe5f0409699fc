"""Small IO helpers: .obj mesh dump (lib/funcs_utils.py:52-58)."""
from __future__ import annotations

import numpy as np

__all__ = ["save_obj"]


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Write a Wavefront .obj (1-indexed faces)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for face in np.asarray(faces):
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")
