"""OneEuro temporal filter for per-video pose sequences.

Reference: lib/smooth_utils.py:14-71 (used by the 3DPW smoothed-eval path,
data/PW3D/dataset.py:383-417).  Vectorized over all joint coordinates at
once: state is the (J*3,) previous sample instead of one Python object per
scalar channel.
"""
from __future__ import annotations

import numpy as np

__all__ = ["OneEuroFilter", "smooth_pose"]


def _smoothing_factor(t_e: np.ndarray, cutoff) -> np.ndarray:
    r = 2 * np.pi * cutoff * t_e
    return r / (r + 1)


def _ema(alpha: np.ndarray, x: np.ndarray, x_prev: np.ndarray) -> np.ndarray:
    return alpha * x + (1 - alpha) * x_prev


class OneEuroFilter:
    """Adaptive low-pass: cutoff rises with signal speed
    (smooth_utils.py:14-46), applied elementwise to an array signal."""

    def __init__(self, t0: float, x0: np.ndarray, dx0: float = 0.0,
                 min_cutoff: float = 1.0, beta: float = 0.0,
                 d_cutoff: float = 1.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.x_prev = np.asarray(x0, dtype=np.float64)
        self.dx_prev = np.full_like(self.x_prev, float(dx0))
        self.t_prev = float(t0)

    def __call__(self, t: float, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        t_e = t - self.t_prev
        a_d = _smoothing_factor(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = _ema(a_d, dx, self.dx_prev)
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _smoothing_factor(t_e, cutoff)
        x_hat = _ema(a, x, self.x_prev)
        self.x_prev, self.dx_prev, self.t_prev = x_hat, dx_hat, float(t)
        return x_hat


def smooth_pose(pose: np.ndarray, min_cutoff: float = 0.004,
                beta: float = 0.7) -> np.ndarray:
    """Filter a pose sequence (T, J, 3) frame by frame
    (smooth_utils.py:49-71)."""
    pose = np.asarray(pose)
    out = np.empty_like(pose, dtype=np.float64)
    out[0] = pose[0]
    filt = OneEuroFilter(0.0, pose[0].reshape(-1),
                         min_cutoff=min_cutoff, beta=beta)
    for i in range(1, len(pose)):
        out[i] = filt(float(i), pose[i].reshape(-1)).reshape(pose[i].shape)
    return out.astype(pose.dtype)
