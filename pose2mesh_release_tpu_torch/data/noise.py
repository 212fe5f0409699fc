"""Synthetic 2D-pose error models for training-input augmentation.

Two generators, mirroring the reference:

1. `synthesize_pose` — PoseFix-style per-joint error synthesis
   (lib/noise_utils.py:17-285): each COCO keypoint is replaced by one of
   {jitter, miss, inversion, swap, good} samples drawn from
   keypoint-similarity-derived annuli around the GT / flipped-pair
   locations, with state probabilities depending on visibility count and
   body part.  Re-derived with vectorized rejection sampling (the reference
   loops per candidate with N=500 trials; statistics match).

2. `H36MNoiseStats` — per-joint Gaussian detector-error model for
   Human3.6M (data/Human36M/noise_stats.py, published by AbsPoseLifter,
   arXiv:1910.12029; applied in data/Human36M/dataset.py:143-155).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = ["COCO_KPS_SIGMAS", "COCO_KPS_SYMMETRY", "synthesize_pose", "H36MNoiseStats"]

# COCO keypoint-similarity sigmas (noise_utils.py:9-11)
COCO_KPS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0
COCO_KPS_SYMMETRY = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                     (13, 14), (15, 16))

_NUM_KPS = 17


def _ks_dist(ks: float, area: float) -> np.ndarray:
    """Distance at which keypoint similarity drops to `ks` for each joint."""
    variances = (COCO_KPS_SIGMAS * 2) ** 2
    return np.sqrt(-2 * area * variances * np.log(ks))


def _pair_of(j: int) -> Optional[int]:
    for q, w in COCO_KPS_SYMMETRY:
        if j == q:
            return w
        if j == w:
            return q
    return None


def _jitter_prob(j: int, num_valid: int) -> float:
    few = num_valid <= 10
    if j == 0 or 13 <= j <= 16:
        return 0.15 if few else 0.10
    if 1 <= j <= 10:
        return 0.20 if few else 0.15
    return 0.25 if few else 0.20


def _miss_prob(j: int, num_valid: int) -> float:
    if num_valid <= 5:
        return 0.15 if j <= 4 else (0.20 if j in (5, 6, 15, 16) else 0.25)
    if num_valid <= 10:
        return 0.10 if j <= 4 else (0.13 if j in (5, 6, 15, 16) else 0.15)
    return 0.02 if j <= 4 else (0.05 if j in (5, 6, 15, 16) else 0.10)


def _inv_prob(j: int) -> float:
    return 0.01 if j <= 4 else (0.03 if j <= 10 else 0.06)


def _sample_annulus(rng, center, r_lo, r_hi, n, exclude, exclude_r=None):
    """Sample points uniformly in an annulus around `center`, rejecting
    points within `exclude_r` (or the sampled radius) of `exclude` points."""
    angle = rng.uniform(0, 2 * math.pi, n)
    r = rng.uniform(r_lo, r_hi, n)
    x = center[0] + r * np.cos(angle)
    y = center[1] + r * np.sin(angle)
    mask = np.ones(n, dtype=bool)
    for pt in exclude:
        d = np.sqrt((pt[0] - x) ** 2 + (pt[1] - y) ** 2)
        mask &= d > (r if exclude_r is None else exclude_r)
    return x[mask], y[mask]


def synthesize_pose(
    joints: np.ndarray,
    area: float,
    num_overlap: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """joints: (17, 3) COCO keypoints with validity in column 2.

    Returns a synthetic noisy pose (17, 3).  Reference semantics
    (noise_utils.py:17-285) with the reference's swap branch disabled
    exactly as upstream ships it (`swap_prob` forced to 0, :232).
    """
    rng = rng or np.random.default_rng()
    ks10, ks50, ks85 = _ks_dist(0.10, area), _ks_dist(0.50, area), _ks_dist(0.85, area)
    synth = joints.copy()
    num_valid = int(np.sum(joints[:, 2] > 0))
    N = 500

    for j in range(_NUM_KPS):
        gt = synth[j, :2]
        pair = _pair_of(j)
        pair_valid = pair is not None and joints[pair, 2] > 0
        others = [synth[pair, :2]] if pair_valid else []

        # jitter: annulus [ks85, ks50] around gt, away from the pair
        jit = np.zeros(3)
        xs, ys = _sample_annulus(rng, gt, ks85[j], ks50[j], N, others)
        if len(xs):
            i = rng.integers(len(xs))
            jit[:] = xs[i], ys[i], 1

        # miss: annulus [ks50, ks10] around gt or the pair
        miss = np.zeros(3)
        centers = [(gt, 1.0)] + [(synth[pair, :2], 0.25)] if pair_valid else [(gt, 1.0)]
        pts = []
        for center, keep in centers:
            excl = [c for c, _ in centers if c is not center]
            xs, ys = _sample_annulus(rng, center, ks50[j], ks10[j], 4 * N,
                                     excl, exclude_r=ks50[j])
            if len(xs) and keep < 1.0:
                sel = rng.choice(len(xs), size=len(xs) // 4)
                xs, ys = xs[sel], ys[sel]
            if len(xs):
                pts.append(np.stack([xs, ys], axis=1))
        if pts:
            pts = np.concatenate(pts)
            i = rng.integers(len(pts))
            miss[:] = pts[i, 0], pts[i, 1], 1

        # inversion: disc [0, ks50] around the flipped pair
        inv = np.zeros(3)
        if pair_valid:
            xs, ys = _sample_annulus(rng, synth[pair, :2], 0, ks50[j], N, [gt])
            if len(xs):
                i = rng.integers(len(xs))
                inv[:] = xs[i], ys[i], 1

        # good: disc [0, ks85] around gt
        good = np.zeros(3)
        xs, ys = _sample_annulus(rng, gt, 0, ks85[j], N // 4, others)
        if len(xs):
            i = rng.integers(len(xs))
            good[:] = xs[i], ys[i], 1

        p_jit = _jitter_prob(j, num_valid) if jit[2] else 0.0
        p_miss = _miss_prob(j, num_valid) if miss[2] else 0.0
        p_inv = (_inv_prob(j) if pair_valid else 0.0) if inv[2] else 0.0
        p_good = max(1 - (_jitter_prob(j, num_valid) + _miss_prob(j, num_valid)
                          + (_inv_prob(j) if pair_valid else 0.0)), 0.0)
        p_good = p_good if good[2] else 0.0

        z = p_jit + p_miss + p_inv + p_good
        if z == 0:
            synth[j] = 0
            continue
        probs = np.array([p_jit, p_miss, p_inv, p_good]) / z
        choice = rng.choice(4, p=probs)
        synth[j] = (jit, miss, inv, good)[choice]
    return synth


# Per-joint detector-error Gaussians on Human3.6M, published by
# AbsPoseLifter (arXiv:1910.12029); joint order matches the reference's
# H36M joint set (data/Human36M/noise_stats.py:5-123).
H36M_ERROR_DISTRIBUTION = (
    ("Pelvis", (-0.06, -2.37), (1.33, 2.13), 1.00),
    ("R_Hip", (-0.83, -2.07), (3.41, 2.69), 1.00),
    ("R_Knee", (-0.04, -1.01), (1.74, 2.20), 0.95),
    ("R_Ankle", (0.52, -3.40), (1.39, 2.14), 0.93),
    ("L_Hip", (0.78, -2.79), (3.26, 2.28), 1.00),
    ("L_Knee", (0.42, -0.15), (1.53, 1.99), 0.94),
    ("L_Ankle", (-0.15, -3.78), (1.39, 2.39), 0.93),
    ("Torso", (-0.05, 0.10), (1.36, 1.74), 0.99),
    ("Neck", (0.14, -2.56), (1.18, 1.15), 0.99),
    ("Head", (0.09, 0.49), (1.35, 0.87), 0.99),
    ("Nose", (0.13, -0.26), (0.78, 0.59), 0.98),
    ("L_Shoulder", (-0.19, 0.31), (2.51, 1.48), 0.99),
    ("L_Elbow", (0.11, -0.60), (1.79, 1.76), 0.95),
    ("L_Wrist", (-0.02, 0.88), (2.02, 2.10), 0.91),
    ("R_Shoulder", (0.52, -0.12), (2.23, 1.73), 0.99),
    ("R_Elbow", (0.06, -0.44), (1.93, 1.63), 0.95),
    ("R_Wrist", (0.05, 0.16), (2.02, 2.24), 0.90),
)


class H36MNoiseStats:
    """Sampler for H36M detector noise (Human36M/dataset.py:143-155):
    per-joint Gaussian offsets gated by a per-joint keep probability."""

    def __init__(self, joint_names: Sequence[str]):
        table = {name: (mean, std, w) for name, mean, std, w in H36M_ERROR_DISTRIBUTION}
        self.mean = np.array([table[n][0] for n in joint_names], np.float32)
        self.std = np.array([table[n][1] for n in joint_names], np.float32)
        self.weight = np.array([table[n][2] for n in joint_names], np.float32)

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        noise = rng.normal(self.mean, self.std).astype(np.float32)
        keep = self.weight > rng.uniform(size=len(self.weight))
        return noise * keep[:, None]
