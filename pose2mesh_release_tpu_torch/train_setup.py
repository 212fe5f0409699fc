"""The SMPL training step as `Trainer` runs it, ready to run on a synthetic
batch.

SMPL stand-in mesh (6890 vertices), 9-level coarsening pyramid, Human3.6M
17-joint input, SMPL_BLOCKS, PoseNet hidden 4096, float32 parameters
computing in `dtype`, RMSprop, random weights from a seeded generator.  The
batch is built from numpy as the JAX package's benchmarks/profile_train.py
builds it: the stand-in rest mesh plus N(0, 0.005) noise as the mesh target,
a random row-normalized (17, V) regressor, its joints x 1000 as the 3D pose
targets, their x/y / 500 as the 2D input, all-ones validity masks.  Used by
chip_smoke.py and tools/profile_train.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from .body.smpl import SMPL
from .core.optim import make_preconditioner
from .core.train import TrainState, make_train_step
from .data.joint_sets import HUMAN36
from .device import resolve_device
from .graphs.artifact import PyramidArtifact, pack_pyramid
from .graphs.build import build_pyramid
from .models.pose2mesh import Pose2Mesh

__all__ = ["TrainSetup", "smpl_train_setup", "synthetic_batch"]


@dataclass
class TrainSetup:
    art_compute: PyramidArtifact  # operators in the compute dtype
    state: TrainState
    train_step: Callable
    batch: Dict[str, torch.Tensor]
    j_regressor: np.ndarray
    generator: torch.Generator    # dropout noise


def synthetic_batch(template: np.ndarray, batch: int, j_reg: np.ndarray,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The training batch of benchmarks/profile_train.py, as numpy."""
    V, J = template.shape[0], j_reg.shape[0]
    mesh = template[None] + rng.standard_normal((batch, V, 3)).astype(np.float32) * 0.005
    pose = np.einsum("jv,bvc->bjc", j_reg, mesh) * 1000.0
    ones = lambda n: np.ones((batch, n, 3), np.float32)  # noqa: E731
    return {"pose2d": (pose[..., :2] / 500.0).astype(np.float32), "mesh": mesh,
            "mesh_valid": ones(V), "reg_pose3d": pose.astype(np.float32),
            "reg_pose3d_valid": ones(J), "lift_pose3d": pose.astype(np.float32),
            "lift_pose3d_valid": ones(J)}


def smpl_train_setup(*, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device | None = "cuda", seed: int = 0,
                     batch: int = 64) -> TrainSetup:
    dev = resolve_device(device)
    smpl = SMPL()
    pyr = build_pyramid(smpl.face, joint_num=17, skeleton=HUMAN36.skeleton,
                        flip_pairs=HUMAN36.flip_pairs, levels=9)
    art = pack_pyramid(pyr, smpl.face, device=dev)
    model = Pose2Mesh(17, art.mesh_ops[-1].num_vertices, dtype=dtype,
                      inference_fused=False, device=dev,
                      generator=torch.Generator().manual_seed(seed))
    optimizer = make_preconditioner("rmsprop", model.parameters())
    rng = np.random.default_rng(seed)
    j_reg = rng.random((17, art.num_vertices)).astype(np.float32)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    data = synthetic_batch(smpl.v_template, batch, j_reg, rng)
    return TrainSetup(
        art_compute=art.to(dev, dtype),
        state=TrainState(model, optimizer),
        train_step=make_train_step(model, optimizer, j_reg, device=dev),
        batch={k: torch.from_numpy(v).to(dev) for k, v in data.items()},
        j_regressor=j_reg,
        generator=torch.Generator(device=dev).manual_seed(seed))
