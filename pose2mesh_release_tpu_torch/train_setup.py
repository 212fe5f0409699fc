"""The training step as `Trainer` runs it, ready to run on a synthetic
batch, for the SMPL body and the MANO hand.

Both: the deploy forward's artifact (`deploy.build_artifact`), PoseNet
hidden 4096, float32 parameters computing in `dtype`, RMSprop, random
weights from a seeded generator.

SMPL: stand-in mesh (6890 vertices), 9 levels, Human3.6M 17-joint input,
SMPL_BLOCKS.  The batch is built from numpy as the JAX package's
benchmarks/profile_train.py builds it: the stand-in rest mesh plus
N(0, 0.005) noise as the mesh target and a random row-normalized (17, V)
regressor.
MANO: stand-in hand (778 vertices), 6 levels, 21-joint input, MANO_BLOCKS.
The mesh target is synthesised by LBS on `device`: seeded numpy MANO poses
N(0, 0.2^2) and shapes N(0, 1) (`mano_gt_inputs`) through
`posed_mesh_rotated` (identity rotation, t = (0, 0, 500) mm), made
root-relative (the wrist of `joint_regressor_mano`) and in metres; the
regressor is `joint_regressor_mano`.
From the mesh target both follow one numpy recipe (`batch_from_mesh`): the
regressor's joints x 1000 as the 3D pose targets, their x/y / 500 as the
2D input, all-ones validity masks.  Used by chip_smoke.py and
tools/profile_train.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .body.mano import MANO
from .body.smpl import SMPL
from .core.optim import make_preconditioner
from .core.train import TrainState, make_train_step
from .data.gt_synth import posed_mesh_rotated, regress_joints
from .data.joint_sets import HUMAN36, MANO_SET
from .deploy import POSENET_HIDDEN, build_artifact
from .device import resolve_device
from .graphs.artifact import PyramidArtifact
from .models.pose2mesh import Pose2Mesh

__all__ = ["TrainSetup", "smpl_train_setup", "mano_train_setup", "train_setup_on",
           "train_batch", "synthetic_batch", "batch_from_mesh", "mano_gt_inputs"]

MANO_CAMERA_Z_MM = 500.0


@dataclass
class TrainSetup:
    art_compute: PyramidArtifact  # operators in the compute dtype
    state: TrainState
    train_step: Callable
    batch: Dict[str, torch.Tensor]
    j_regressor: np.ndarray
    generator: torch.Generator    # dropout noise


def batch_from_mesh(mesh: np.ndarray, j_reg: np.ndarray) -> Dict[str, np.ndarray]:
    """The training batch of a mesh target (B, V, 3) metres, as numpy: the
    joints j_reg @ mesh x 1000 (mm) as both 3D pose targets, their x/y / 500
    as the 2D input, all-ones validity masks."""
    B, V, J = mesh.shape[0], mesh.shape[1], j_reg.shape[0]
    pose = np.einsum("jv,bvc->bjc", j_reg, mesh) * 1000.0
    ones = lambda n: np.ones((B, n, 3), np.float32)  # noqa: E731
    return {"pose2d": (pose[..., :2] / 500.0).astype(np.float32), "mesh": mesh,
            "mesh_valid": ones(V), "reg_pose3d": pose.astype(np.float32),
            "reg_pose3d_valid": ones(J), "lift_pose3d": pose.astype(np.float32),
            "lift_pose3d_valid": ones(J)}


def synthetic_batch(template: np.ndarray, batch: int, j_reg: np.ndarray,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The training batch of benchmarks/profile_train.py, as numpy."""
    V = template.shape[0]
    mesh = template[None] + rng.standard_normal((batch, V, 3)).astype(np.float32) * 0.005
    return batch_from_mesh(mesh, j_reg)


def mano_gt_inputs(batch: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(pose (B, 48) ~ N(0, 0.2^2), shape (B, 10) ~ N(0, 1)), float32."""
    pose = (rng.standard_normal((batch, 48)) * 0.2).astype(np.float32)
    shape = rng.standard_normal((batch, 10)).astype(np.float32)
    return pose, shape


def _mano_gt_mesh(mano: MANO, pose: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
    """The MANO mesh target on pose's device: LBS through
    `posed_mesh_rotated` (identity rotation, t = (0, 0, 500) mm), minus the
    wrist of `joint_regressor_mano`, in metres (B, 778, 3)."""
    dev = pose.device
    B = pose.shape[0]
    R = torch.eye(3, device=dev).expand(B, 3, 3)
    t = torch.tensor([0.0, 0.0, MANO_CAMERA_Z_MM], device=dev).expand(B, 3)
    mesh_mm, _ = posed_mesh_rotated(mano.params.to(dev), pose, shape, R, t)
    jreg = torch.as_tensor(mano.joint_regressor_mano, device=dev)
    root = regress_joints(jreg, mesh_mm)[:, :1]
    return (mesh_mm - root) / 1000.0


def train_batch(inputs: Dict, targets: Dict, meta: Dict) -> Dict:
    """A loader's (inputs, targets, meta) as the train step's batch (the
    keys `Trainer` feeds it, core/engine.py:225-231 of the JAX package)."""
    return {"pose2d": inputs["pose2d"], "mesh": targets["mesh"],
            "lift_pose3d": targets["lift_pose3d"], "reg_pose3d": targets["reg_pose3d"],
            **meta}


def train_setup_on(art: PyramidArtifact, j_reg: np.ndarray, batch: Dict, *,
                   mano: bool = False, dtype: torch.dtype = torch.bfloat16,
                   device: str | torch.device | None = "cuda",
                   seed: int = 0) -> TrainSetup:
    """The train step on a packed artifact (float32, moved to `device` and
    cast to `dtype`) with seeded random weights; `batch` (numpy arrays or
    tensors) is moved to `device`.  The datasets' graph
    (`data.base.pyramid_for`) runs through this."""
    dev = resolve_device(device)
    art = art.to(dev)
    model = Pose2Mesh(art.joint_num, art.mesh_ops[-1].num_vertices, mano=mano,
                      posenet_hidden=POSENET_HIDDEN, dtype=dtype, inference_fused=False,
                      device=dev, generator=torch.Generator().manual_seed(seed))
    optimizer = make_preconditioner("rmsprop", model.parameters())
    return TrainSetup(
        art_compute=art.to(dev, dtype),
        state=TrainState(model, optimizer),
        train_step=make_train_step(model, optimizer, j_reg, device=dev),
        batch={k: torch.as_tensor(v).to(dev) for k, v in batch.items()},
        j_regressor=j_reg,
        generator=torch.Generator(device=dev).manual_seed(seed))


def smpl_train_setup(*, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device | None = "cuda", seed: int = 0,
                     batch: int = 64) -> TrainSetup:
    dev = resolve_device(device)
    smpl = SMPL()
    art = build_artifact(smpl.face, HUMAN36, 9, dev)
    rng = np.random.default_rng(seed)
    j_reg = rng.random((17, art.num_vertices)).astype(np.float32)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    return train_setup_on(art, j_reg, synthetic_batch(smpl.v_template, batch, j_reg, rng),
                          dtype=dtype, device=dev, seed=seed)


def mano_train_setup(*, dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device | None = "cuda", seed: int = 0,
                     batch: int = 64) -> TrainSetup:
    dev = resolve_device(device)
    mano = MANO()
    art = build_artifact(mano.face, MANO_SET, 6, dev)
    pose, shape = mano_gt_inputs(batch, np.random.default_rng(seed))
    with torch.no_grad():
        mesh = _mano_gt_mesh(mano, torch.from_numpy(pose).to(dev),
                            torch.from_numpy(shape).to(dev))
    data = batch_from_mesh(mesh.cpu().numpy(), mano.joint_regressor_mano)
    return train_setup_on(art, mano.joint_regressor_mano, data, mano=True, dtype=dtype,
                          device=dev, seed=seed)
