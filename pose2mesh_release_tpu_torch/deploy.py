"""The deploy forward as the Tester serves it, ready to run, for the SMPL
body and the MANO hand.

SMPL: stand-in mesh (6890 vertices), 9-level coarsening pyramid, Human3.6M
17-joint input, SMPL_BLOCKS.  MANO: stand-in hand (778 vertices), 6 levels
(one band level of 778 rows, padded to 1024), the 21-joint MANO input,
MANO_BLOCKS.  Both: levels above 768 vertices banded (`dense_threshold`
768, as the JAX package's `pack_pyramid` and config), PoseNet hidden 4096,
BatchNorm folded into the MeshNet convs.  The weights are random, drawn
from a seeded generator, with non-identity BatchNorm statistics so the
fold does real work.  flat_impl and fused pick MeshNet's band-conv kernels
(`models.meshnet`); `on_path` gives the same artifact, weights and mesh
on another path.  Used by chip_smoke.py and tools/profile_forward.py.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict

import numpy as np
import torch

from .body.mano import MANO
from .body.smpl import SMPL
from .core.train import make_eval_step
from .data.joint_sets import HUMAN36, MANO_SET, JointSet
from .device import resolve_device
from .graphs.artifact import PyramidArtifact, pack_pyramid
from .graphs.build import build_pyramid
from .models.fold import fold_bn_variables
from .models.pose2mesh import Pose2Mesh

__all__ = ["DeployForward", "smpl_deploy_forward", "mano_deploy_forward", "on_path",
           "deploy_forward_on", "with_random_batch_norm", "build_artifact"]

DENSE_THRESHOLD = 768
POSENET_HIDDEN = 4096


@dataclass
class DeployForward:
    art: PyramidArtifact          # float32 operators
    art_compute: PyramidArtifact  # operators in the compute dtype
    model: Pose2Mesh
    eval_step: Callable           # on one CUDA device a replayed CUDA graph (core/train.py)
    j_regressor: np.ndarray       # (J, V) regressor of the eval step's joints


def build_artifact(face: np.ndarray, joints: JointSet, levels: int,
                   device: torch.device) -> PyramidArtifact:
    """The coarsening pyramid of `face` and the joint graph of `joints`,
    packed at dense_threshold 768."""
    pyr = build_pyramid(face, joint_num=joints.joint_num, skeleton=joints.skeleton,
                        flip_pairs=joints.flip_pairs, levels=levels,
                        extra_joint_edges=joints.extra_edges)
    return pack_pyramid(pyr, face, dense_threshold=DENSE_THRESHOLD, device=device)


def with_random_batch_norm(model: Pose2Mesh, generator: torch.Generator
                           ) -> Dict[str, torch.Tensor]:
    """The model's state dict plus a BatchNorm (`pose2mesh.bn.K.*`, the
    reference's layout) with random affine and running statistics for every
    MeshNet conv but the last, as an unfolded checkpoint carries them."""
    sd = model.state_dict()
    convs = model.pose2mesh.cl
    for k in range(len(convs) - 1):
        n = convs[k].out_features
        bn = {"weight": torch.rand(n, generator=generator) + 0.5,
              "bias": torch.randn(n, generator=generator) * 0.1,
              "running_mean": torch.randn(n, generator=generator) * 0.1,
              "running_var": torch.rand(n, generator=generator) + 0.5}
        dev = convs[k].weight.device
        sd.update({f"pose2mesh.bn.{k}.{key}": v.to(dev) for key, v in bn.items()})
    return sd


def deploy_forward_on(art: PyramidArtifact, j_regressor: np.ndarray, *, mano: bool = False,
                      dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device | None = "cuda", seed: int = 0,
                      flat_impl: str = "group", fused: bool = True) -> DeployForward:
    """The deploy forward on a packed artifact (float32, moved to `device`):
    the cascade for art.joint_num input joints with seeded random weights
    and BatchNorm folded; its eval step regresses `j_regressor`'s joints.
    The datasets' graph (`data.base.pyramid_for`) runs through this."""
    dev = resolve_device(device)
    art = art.to(dev)
    g = torch.Generator().manual_seed(seed)
    model = Pose2Mesh(art.joint_num, art.mesh_ops[-1].num_vertices, mano=mano,
                      posenet_hidden=POSENET_HIDDEN, dtype=dtype, flat_impl=flat_impl,
                      fused=fused, device=dev, generator=g)
    model.load_state_dict(fold_bn_variables(with_random_batch_norm(model, g)))
    return DeployForward(
        art=art, art_compute=art.to(dev, dtype), model=model,
        eval_step=make_eval_step(model, j_regressor, device=dev),
        j_regressor=j_regressor)


def smpl_deploy_forward(*, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = "cuda",
                        seed: int = 0, flat_impl: str = "group",
                        fused: bool = True) -> DeployForward:
    """The SMPL deploy forward; its eval step regresses the 17 H36M joints."""
    dev = resolve_device(device)
    smpl = SMPL()
    return deploy_forward_on(build_artifact(smpl.face, HUMAN36, 9, dev),
                             smpl.joint_regressor_h36m, dtype=dtype, device=dev,
                             seed=seed, flat_impl=flat_impl, fused=fused)


def mano_deploy_forward(*, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = "cuda",
                        seed: int = 0, flat_impl: str = "group",
                        fused: bool = True) -> DeployForward:
    """The MANO deploy forward; its eval step regresses the 21 MANO joints."""
    dev = resolve_device(device)
    mano = MANO()
    return deploy_forward_on(build_artifact(mano.face, MANO_SET, 6, dev),
                             mano.joint_regressor_mano, mano=True, dtype=dtype, device=dev,
                             seed=seed, flat_impl=flat_impl, fused=fused)


def on_path(d: DeployForward, *, flat_impl: str = "group",
            fused: bool = True) -> DeployForward:
    """`d` with MeshNet's band convs on another path: a model built for that
    path and loaded with d.model's weights, on the same artifact and mesh."""
    dev = d.art.vertex_gather.device
    model = Pose2Mesh(d.model.num_joint, d.art.mesh_ops[-1].num_vertices,
                      blocks=d.model.pose2mesh.blocks,
                      posenet_hidden=d.model.pose_lifter.w1.out_features,
                      dtype=d.model.pose2mesh.dtype, flat_impl=flat_impl, fused=fused,
                      device=dev, generator=torch.Generator().manual_seed(0),
                      mesh=d.model.mesh)
    model.load_state_dict(d.model.state_dict())
    return replace(d, model=model, eval_step=make_eval_step(
        model, d.j_regressor, device=dev, mesh=d.model.mesh))
