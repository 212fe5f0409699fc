"""The SMPL deploy forward as the Tester serves it, ready to run.

SMPL stand-in mesh (6890 vertices), 9-level coarsening pyramid, Human3.6M
17-joint input, SMPL_BLOCKS, PoseNet hidden 4096, BatchNorm folded into the
MeshNet convs.  The weights are random, drawn from a seeded generator, with
non-identity BatchNorm statistics so the fold does real work.  flat_impl
and fused pick MeshNet's band-conv kernels (`models.meshnet`); `on_path`
gives the same artifact and weights on another path.  Used by chip_smoke.py
and tools/profile_forward.py.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict

import torch

from .body.smpl import SMPL
from .core.train import make_eval_step
from .data.joint_sets import HUMAN36
from .graphs.artifact import PyramidArtifact, pack_pyramid
from .graphs.build import build_pyramid
from .models.fold import fold_bn_variables
from .models.pose2mesh import Pose2Mesh

__all__ = ["DeployForward", "smpl_deploy_forward", "on_path", "with_random_batch_norm"]


@dataclass
class DeployForward:
    art: PyramidArtifact          # float32 operators
    art_compute: PyramidArtifact  # operators in the compute dtype
    model: Pose2Mesh
    eval_step: Callable


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


def smpl_deploy_forward(*, dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device | None = "cuda",
                        seed: int = 0, flat_impl: str = "group",
                        fused: bool = True) -> DeployForward:
    smpl = SMPL()
    pyr = build_pyramid(smpl.face, joint_num=17, skeleton=HUMAN36.skeleton,
                        flip_pairs=HUMAN36.flip_pairs, levels=9)
    art = pack_pyramid(pyr, smpl.face, device=device)
    g = torch.Generator().manual_seed(seed)
    model = Pose2Mesh(17, art.mesh_ops[-1].num_vertices, dtype=dtype,
                      flat_impl=flat_impl, fused=fused, device=device, generator=g)
    model.load_state_dict(fold_bn_variables(with_random_batch_norm(model, g)))
    return DeployForward(
        art=art, art_compute=art.to(art.vertex_gather.device, dtype), model=model,
        eval_step=make_eval_step(model, smpl.joint_regressor_h36m, device=device))


def on_path(d: DeployForward, *, flat_impl: str = "group",
            fused: bool = True) -> DeployForward:
    """`d` with MeshNet's band convs on another path: a model built for that
    path and loaded with d.model's weights, on the same artifact."""
    dev = d.art.vertex_gather.device
    model = Pose2Mesh(d.model.num_joint, d.art.mesh_ops[-1].num_vertices,
                      dtype=d.model.pose2mesh.dtype, flat_impl=flat_impl, fused=fused,
                      device=dev, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(d.model.state_dict())
    return replace(d, model=model, eval_step=make_eval_step(
        model, SMPL().joint_regressor_h36m, device=dev))
