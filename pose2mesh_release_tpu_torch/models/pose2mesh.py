"""The Pose2Mesh cascade: PoseNet -> (detach) -> MeshNet.

The lifted 3D pose is detached and rescaled from millimeters to meters
before being concatenated with the 2D pose as MeshNet input.  With
`inference_fused=True` (the default) MeshNet is the deploy form, BatchNorm
folded into its convs (load a state dict passed through
`models.fold.fold_bn_variables`), and the cascade only evaluates; with
`inference_fused=False` it is the training form and `forward(..., train=True,
generator=g)` runs the training forward (batch statistics, dropout drawn
from g).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..device import resolve_device
from ..graphs.artifact import PyramidArtifact
from .meshnet import MANO_BLOCKS, SMPL_BLOCKS, MeshNet
from .posenet import PoseNet

__all__ = ["Pose2Mesh"]


class Pose2Mesh(nn.Module):
    """pose2d (B, J, 2) -> (mesh (B, V, 3) meters in device vertex order,
    pose3d (B, J, 3) mm).

    coarse_vertices: art.mesh_ops[-1].num_vertices (the FC output rows).
    dropout: PoseNet's training dropout rate.
    generator: seeds the parameter init (a fixed seed when None)."""

    def __init__(self, num_joint: int, coarse_vertices: int, *, mano: bool = False,
                 posenet_hidden: int = 4096,
                 blocks: Optional[Sequence[Sequence[int]]] = None,
                 dtype: torch.dtype = torch.float32,
                 inference_fused: bool = True, dropout: float = 0.5,
                 device: str | torch.device | None = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_joint = num_joint
        self.pose_lifter = PoseNet(num_joint, hidden=posenet_hidden, dtype=dtype,
                                   dropout=dropout)
        self.pose2mesh = MeshNet(
            num_joint, coarse_vertices,
            blocks=blocks or (MANO_BLOCKS if mano else SMPL_BLOCKS), dtype=dtype,
            inference_fused=inference_fused)
        self.reset_parameters(generator)
        self.to(dev)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Graph convs: uniform(-s, s), s = sqrt(2 / (fan_in + fan_out)), zero
        bias (the reference's init); other Linears: uniform(+-1/sqrt(fan_in));
        BatchNorm: identity with unit running variance."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)

        def fill(p, bound):
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=generator))
        convs = set(self.pose2mesh.cl)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fout, fin = m.weight.shape
                if m in convs:
                    fill(m.weight, math.sqrt(2.0 / (fin + fout)))
                    m.bias.zero_()
                else:
                    fill(m.weight, 1.0 / math.sqrt(fin))
                    fill(m.bias, 1.0 / math.sqrt(fin))
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, art: PyramidArtifact, pose2d: torch.Tensor,
                train: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        B = pose2d.shape[0]
        pose3d = self.pose_lifter(pose2d.reshape(B, -1), train, generator)
        pose3d = pose3d.reshape(B, self.num_joint, 3)
        combine = torch.cat([pose2d.float(), pose3d.detach() / 1000.0], dim=2)
        mesh = self.pose2mesh(art, combine, train)
        return mesh, pose3d
