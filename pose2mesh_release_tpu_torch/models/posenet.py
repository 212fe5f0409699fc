"""PoseNet: the 2D->3D pose lifting MLP (eval mode).

A 4096-wide MLP with two pre-activation residual stages (BN -> ReLU ->
Dropout -> Linear, twice per stage), input the flattened 2D pose (J*2),
output the root-relative 3D pose (J*3) in millimeters.  Parameter names
follow the reference's torch state dict (`w1`, `linear_stages.N.{w1,
batch_norm1, w2, batch_norm2}`, `w2`).  Dropout is the identity at eval;
BatchNorm uses its running statistics in float32.  Parameters stay float32
and are cast to the compute dtype at use.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["PoseNet", "eval_batch_norm", "linear"]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def eval_batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Running-statistics BatchNorm computed in float32, cast back to x's
    dtype."""
    y = F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                     bn.bias, training=False, eps=bn.eps)
    return y.to(x.dtype)


class ResidualStage(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.batch_norm1 = nn.BatchNorm1d(hidden, eps=1e-5)
        self.w1 = nn.Linear(hidden, hidden)
        self.batch_norm2 = nn.BatchNorm1d(hidden, eps=1e-5)
        self.w2 = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = linear(torch.relu(eval_batch_norm(x, self.batch_norm1)), self.w1, dtype)
        y = linear(torch.relu(eval_batch_norm(y, self.batch_norm2)), self.w2, dtype)
        return x + y


class PoseNet(nn.Module):
    """2D joints (B, J*2) -> 3D joints (B, J*3) float32, mm."""

    def __init__(self, num_joint: int, hidden: int = 4096, num_stages: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w1 = nn.Linear(num_joint * 2, hidden)
        self.linear_stages = nn.ModuleList(
            ResidualStage(hidden) for _ in range(num_stages))
        self.w2 = nn.Linear(hidden, num_joint * 3)

    def forward(self, x2d: torch.Tensor) -> torch.Tensor:
        y = linear(x2d.reshape(x2d.shape[0], -1), self.w1, self.dtype)
        for stage in self.linear_stages:
            y = stage(y, self.dtype)
        return linear(y, self.w2, self.dtype).float()
