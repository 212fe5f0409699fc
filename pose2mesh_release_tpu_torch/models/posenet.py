"""PoseNet: the 2D->3D pose lifting MLP.

A 4096-wide MLP with two pre-activation residual stages (BN -> ReLU ->
Dropout -> Linear, twice per stage), input the flattened 2D pose (J*2),
output the root-relative 3D pose (J*3) in millimeters.  Parameter names
follow the reference's torch state dict (`w1`, `linear_stages.N.{w1,
batch_norm1, w2, batch_norm2}`, `w2`).  Parameters stay float32 and are cast
to the compute dtype at use.

BatchNorm runs in float32 and casts back: at eval from its running
statistics; in training from the batch's (mean, biased variance E[x^2] -
E[x]^2 clamped at 0, as flax computes them), which also move the running
statistics with momentum 0.1 (flax's 0.9), storing the biased variance as
flax does.  Dropout is the identity at eval; in training its keep mask is
drawn from the `torch.Generator` the caller passes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["PoseNet", "batch_norm", "bn_affine", "dropout", "linear"]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def bn_affine(bn: nn.BatchNorm1d, sums: Tuple[torch.Tensor, torch.Tensor], n: int,
              train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (scale, shift) with bn(y) = y*scale + shift.  In training
    the statistics come from the float32 sums (sum y, sum y^2) over n rows and
    move the running statistics; at eval the running ones are used."""
    if train:
        mean = sums[0] / n
        var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
            bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return scale, bn.bias - mean * scale


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, train: bool) -> torch.Tensor:
    """BatchNorm over the rows of x (B, C), in float32, cast back."""
    xf = x.float()
    if not train:
        y = F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return y.to(x.dtype)
    scale, shift = bn_affine(bn, (xf.sum(0), (xf * xf).sum(0)), xf.shape[0], True)
    return (xf * scale + shift).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training dropout needs a torch.Generator")
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate,
                                                            generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class ResidualStage(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.batch_norm1 = nn.BatchNorm1d(hidden, eps=1e-5)
        self.w1 = nn.Linear(hidden, hidden)
        self.batch_norm2 = nn.BatchNorm1d(hidden, eps=1e-5)
        self.w2 = nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, dtype: torch.dtype, train: bool = False,
                rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def pre(v, bn):
            v = torch.relu(batch_norm(v, bn, train))
            return dropout(v, rate, generator) if train else v
        y = linear(pre(x, self.batch_norm1), self.w1, dtype)
        y = linear(pre(y, self.batch_norm2), self.w2, dtype)
        return x + y


class PoseNet(nn.Module):
    """2D joints (B, J*2) -> 3D joints (B, J*3) float32, mm.  `dropout` is the
    training dropout rate (the reference's 0.5)."""

    def __init__(self, num_joint: int, hidden: int = 4096, num_stages: int = 2,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.5):
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.w1 = nn.Linear(num_joint * 2, hidden)
        self.linear_stages = nn.ModuleList(
            ResidualStage(hidden) for _ in range(num_stages))
        self.w2 = nn.Linear(hidden, num_joint * 3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Linears uniform(+-1/sqrt(fan_in)) (torch's default bounds) drawn
        from `generator` (a CPU one); BatchNorm identity with unit running
        variance."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.weight.shape[1])
                for p in (m.weight, m.bias):
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()

    def forward(self, x2d: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = linear(x2d.reshape(x2d.shape[0], -1), self.w1, self.dtype)
        for stage in self.linear_stages:
            y = stage(y, self.dtype, train, self.dropout, generator)
        return linear(y, self.w2, self.dtype).float()
