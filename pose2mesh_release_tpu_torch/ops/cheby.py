"""Chebyshev polynomial basis over a graph Laplacian.

x0 = x, x1 = L x0, x_k = 2 L x_{k-1} - x_{k-2}, stacked fin-major
(feature index = fin * K + k) so the reference's weights apply unpermuted.
"""
from __future__ import annotations

import torch

from ..graphs.artifact import LevelOperator
from .spmm import spmm

__all__ = ["chebyshev_stack"]


def chebyshev_stack(op: LevelOperator, x: torch.Tensor, K: int) -> torch.Tensor:
    """x: (V, ..., Fin) vertex-major -> (V, ..., Fin*K) basis features."""
    xs = [x]
    if K > 1:
        xs.append(spmm(op, x))
    for _ in range(2, K):
        xs.append(2.0 * spmm(op, xs[-1]) - xs[-2])
    stacked = torch.stack(xs, dim=-1)  # (V, ..., Fin, K)
    return stacked.reshape(x.shape[:-1] + (x.shape[-1] * K,))
