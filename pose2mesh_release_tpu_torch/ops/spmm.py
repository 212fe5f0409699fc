"""Laplacian SpMM over the packed level layouts (plain PyTorch).

All functions are vertex-major: x is (V, ...) and the vertex axis is
contracted; trailing axes are flattened into columns.  Products accumulate
in float32 and round once to x's dtype, the same contract as the JAX
package's `ops/spmm.py` and the fused kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graphs.artifact import LevelOperator

__all__ = ["spmm", "spmm_dense", "spmm_band", "band_hop"]


def spmm_dense(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    x2 = x.reshape(x.shape[0], -1)
    y = op.dense.to(x.dtype).float() @ x2.float()
    return y.to(x.dtype).reshape(x.shape)


def band_hop(band_val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L @ x in float32 for x of nt*T rows: y[t] = sum_d band[d, t] @
    x[t + d - k], with out-of-range neighbour tiles taken as zero."""
    nbd, nt, T, _ = band_val.shape
    k = nbd // 2
    xt = x.reshape(nt, T, -1).float()
    xp = F.pad(xt, (0, 0, 0, 0, k, k))
    band = band_val.float()
    y = torch.bmm(band[0], xp[0:nt])
    for d in range(1, nbd):
        y += torch.bmm(band[d], xp[d:d + nt])
    return y.reshape(x.shape)


def spmm_band(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    """Banded SpMM for x with num_vertices or padded_vertices rows."""
    V, Vp = x.shape[0], op.padded_vertices
    x2 = x.reshape(V, -1)
    if V != Vp:
        x2 = F.pad(x2, (0, 0, 0, Vp - V))
    y = band_hop(op.band_val.to(x.dtype), x2).to(x.dtype)
    return y[:V].reshape(x.shape)


def spmm(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    if op.kind == "dense":
        return spmm_dense(op, x)
    if op.kind == "band":
        return spmm_band(op, x)
    raise NotImplementedError(f"spmm for level kind {op.kind!r}")
