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

__all__ = ["spmm", "spmm_dense", "spmm_band", "spmm_bcsr", "spmm_ell", "band_hop"]


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


def spmm_bcsr(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    """Block-sparse-row SpMM: row tile t sums blk_val[t, b] @ x[tile
    blk_col[t, b]] over its blocks."""
    T, V = op.block_size, op.num_vertices
    nt, maxb = op.blk_col.shape
    x2 = x.reshape(V, -1)
    C = x2.shape[1]
    xt = F.pad(x2, (0, 0, 0, nt * T - V)).reshape(nt, T, C)
    gathered = xt.index_select(0, op.blk_col.reshape(-1)).reshape(nt, maxb, T, C)
    y = torch.einsum("nbpq,nbqc->npc", op.blk_val.to(x.dtype).float(),
                     gathered.float())
    return y.to(x.dtype).reshape(nt * T, C)[:V].reshape(x.shape)


def spmm_ell(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    """ELLPACK SpMM: y[v] = sum_d ell_w[v, d] * x[ell_idx[v, d]]."""
    x2 = x.reshape(x.shape[0], -1)
    nbrs = x2.index_select(0, op.ell_idx.reshape(-1)).reshape(
        op.ell_idx.shape + (x2.shape[1],))
    y = torch.einsum("vdc,vd->vc", nbrs.float(), op.ell_w.to(x.dtype).float())
    return y.to(x.dtype).reshape(x.shape)


_STRATEGIES = {"dense": spmm_dense, "band": spmm_band, "bcsr": spmm_bcsr,
               "ell": spmm_ell}


def spmm(op: LevelOperator, x: torch.Tensor, *,
         strategy: str | None = None) -> torch.Tensor:
    """L @ x by the operator's packed kind, or by `strategy` ("dense",
    "band", "bcsr", "ell") when given."""
    kind = strategy or op.kind
    if kind not in _STRATEGIES:
        raise ValueError(f"unknown spmm strategy: {kind}")
    return _STRATEGIES[kind](op, x)
