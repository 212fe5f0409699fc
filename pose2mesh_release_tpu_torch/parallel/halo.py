"""Vertex-split band hops: z = L x with x's rows split over the graph axis.

Counterpart of the JAX package's `parallel/halo.py`.  The band levels are
block-banded (band_k k in {1, 2}): a rank owning a contiguous run of row
tiles needs the k boundary tiles of each neighbour per hop, the halo.
`parallel.sharding.shard_artifact` gives each graph rank its slab of the
band, zero-padded to nt_pad = ceil(nt / g) g tiles as the JAX hop pads it:
(2k+1, nt_l + 2k, T, T) with nt_l = nt_pad / g, its first and last k row
tiles zero.  A level operator of kind "halo" carries it.

`halo_banded_hop` exchanges the halos (`collectives.exchange_halo`, zero at
the global edges) and hops the halo-extended slab (nt_l + 2k tiles): on a
tensor on the card with the hop kernel K4 (`ops.hop.hop`, one launch, the
middle nt_l tiles kept), on a CPU tensor with `_local_band_hop`, the JAX
package's plain slab hop.  Its backward is the halo hop of the cotangent,
one more exchange: L is symmetric.  (A slab of the band is not symmetric, so
it does not go through `ops.hop._BandedHop`, whose backward assumes so.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graphs.artifact import LevelOperator
from ..ops.hop import hop
from .collectives import exchange_halo

__all__ = ["halo_supported", "halo_banded_hop", "band_slab", "global_rows",
           "row_mask"]


def _tiles(nt: int, n_dev: int) -> int:
    """nt_pad: the tile count zero-padded to a multiple of the axis size."""
    return -(-nt // n_dev) * n_dev


def halo_supported(op: LevelOperator, n_dev: int) -> bool:
    """A band level with band_k in {1, 2} whose slab on each of n_dev graph
    ranks holds at least k tiles (one exchange per side suffices)."""
    if op.kind != "band" or not 1 <= op.band_k <= 2:
        return False
    return _tiles(op.band_val.shape[1], n_dev) // n_dev >= op.band_k


def band_slab(band_val: torch.Tensor, k: int, j: int, n_dev: int) -> torch.Tensor:
    """Graph rank j's slab (2k+1, nt_l + 2k, T, T) of the band (2k+1, nt, T, T)."""
    nt = band_val.shape[1]
    nt_pad = _tiles(nt, n_dev)
    nt_l = nt_pad // n_dev
    band = F.pad(band_val, (0, 0, 0, 0, 0, nt_pad - nt))
    return F.pad(band[:, j * nt_l:(j + 1) * nt_l], (0, 0, 0, 0, k, k)).contiguous()


def global_rows(op: LevelOperator, n_dev: int) -> int:
    """Rows of a halo level's activation over all graph ranks (nt_pad T)."""
    return op.padded_vertices * n_dev


def row_mask(op: LevelOperator, j: int, device) -> torch.Tensor:
    """(rows, 1, 1) bool: which of graph rank j's rows are real vertices."""
    rows = op.padded_vertices
    idx = torch.arange(rows, device=device) + j * rows
    return (idx < op.num_vertices).view(rows, 1, 1)


def _local_band_hop(band: torch.Tensor, xt: torch.Tensor, left: torch.Tensor,
                    right: torch.Tensor) -> torch.Tensor:
    """One band hop on a slab with explicit halo tiles (the JAX package's).
    band: (2k+1, nt_l, T, T); xt: (nt_l, T, C); left, right: (k, T, C).
    Products and sums in float32, rounded once to xt's dtype."""
    k = band.shape[0] // 2
    if left.shape[0] != k or right.shape[0] != k:
        raise ValueError(f"band_k {k} needs {k} halo tiles a side")
    xp = torch.cat([left, xt, right]).float()
    nt_l = xt.shape[0]
    y = sum(torch.einsum("tpq,tqc->tpc", band[d].float(), xp[d:d + nt_l])
            for d in range(2 * k + 1))
    return y.to(xt.dtype)


def _halo_hop(slab: torch.Tensor, x: torch.Tensor, k: int, mesh) -> torch.Tensor:
    T = slab.shape[-1]
    nt_l = slab.shape[1] - 2 * k
    xt = x.reshape(nt_l, T, -1)
    left, right = exchange_halo(xt, k, mesh, site="halo hop")
    if x.is_cuda:
        ext = torch.cat([left, xt, right]).reshape((nt_l + 2 * k) * T, *x.shape[1:])
        return hop(slab, ext)[k * T:(k + nt_l) * T]
    return _local_band_hop(slab[:, k:k + nt_l], xt, left, right).reshape(x.shape)


class _HaloHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slab, k, mesh):
        ctx.save_for_backward(slab)
        ctx.k, ctx.mesh = k, mesh
        return _halo_hop(slab, x.contiguous(), k, mesh)

    @staticmethod
    def backward(ctx, g):
        (slab,) = ctx.saved_tensors
        return _halo_hop(slab, g.contiguous(), ctx.k, ctx.mesh), None, None, None


def halo_banded_hop(op: LevelOperator, x: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable z = L x on this graph rank's rows: op a level of kind
    "halo" (its band_val the slab), x (nt_l T, ...) in the slab's dtype."""
    if op.kind != "halo":
        raise ValueError(f"halo_banded_hop needs a halo level, got kind {op.kind!r}")
    rows = op.padded_vertices
    if x.shape[0] != rows:
        raise ValueError(f"x must hold this rank's {rows} rows, got {tuple(x.shape)}")
    return _HaloHop.apply(x, op.band_val, op.band_k, mesh)
