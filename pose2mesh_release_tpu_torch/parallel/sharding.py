"""How the artifact, the batch, the state and the gradients lay out over
the ('data', 'graph') mesh.

Counterpart of the JAX package's `parallel/sharding.py`, whose shardings
GSPMD turns into collectives; here the layout is explicit:

  shard_artifact  band levels whose slabs hold at least band_k tiles on each
                  graph rank (`halo.halo_supported`) become this rank's
                  "halo" slab; dense levels, other band levels and the tables
                  stay whole (replicated);
  shard_batch     data rank d takes rows [d B/D, (d+1) B/D) of the global batch;
  shard_state     every rank takes rank 0's parameters and buffers;
  sync_grads      every gradient averaged over 'data'; the gradients of the
                  graph-split convs (weights, biases, their BatchNorm's scale
                  and bias), which each graph rank holds for its rows only,
                  also summed over 'graph': one all-reduce over the world.
                  Replicated parameters' gradients are whole on every graph
                  rank and are not summed over 'graph'.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch

from ..graphs.artifact import LevelOperator, PyramidArtifact
from .collectives import all_reduce_sum, broadcast_
from .halo import band_slab, halo_supported

__all__ = ["shard_artifact", "shard_level", "shard_batch", "shard_state", "sync_grads"]


def shard_level(op: LevelOperator, mesh) -> LevelOperator:
    """This graph rank's form of one level: its slab where `halo_supported`."""
    if mesh.graph == 1 or not halo_supported(op, mesh.graph):
        return op
    return LevelOperator(kind="halo", num_vertices=op.num_vertices,
                         block_size=op.block_size, band_k=op.band_k,
                         band_val=band_slab(op.band_val, op.band_k, mesh.graph_rank,
                                            mesh.graph))


def shard_artifact(art: PyramidArtifact, mesh) -> PyramidArtifact:
    """`art` (on this rank's device, in the compute dtype) with its
    graph-split band levels as this rank's slabs."""
    return dataclasses.replace(art, mesh_ops=tuple(shard_level(op, mesh) for op in art.mesh_ops))


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This data rank's rows of every (B, ...) tensor of the global batch."""
    def rows(t):
        B = t.shape[0]
        if B % mesh.data:
            raise ValueError(f"a batch of {B} does not split over {mesh.data} data ranks")
        n = B // mesh.data
        return t[mesh.data_rank * n:(mesh.data_rank + 1) * n]
    return {k: rows(v) for k, v in batch.items()}


@torch.no_grad()
def shard_state(model: torch.nn.Module, mesh) -> None:
    """Overwrite every parameter and buffer with rank 0's."""
    for t in list(model.parameters()) + list(model.buffers()):
        broadcast_(t, mesh, site="state")


@torch.no_grad()
def sync_grads(params: Iterable[torch.nn.Parameter], mesh,
               graph_split: Iterable[torch.nn.Parameter] = ()) -> None:
    """Average the gradients over 'data'; those of `graph_split` are first
    summed over 'graph'.  Parameters without a gradient are left alone (they
    have none on any rank)."""
    split = {id(p) for p in graph_split}
    buckets = {"data": [], "world": []}
    for p in params:
        if p.grad is not None:
            buckets["world" if id(p) in split else "data"].append(p)
    for axis, ps in buckets.items():
        if not ps:
            continue
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = all_reduce_sum(flat, mesh, axis, site="gradients") / mesh.data
        off = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[off:off + n].view_as(p.grad))
            off += n
