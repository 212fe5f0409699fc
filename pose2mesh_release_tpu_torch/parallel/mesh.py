"""The ('data', 'graph') mesh of torch.distributed ranks.

Counterpart of the JAX package's `parallel/mesh.py`:

  'data'  batch parallelism: each data rank holds its rows of the global
          batch; gradients are averaged and BatchNorm statistics summed over it;
  'graph' vertex parallelism: the band levels' row tiles are split over it
          (`parallel.sharding.shard_artifact`), their hops exchange halo
          tiles (`parallel.halo`); PoseNet and the dense levels are
          replicated on the graph ranks of one data index.

Rank r sits at (r // graph_axis, r % graph_axis), the reshape order of the
JAX `make_mesh`.  One process group per axis and position, built once;
every collective goes through `parallel.collectives`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

__all__ = ["Mesh", "layout", "make_mesh"]


def layout(world_size: int, graph_axis: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(data groups, graph groups) as lists of global ranks: graph group d is
    the ranks of data index d, data group j those of graph index j."""
    if graph_axis < 1 or world_size % graph_axis:
        raise ValueError(f"{world_size} processes not divisible by graph_axis={graph_axis}")
    D = world_size // graph_axis
    graph = [[d * graph_axis + j for j in range(graph_axis)] for d in range(D)]
    data = [[d * graph_axis + j for d in range(D)] for j in range(graph_axis)]
    return data, graph


@dataclass(eq=False)
class Mesh:
    """This rank's place on the mesh: the axis sizes, its global rank, the
    backend, and per axis ('data', 'graph', 'world') its process group and
    that group's global ranks.  `census` is the open `audit.Census`, if any."""
    data: int
    graph: int
    rank: int
    backend: str
    groups: Dict[str, object]
    ranks: Dict[str, Tuple[int, ...]]
    census: Optional[object] = field(default=None)

    @property
    def data_rank(self) -> int:
        return self.rank // self.graph

    @property
    def graph_rank(self) -> int:
        return self.rank % self.graph

    def size(self, axis: str) -> int:
        return len(self.ranks[axis])

    def index(self, axis: str) -> int:
        """This rank's position in its group of `axis`."""
        return self.ranks[axis].index(self.rank)


def make_mesh(graph_axis: int = 1) -> Mesh:
    """The mesh over every process of the initialised default group, with
    `graph_axis` ranks on the graph axis and the rest on the data axis.
    Every process must call it (group creation is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(parallel.distributed.init_distributed)")
    world, rank = dist.get_world_size(), dist.get_rank()
    data_groups, graph_groups = layout(world, graph_axis)
    groups, ranks = {"world": dist.group.WORLD}, {"world": tuple(range(world))}
    for axis, members in (("graph", graph_groups), ("data", data_groups)):
        for m in members:
            g = dist.new_group(m)
            if rank in m:
                groups[axis], ranks[axis] = g, tuple(m)
    return Mesh(world // graph_axis, graph_axis, rank, dist.get_backend(), groups, ranks)
