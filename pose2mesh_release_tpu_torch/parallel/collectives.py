"""Every collective of the port, over one axis of a `parallel.mesh.Mesh`.

  all_reduce_sum  forward the sum over the axis; backward the sum of the
                  cotangents (each rank's loss depends on the sum)
  gather_rows     sharded -> replicated: forward the all-gather along dim 0;
                  backward this rank's slice of the cotangent (every rank
                  computes the same replicated continuation)
  scatter_rows    replicated -> sharded: forward this rank's slice of dim 0;
                  backward the all-gather of the slices' cotangents
  exchange_halo   the k boundary tiles of both graph neighbours, zero at the
                  global edges (`parallel.halo`)
  broadcast_, broadcast_object, barrier

The first three are autograd functions; the others move no gradient.  Each
call is recorded in `mesh.census` while a census is open (`parallel.audit`),
by kind, call site, axis, elements and bytes; a backward's call site is
`backward_site(site)`.

Gloo's collectives and point-to-point calls read host buffers: on a gloo
mesh a tensor on the card is staged through host memory (copied to the CPU,
reduced, gathered or sent there, copied back).  That is how the card's runs
put several ranks on one card, which NCCL does not.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "gather_rows", "scatter_rows", "exchange_halo",
           "broadcast_", "broadcast_object", "barrier", "backward_site"]


def backward_site(site: str) -> str:
    """The census's call site of the backward of a collective at `site`."""
    return site + " (backward)"


def _record(mesh, kind: str, site: str, axis: str, t: torch.Tensor) -> None:
    if mesh.census is not None:
        mesh.census.add(kind, site, axis, t.numel(), t.numel() * t.element_size())


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _reduce(t: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """The sum of t over `axis`, as a new tensor on t's device."""
    _record(mesh, "all_reduce", site, axis, t)
    buf = t.detach().to("cpu" if _staged(mesh, t) else t.device, copy=True).contiguous()
    dist.all_reduce(buf, group=mesh.groups[axis])
    return buf.to(t.device)


def _gather(t: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """Every rank's t of `axis`, concatenated along dim 0 in rank order."""
    host = t.detach().contiguous()
    if _staged(mesh, t):
        host = host.to("cpu")
    parts = [torch.empty_like(host) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, host, group=mesh.groups[axis])
    out = torch.cat(parts).to(t.device)
    _record(mesh, "all_gather", site, axis, out)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        ctx.args = (mesh, axis, site)
        return _reduce(x, mesh, axis, site)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, site = ctx.args
        return _reduce(g, mesh, axis, backward_site(site)), None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        ctx.rows, ctx.index = x.shape[0], mesh.index(axis)
        return _gather(x, mesh, axis, site)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.index * ctx.rows, ctx.rows).contiguous(), None, None, None


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, site):
        n = mesh.size(axis)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
        rows = x.shape[0] // n
        ctx.args = (mesh, axis, site)
        index = mesh.index(axis)
        return x.narrow(0, index * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, site = ctx.args
        return _gather(g, mesh, axis, backward_site(site)), None, None, None


def all_reduce_sum(x: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """The sum of x over the ranks of `axis` ('data', 'graph' or 'world')."""
    return _AllReduceSum.apply(x, mesh, axis, site)


def gather_rows(x: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """Dim-0 shards of `axis`, concatenated in rank order on every rank."""
    return _GatherRows.apply(x, mesh, axis, site)


def scatter_rows(x: torch.Tensor, mesh, axis: str, site: str) -> torch.Tensor:
    """This rank's equal dim-0 shard of a tensor replicated over `axis`."""
    return _ScatterRows.apply(x, mesh, axis, site)


def exchange_halo(xt: torch.Tensor, k: int, mesh, site: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left, right): the last k tiles of the graph rank before this one and
    the first k tiles of the rank after it, zero where there is none.
    xt: (tiles, ...) with at least k tiles."""
    n, j = mesh.size("graph"), mesh.index("graph")
    ranks, group = mesh.ranks["graph"], mesh.groups["graph"]
    dev = xt.device
    staged = _staged(mesh, xt)
    first, last = xt[:k].contiguous(), xt[-k:].contiguous()
    if staged:
        first, last = first.to("cpu"), last.to("cpu")
    left, right = torch.zeros_like(first), torch.zeros_like(last)
    ops = []
    if j > 0:
        ops += [dist.P2POp(dist.isend, first, ranks[j - 1], group),
                dist.P2POp(dist.irecv, left, ranks[j - 1], group)]
    if j < n - 1:
        ops += [dist.P2POp(dist.isend, last, ranks[j + 1], group),
                dist.P2POp(dist.irecv, right, ranks[j + 1], group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for sent in ([first] if j > 0 else []) + ([last] if j < n - 1 else []):
        _record(mesh, "halo", site, "graph", sent)
    return left.to(dev), right.to(dev)


def broadcast_(t: torch.Tensor, mesh, site: str, src: int = 0) -> torch.Tensor:
    """Overwrite t with global rank `src`'s t, over the world."""
    _record(mesh, "broadcast", site, "world", t)
    staged = _staged(mesh, t)
    buf = t.detach().to("cpu") if staged else t.detach()
    dist.broadcast(buf, src, group=mesh.groups["world"])
    if staged:
        with torch.no_grad():
            t.copy_(buf)
    return t


def broadcast_object(obj: Any, mesh, src: int = 0) -> Any:
    """Global rank `src`'s picklable `obj`, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src, group=mesh.groups["world"])
    return box[0]


def barrier(mesh) -> None:
    dist.barrier(group=mesh.groups["world"])
