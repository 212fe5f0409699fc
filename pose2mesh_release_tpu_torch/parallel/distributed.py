"""Process setup: one process per device.

Counterpart of the JAX package's `parallel/distributed.py`.  A launcher
such as torchrun starts one process per device and sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `init_distributed` joins the
default process group from them (or from explicit arguments) and is a no-op
returning (0, 1) when nothing is configured, as the JAX function is on one
host.  `host_shard` and `is_primary` are the JAX package's: the process
index and count, and whether this process writes checkpoints and logs.

`spawn_ranks` runs a function in N processes of one host joined into one
process group through a file rendezvous, with a deadline: gloo for the CPU
tests' ranks and for the single-card runs where every rank computes on one
card (NCCL puts at most one rank on a card), NCCL across the cards of a host.
"""
from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["init_distributed", "host_shard", "is_primary", "local_rank", "spawn_ranks"]


def init_distributed(backend: Optional[str] = None,
                     device: str | torch.device | None = "cuda", *,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int]:
    """Join the default process group if a launcher (or the arguments)
    configured one; returns (rank, world size).  With no WORLD_SIZE in the
    environment and no arguments it returns (0, 1) and initialises nothing.
    backend: default nccl for a CUDA device, gloo for the CPU."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return 0, 1
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return rank, world_size


def local_rank() -> int:
    """This process's index on its host: LOCAL_RANK where a launcher set it,
    else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard() -> Tuple[int, int]:
    """(process index, process count), the data loader's host_id / host_count."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and plots (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(fn, rank: int, world_size: int, backend: str, init_file: str, results,
               args_file) -> None:
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        init_distributed(backend, "cpu", init_method=f"file://{init_file}", rank=rank,
                         world_size=world_size)
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (), *,
                timeout: float = 300.0, backend: str = "gloo") -> List[Any]:
    """fn(rank, world_size, *args) in `world_size` spawned processes joined
    into a `backend` group; returns their results by rank.  fn must be
    importable by name and its results picklable (numpy, not tensors).  A
    rank that raises, dies, or is not done within `timeout` seconds fails
    the call, and every rank still running is killed."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        # the arguments go through a file: written to each child's pipe they
        # would start the children one after another
        args_file = os.path.join(tmp, "args.pkl")
        with open(args_file, "wb") as f:
            pickle.dump(tuple(args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, init_file, results,
                                   args_file))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got = {}
        try:
            while len(got) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} died (exit code "
                                           f"{procs[dead[0]].exitcode})") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks not done in {timeout} s; "
                                           f"done: {sorted(got)}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
    return [got[r] for r in range(world_size)]
