"""Batch loader: a threaded host pipeline feeding batches on the device.

Replaces torch DataLoader + 16 worker processes (lib/core/base.py:30-43),
as the JAX package's `data/loader.py` does.  GT synthesis is precomputed
(data.gt_synth), so per-sample work is tiny 2-D numpy and a thread pool
with a prefetch queue keeps the card fed without process spawns.  A
producer thread builds each batch: the vectorized `get_batch` where the
dataset supports it (its augmentation runs on the batch's device), else the
per-sample `__getitem__` in the pool, stacked on the host and copied.  On
the card the producer copies and augments on a CUDA stream of its own and
records an event after each batch; the consumer's stream waits on that
event, and the batch's tensors are marked as used on the consumer's stream,
so no batch is read before its copy and its augmentation are done and no
call synchronizes the card.  Per-host sharding for multi-host runs: each
host iterates its own contiguous index shard (`host_id` / `host_count`).
On a data-parallel mesh every data rank draws the same epoch order (the
same seed) and takes its rows of each global batch (`data_rank` of
`data_ranks`: rows [d B/D, (d+1) B/D)), so the ranks' batches together are
the single-device batch.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device, to_device

__all__ = ["BatchLoader", "stack_samples", "tree_to_device"]

_END = object()


class _Failure:
    """An exception raised in the producer thread, handed to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def stack_samples(samples):
    """Stack a list of per-sample pytrees (dicts/tuples of arrays)."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: stack_samples([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            stack_samples([s[i] for s in samples]) for i in range(len(first))
        )
    return np.stack(samples)


def tree_to_device(tree, dev: torch.device):
    """A pytree of host arrays as tensors on `dev` (`device.to_device`)."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_device(v, dev) for v in tree)
    return to_device(tree, dev)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class BatchLoader:
    """Iterable over stacked batches on `device` with background prefetch.

    dataset: anything with __len__/__getitem__ (and optionally
    supports_batch/get_batch).
    drop_last: True for training (static shapes).
    device: where the batches' tensors live (default "cuda"; raises without
    CUDA unless "cpu").
    data_rank, data_ranks: this rank's rows of each batch of `batch_size`
    (global) rows; with data_ranks > 1 every batch must be whole (drop_last)
    and split evenly.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        host_id: int = 0,
        host_count: int = 1,
        device: str | torch.device | None = "cuda",
        data_rank: int = 0,
        data_ranks: int = 1,
    ):
        if data_ranks > 1 and (not drop_last or batch_size % data_ranks):
            raise ValueError(f"a batch of {batch_size} split over {data_ranks} data ranks "
                             f"needs drop_last and a multiple of {data_ranks}")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.host_id = host_id
        self.host_count = host_count
        self.data_rank = data_rank
        self.data_ranks = data_ranks

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        # contiguous per-host shard (same order across hosts given same seed)
        shard = len(idx) // self.host_count
        if self.host_count > 1:
            idx = idx[self.host_id * shard:(self.host_id + 1) * shard]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @staticmethod
    def _put(q: "queue.Queue", stop: threading.Event, item) -> bool:
        """Put `item` unless the consumer has stopped; False if it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, indices: np.ndarray, nb: int, q: "queue.Queue",
                 stop: threading.Event) -> None:
        dev = self.device
        fused = getattr(self.dataset, "supports_batch", lambda: False)()
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        try:
            with ThreadPoolExecutor(self.num_workers) as pool, \
                    (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext()):
                for b in range(nb):
                    batch_idx = indices[b * self.batch_size:(b + 1) * self.batch_size]
                    per = self.batch_size // self.data_ranks
                    batch_idx = batch_idx[self.data_rank * per:(self.data_rank + 1) * per]
                    if fused:  # vectorized whole-batch path (data/pipeline.py)
                        batch = self.dataset.get_batch(batch_idx, device=dev)
                    else:
                        samples = list(pool.map(self.dataset.__getitem__, batch_idx))
                        batch = tree_to_device(stack_samples(samples), dev)
                    event = None
                    if stream is not None:
                        event = torch.cuda.Event()
                        event.record(stream)
                    if not self._put(q, stop, (batch, event)):
                        return
            self._put(q, stop, _END)
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(q, stop, _Failure(e))

    def __iter__(self) -> Iterator:
        indices = self._epoch_indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(indices, nb, q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise RuntimeError("the batch loader's producer failed") from item.exc
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for leaf in _leaves(batch):
                        leaf.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            t.join()
