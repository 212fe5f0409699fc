"""Device selection for the port's entry points.

Every entry point takes `device=`, defaulting to "cuda".  Asking for CUDA
on a machine without it, or for a card it does not have, raises: nothing
silently runs on the CPU or shares another card.  Pass
device="cpu" to run the plain PyTorch versions of the kernels on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise ValueError(f"{dev}: this machine has {torch.cuda.device_count()} CUDA "
                         f"device(s)")
    return dev


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`.  On the card the array is copied
    into pinned memory and from there without blocking, on the current
    stream: its readers must run on that stream or wait on it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t
