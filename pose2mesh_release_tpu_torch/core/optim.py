"""Optimizers and learning-rate schedules.

`make_preconditioner` gives the torch optimizer matching the JAX package's
lr-free preconditioner followed by `-lr * update`: RMSprop(alpha=0.99,
eps=1e-8) == optax.scale_by_rms(0.99, 1e-8, eps_in_sqrt=False), Adam ==
optax.scale_by_adam(), SGD == optax.identity().  The train step sets the
learning rate of every parameter group before each step (`set_lr`), as the
JAX step takes it as an argument.  `multistep_lr` and `ReduceLROnPlateau`
are the JAX package's schedules.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch

__all__ = ["make_preconditioner", "set_lr", "multistep_lr", "ReduceLROnPlateau"]


def make_preconditioner(name: str, params: Iterable[torch.nn.Parameter]
                        ) -> torch.optim.Optimizer:
    """rmsprop, adam or sgd over `params`, torch's defaults as the reference
    uses them; the learning rate is set per step."""
    name = name.lower()
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=0.0, alpha=0.99, eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0)
    raise ValueError(f"unknown optimizer {name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1) -> Callable[[int], float]:
    """MultiStepLR: lr * gamma**(number of milestones passed), by epoch."""
    ms = sorted(milestones)

    def lr_at(epoch: int) -> float:
        return base_lr * (gamma ** sum(1 for m in ms if epoch >= m))

    return lr_at


class ReduceLROnPlateau:
    """Plateau scheduler (factor 0.1, patience 5, min_lr 1e-5 defaults)."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 5,
                 min_lr: float = 1e-5):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr
