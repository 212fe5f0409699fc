"""The reference put in the program's place, for the controls and planted
faults that set the upper readings of the limits (`calibrate.py`): the same
step interface as `system.ServeSystem` / `system.TrainSystem`, computed by
`reference.model.RefModel` at `precision` ("fp8": the control of a bf16
configuration), optionally with a planted fault ("half_batch"); and a
planted fault of the port's data layer for the loader-fed cells
(`RolledTargets`)."""
from __future__ import annotations

from typing import Dict

import torch

from .reference.model import RMSPROP_ALPHA, RefModel
from .reference.pyramid import build_ref_pyramid
from .system import LoaderData

__all__ = ["RefServe", "RefTrain", "RolledTargets"]


def _ref(cfg, mesh, state, device, precision, fault=None) -> RefModel:
    js = cfg["joint_set"]
    pyr = build_ref_pyramid(mesh["faces"], js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    return RefModel(cfg, pyr, mesh["j_regressor"], state, device, precision, fault)


class RefServe:
    def __init__(self, cfg: Dict, mesh, state, device, precision: str = "fp8"):
        self.ref = _ref(cfg, mesh, state, device, precision)

    def step(self, pose2d: torch.Tensor):
        return self.ref.eval_step(pose2d)


class RefTrain:
    def __init__(self, cfg: Dict, mesh, state, device, dropout_seed: int,
                 precision: str = "fp8", fault=None):
        self.ref = _ref(cfg, mesh, state, device, precision, fault)
        self.faces = torch.as_tensor(mesh["faces"], dtype=torch.int64, device=device)
        self.gen = torch.Generator(device=device).manual_seed(dropout_seed)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        losses = self.ref.train_step(batch, self.faces, self.gen)
        return {k: torch.tensor(v) for k, v in losses.items()}

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        return self.ref.params(self.ref.trainable)

    def grad_norms_from_state(self) -> Dict[str, float]:
        return {k: float(torch.sqrt(self.ref.sq[k].double().sum() / (1.0 - RMSPROP_ALPHA)))
                for k in self.ref.trainable}


class RolledTargets(LoaderData):
    """The data layer with each batch's mesh targets moved one row on (row
    i gets row i + 1's), its joint targets kept: the samples' targets
    mixed where the batch is produced."""

    def batches(self):
        it = super().batches()
        try:
            for b in it:
                yield dict(b, mesh=b["mesh"].roll(-1, 0))
        finally:
            it.close()
