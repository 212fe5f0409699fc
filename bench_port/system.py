"""The system under test: the port's own entries, built as its users build
them.  The only module of the benchmark that imports the port.

serve: the deploy-form eval step that `Tester` runs
    (`core/train.py::make_eval_step` on a `Pose2Mesh` built with
    `inference_fused=True`, BatchNorm folded by `models/fold.py`), as
    `deploy.py::deploy_forward_on` builds it.
train: `core/train.py::make_train_step` with the optimizer of
    `core/optim.py::make_preconditioner`, as `train_setup.py` builds it.
train_loader: the same step on the datasets' pyramid, fed by the port's
    data layer (`LoaderData`: `core/engine.py::build_datasets`,
    `data/mixer.py::MultipleDatasets`, `data/loader.py::BatchLoader`), as
    `core/engine.py::Trainer.__init__` builds them.

serve and train pack the pyramid with the port's `graphs/build.py` and
`graphs/artifact.py::pack_pyramid` from the configuration's frozen mesh: the
port's own set-up; train_loader takes the first dataset's (`data/base.py::
pyramid_for`), as `Trainer` does.  The weights are the benchmark's, loaded
with `load_state_dict`.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

PORT = "pose2mesh_release_tpu_torch"

__all__ = ["PORT", "port_root", "ServeSystem", "TrainSystem", "LoaderData", "smpl_joints",
           "launch_counters"]


def port_root() -> Path:
    """The directory the port is imported from (the checkout's root)."""
    return Path(importlib.import_module(PORT).__file__).resolve().parents[1]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _artifact(cfg: Dict, mesh: Dict[str, np.ndarray], device: torch.device):
    """The port's packed pyramid of the configuration's frozen mesh, in the
    compute dtype."""
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    js = cfg["joint_set"]
    pyr = build_pyramid(mesh["faces"].astype(np.int64), joint_num=js["joint_num"],
                        skeleton=[tuple(e) for e in js["skeleton"]],
                        flip_pairs=[tuple(e) for e in js["flip_pairs"]],
                        levels=cfg["levels"],
                        extra_joint_edges=[tuple(e) for e in js["extra_edges"]])
    art = pack_pyramid(pyr, mesh["faces"].astype(np.int64),
                       dense_threshold=cfg["dense_threshold"],
                       block_size=cfg["block_size"], device=device)
    return art.to(device, _dtype(cfg["compute_dtype"]))


def _model(cfg: Dict, art, device, *, inference_fused: bool):
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    d = cfg["deploy"]
    return Pose2Mesh(cfg["joint_set"]["joint_num"], art.mesh_ops[-1].num_vertices,
                     blocks=[tuple(b) for b in cfg["blocks"]],
                     posenet_hidden=cfg["posenet_hidden"],
                     dtype=_dtype(cfg["compute_dtype"]), inference_fused=inference_fused,
                     flat_impl=d["flat_impl"], fused=d["fused"], dropout=cfg["dropout"],
                     device=device)


class ServeSystem:
    """step(pose2d on the device (B, J, 2)) -> (mesh mm (B, V, 3), regressed
    joints mm (B, J, 3), lifted pose mm (B, J, 3)), on the device."""

    def __init__(self, cfg: Dict, mesh: Dict[str, np.ndarray], state: Dict[str, torch.Tensor],
                 device: torch.device):
        from pose2mesh_release_tpu_torch.core.train import make_eval_step
        from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
        self.art = _artifact(cfg, mesh, device)
        self.model = _model(cfg, self.art, device, inference_fused=True)
        self.model.load_state_dict(fold_bn_variables(state))
        self.eval_step = make_eval_step(self.model, mesh["j_regressor"], device=device)

    def step(self, pose2d: torch.Tensor):
        return self.eval_step(self.art, pose2d)


class TrainSystem:
    """step(batch) -> the losses (device scalars); the optimizer's state,
    the parameters by name.  art, j_regressor: the packed pyramid (float32)
    and the loss's regressor to train on, where they are not the
    configuration's frozen mesh's (the datasets')."""

    def __init__(self, cfg: Dict, mesh: Dict[str, np.ndarray], state: Dict[str, torch.Tensor],
                 device: torch.device, dropout_seed: int, art=None,
                 j_regressor: Optional[np.ndarray] = None):
        from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
        from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
        self.art = (_artifact(cfg, mesh, device) if art is None
                    else art.to(device, _dtype(cfg["compute_dtype"])))
        self.model = _model(cfg, self.art, device, inference_fused=False)
        self.model.load_state_dict(state)
        opt = cfg["optimizer"]
        self.optimizer = make_preconditioner(opt["name"], self.model.parameters())
        w = cfg["loss_weights"]
        self.train_step = make_train_step(self.model, self.optimizer,
                                          mesh["j_regressor"] if j_regressor is None
                                          else j_regressor,
                                          normal_weight=w["normal"], edge_weight=w["edge"],
                                          joint_weight=w["joint"], device=device)
        self.state = TrainState(self.model, self.optimizer)
        self.generator = torch.Generator(device=device).manual_seed(dropout_seed)
        self.lr = float(opt["lr"])

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # the edge loss on, as in epochs >= 15 of the published schedule
        self.state, losses = self.train_step(self.state, self.art, batch, self.lr, True,
                                             self.generator)
        return losses

    def named_parameters(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def grad_norms_from_state(self) -> Dict[str, float]:
        """Each parameter's first gradient's norm, worked out from RMSprop's
        state after one step: square_avg = (1 - alpha) g^2."""
        alpha = float(self.optimizer.param_groups[0]["alpha"])
        out = {}
        for name, p in self.model.named_parameters():
            sq = self.optimizer.state[p]["square_avg"]
            out[name] = float(torch.sqrt(sq.double().sum() / (1.0 - alpha)))
        return out


class LoaderData:
    """The port's data layer over the annotation files under `data_dir`, as
    `Trainer` builds it: the SMPL body reading its regressors from
    `data_dir`, the configuration's `train_list` through
    `core/engine.py::build_datasets` (GT synthesis on `device`, the
    datasets' pyramid), their mix and the threaded loader with the
    traffic's batch, workers, shuffle and drop_last.  `batches()` iterates
    one epoch of train-step batches (`train_setup.train_batch` of each
    loader batch, on the device), as `Trainer.train_epoch` feeds its step;
    closing it stops the loader's threads."""

    def __init__(self, cfg: Dict, traffic: Dict, data_dir: str, device: torch.device):
        from pose2mesh_release_tpu_torch.body.smpl import SMPL
        from pose2mesh_release_tpu_torch.config import default_config
        from pose2mesh_release_tpu_torch.core.engine import build_datasets
        from pose2mesh_release_tpu_torch.data import BatchLoader, MultipleDatasets
        pcfg = default_config()
        pcfg.data_dir = data_dir
        pcfg.DATASET.train_list = list(cfg["train_list"])
        pcfg.DATASET.input_joint_set = cfg["joint_set"]["name"]
        pcfg.DATASET.target_joint_set = cfg["target_joint_set"]["name"]
        pcfg.DATASET.use_gt_input = bool(cfg["use_gt_input"])
        pcfg.MODEL.input_shape = tuple(cfg["input_shape"])
        self.datasets = build_datasets(pcfg, "train", SMPL(data_dir=data_dir),
                                       model_name="pose2mesh_net", device=device)
        self.graph = self.datasets[0].graph
        self.target_regressor = self.datasets[0].target_regressor()
        mix = MultipleDatasets(self.datasets, make_same_len=bool(traffic["make_same_len"]))
        self.loader = BatchLoader(mix, int(traffic["batch"]), shuffle=bool(traffic["shuffle"]),
                                  drop_last=bool(traffic["drop_last"]),
                                  num_workers=int(traffic["workers"]), device=device)

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        from pose2mesh_release_tpu_torch.train_setup import train_batch
        it = iter(self.loader)
        try:
            for b in it:
                yield train_batch(*b)
        finally:
            it.close()


def smpl_joints(regressor: np.ndarray, pose: np.ndarray, shape: np.ndarray,
                trans: np.ndarray, device: torch.device, chunk: int = 512) -> np.ndarray:
    """(N, R, 3) mm: `regressor` (R, V) over the port's stand-in SMPL body
    (the neutral layer that the datasets pose) at SMPL parameters pose (N,
    72), shape (N, 10) and translation (N, 3) metres, posed as
    `data/gt_synth.py::posed_mesh_world` poses it; for fits whose joints
    agree with their mesh."""
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.gt_synth import posed_mesh_world
    params = SMPL().layer("neutral").to(device)
    reg = torch.as_tensor(regressor, dtype=torch.float32, device=device)
    out = []
    with torch.no_grad():
        for s in range(0, len(pose), chunk):
            args = [torch.as_tensor(a[s:s + chunk], dtype=torch.float32, device=device)
                    for a in (pose, shape, trans)]
            mesh, _ = posed_mesh_world(params, *args)
            out.append(torch.einsum("rv,nvc->nrc", reg, mesh).cpu().numpy())
    return np.concatenate(out)


def launch_counters() -> Dict[str, int]:
    """The ops modules' launch counters (wrapper name -> calls so far)."""
    from pose2mesh_release_tpu_torch.ops import (fused_cheby, fused_cheby_train, hop,
                                                 strip_cheby, window_cheby)
    out = {}
    for m in (fused_cheby, fused_cheby_train, hop, strip_cheby, window_cheby):
        out.update(m.launches)
    return out
