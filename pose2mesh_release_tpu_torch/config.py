"""Configuration system.

Accepts the reference's experiment files with the same sections and keys
as lib/core/config.py:40-109, rejecting unknown sections and keys, but with
none of the reference's import-time side effects: `load_config` returns a
value and deletes nothing.  The dataclasses, defaults and the rejection
rules are those of the JAX package's `config.py`, so every file the JAX
package reads loads here unchanged.

`load_config` reads a path ending in `.json` with `json` and any other path
as YAML (`yaml.safe_load`, imported only then).  A JSON file is YAML as
well, so one JSON file serves both packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Config", "load_config", "default_config"]


@dataclass
class DatasetCfg:
    train_list: List[str] = field(default_factory=lambda: ["Human36M", "COCO", "MuCo"])
    test_list: List[str] = field(default_factory=lambda: ["PW3D"])
    input_joint_set: str = "coco"
    target_joint_set: str = "human36"
    workers: int = 16
    use_gt_input: bool = True


@dataclass
class ModelCfg:
    name: str = "pose2mesh_net"
    input_shape: Tuple[int, int] = (384, 288)
    normal_loss_weight: float = 1e-1
    edge_loss_weight: float = 20.0
    joint_loss_weight: float = 1e-3
    posenet_pretrained: bool = False
    posenet_path: str = ""
    # PoseNet hidden width (the reference hardcodes 4096,
    # lib/models/pose2mesh_net.py:12); small widths for tests
    posenet_hidden: int = 4096


@dataclass
class TrainCfg:
    resume_path: str = ""
    print_freq: int = 10
    batch_size: int = 64
    shuffle: bool = True
    begin_epoch: int = 1
    end_epoch: int = 40
    edge_loss_start: int = 15
    scheduler: str = "step"
    lr: float = 1e-3
    lr_step: List[int] = field(default_factory=lambda: [30])
    lr_factor: float = 0.1
    optimizer: str = "rmsprop"


@dataclass
class AugCfg:
    flip: bool = False
    rotate_factor: float = 0.0


@dataclass
class TestCfg:
    batch_size: int = 64
    shuffle: bool = False
    weight_path: str = ""
    vis: bool = False
    # deploy-form eval: BatchNorm folded into the conv weights and the band
    # convs on the group kernels.  Applies when the Tester builds its own
    # cascade (the training loop's in-epoch eval keeps the training form).
    deploy: bool = True


@dataclass
class TpuCfg:
    """The accelerator settings (no reference equivalent).  The section keeps
    the JAX package's name so both packages read the same files."""

    compute_dtype: str = "bf16"       # "f32" | "bf16"
    use_pallas: bool = True           # the band convs on their kernels
    data_axis: int = 1                # devices on the data-parallel axis
    graph_axis: int = 1               # devices on the vertex-sharding axis
    # train steps per dispatch: k > 1 stacks k batches into one call
    steps_per_dispatch: int = 1
    levels: int = 9                   # coarsening levels (9 SMPL / 6 MANO)
    block_size: int = 128
    dense_threshold: int = 768
    ordering: str = "rcm"


@dataclass
class Config:
    DATASET: DatasetCfg = field(default_factory=DatasetCfg)
    MODEL: ModelCfg = field(default_factory=ModelCfg)
    TRAIN: TrainCfg = field(default_factory=TrainCfg)
    AUG: AugCfg = field(default_factory=AugCfg)
    TEST: TestCfg = field(default_factory=TestCfg)
    TPU: TpuCfg = field(default_factory=TpuCfg)

    # the reference's data/ directory: <data_dir>/<dataset name>/...
    data_dir: str = "data"
    output_dir: str = "./experiment"
    seed: Optional[int] = None

    @property
    def checkpoint_dir(self) -> str:
        return osp.join(self.output_dir, "checkpoint")

    @property
    def vis_dir(self) -> str:
        return osp.join(self.output_dir, "vis")

    @property
    def graph_dir(self) -> str:
        return osp.join(self.output_dir, "graph")

    @property
    def res_dir(self) -> str:
        return osp.join(self.output_dir, "result")

    def make_dirs(self) -> None:
        for d in (self.output_dir, self.checkpoint_dir, self.vis_dir,
                  self.graph_dir, self.res_dir):
            os.makedirs(d, exist_ok=True)


def default_config() -> Config:
    return Config()


def _apply_section(section: Any, overrides: Dict[str, Any], path: str) -> None:
    for key, value in overrides.items():
        if not hasattr(section, key):
            raise ValueError(f"{path}.{key} not a known config key")
        current = getattr(section, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _apply_section(current, value, f"{path}.{key}")
        else:
            if isinstance(current, tuple) and isinstance(value, list):
                value = tuple(value)
            setattr(section, key, value)


def _read(path: str) -> Dict[str, Any]:
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f) or {}
        import yaml

        return yaml.safe_load(f) or {}


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Build a Config from the defaults, a JSON or YAML file and explicit
    overrides.  Unknown sections and keys raise, mirroring update_config's
    strictness (lib/core/config.py:87-109)."""
    cfg = Config()
    if path:
        for section, value in _read(path).items():
            if not hasattr(cfg, section):
                raise ValueError(f"unknown config section: {section}")
            target = getattr(cfg, section)
            if dataclasses.is_dataclass(target) and isinstance(value, dict):
                _apply_section(target, value, section)
            else:
                setattr(cfg, section, value)
    if overrides:
        _apply_section(cfg, overrides, "<overrides>")
    return cfg
