"""Dataset layer: loaders, GT synthesis, mixing, batching.

A name-keyed registry replaces the reference's `eval(f'{name}.dataset')`
dispatch (lib/core/base.py:28), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Type

from .base import MeshDataset, pyramid_for
from .joint_sets import JointSet, get_joint_set
from .loader import BatchLoader, stack_samples
from .mixer import MultipleDatasets

__all__ = [
    "MeshDataset", "pyramid_for", "JointSet", "get_joint_set",
    "BatchLoader", "stack_samples", "MultipleDatasets", "get_dataset_class",
]


def get_dataset_class(name: str) -> Type[MeshDataset]:
    from .amass import AMASS
    from .coco import COCO
    from .freihand import FreiHAND
    from .human36m import Human36M
    from .muco import MuCo
    from .pw3d import PW3D
    from .surreal import SURREAL

    registry: Dict[str, Type[MeshDataset]] = {
        "Human36M": Human36M, "COCO": COCO, "MuCo": MuCo, "AMASS": AMASS,
        "SURREAL": SURREAL, "PW3D": PW3D, "FreiHAND": FreiHAND,
    }
    return registry[name]
