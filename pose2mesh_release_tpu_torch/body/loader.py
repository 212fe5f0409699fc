"""Loaders for real SMPL/MANO parameter files (.pkl) when present.

The licensed model files are not redistributable and are not in this repo;
when a user supplies them (the reference's names:
basicModel_{neutral,f,m}_lbs_10_207_0_v1.0.0.pkl, MANO_RIGHT.pkl) these
loaders produce `BodyModelParams`.  The pkls embed `chumpy` arrays: they
are unpickled without the chumpy package by a minimal stub class whose
deserialized state exposes the underlying numpy array.  Same loaders as the
JAX package's `body/loader.py`.
"""
from __future__ import annotations

import dataclasses
import io
import os.path as osp
import pickle
from typing import Optional

import numpy as np
import scipy.sparse as sp

from .model import BodyModelParams

__all__ = ["load_body_pkl", "load_smpl_params", "load_mano_params"]


class _ChumpyStub:
    """Stands in for chumpy.ch.Ch during unpickling; keeps the numpy data."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @property
    def r(self):
        for key in ("x", "_value", "a"):
            v = self.__dict__.get(key)
            if v is not None:
                return np.asarray(v)
        raise AttributeError("chumpy stub: no array payload found")


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if isinstance(x, _ChumpyStub):
        return x.r
    if sp.issparse(x):
        return np.asarray(x.todense())
    return np.asarray(x)


def load_body_pkl(path: str) -> Optional[dict]:
    if not osp.exists(path):
        return None
    with open(path, "rb") as f:
        return _StubUnpickler(io.BytesIO(f.read()), encoding="latin1").load()


def _params_from_dict(d: dict) -> BodyModelParams:
    shapedirs = _to_np(d["shapedirs"]).astype(np.float32)
    posedirs = _to_np(d["posedirs"]).astype(np.float32)
    V = shapedirs.shape[0]
    return BodyModelParams(
        v_template=_to_np(d["v_template"]).astype(np.float32),
        shapedirs=shapedirs,
        posedirs=posedirs.reshape(V, 3, -1),
        J_regressor=_to_np(d["J_regressor"]).astype(np.float32),
        lbs_weights=_to_np(d["weights"]).astype(np.float32),
        parents=tuple(int(p) for p in np.asarray(d["kintree_table"])[0].clip(min=0)),
        faces=_to_np(d["f"]).astype(np.int32),
    )


def load_smpl_params(model_dir: Optional[str], gender: str) -> Optional[BodyModelParams]:
    if not model_dir:
        return None
    names = {
        "neutral": "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl",
        "female": "basicModel_f_lbs_10_207_0_v1.0.0.pkl",
        "male": "basicModel_m_lbs_10_207_0_v1.0.0.pkl",
    }
    d = load_body_pkl(osp.join(model_dir, names[gender]))
    return _params_from_dict(d) if d is not None else None


def load_mano_params(model_dir: Optional[str]) -> Optional[BodyModelParams]:
    """MANO_RIGHT.pkl with the full 45-dof pose (no PCA); its stored
    hands_mean offsets the articulated pose (flat_hand_mean=False)."""
    if not model_dir:
        return None
    d = load_body_pkl(osp.join(model_dir, "MANO_RIGHT.pkl"))
    if d is None:
        return None
    params = _params_from_dict(d)
    if "hands_mean" in d:
        params = dataclasses.replace(
            params, pose_mean=_to_np(d["hands_mean"]).astype(np.float32).reshape(-1))
    return params
