"""Flax variables of the JAX package's `Pose2Mesh` -> the port's state dict.

Takes the variables tree as nested dicts of numpy arrays ({"params": ...,
"batch_stats": ...}), folded or not.  Key map (the reference's names):

  pose_lifter/Dense_0, Dense_1        -> pose_lifter.w1, pose_lifter.w2
  pose_lifter/ResidualStage_N/{BatchNorm_0, Dense_0, BatchNorm_1, Dense_1}
                                      -> pose_lifter.linear_stages.N.{batch_norm1,
                                         w1, batch_norm2, w2}
  pose2mesh/Dense_0                   -> pose2mesh.fc
  pose2mesh/ChebConv_K/{kernel, bias} -> pose2mesh.cl.K
  pose2mesh/ChebConv_K/BatchNorm_0    -> pose2mesh.bn.K (unfolded trees only)

Flax Dense kernels are (in, out); torch Linear weights are (out, in).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "posenet_state_dict", "meshnet_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _linear(sd, name: str, p: Dict[str, Any]):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name: str, p: Dict[str, Any], s: Dict[str, Any]):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def posenet_state_dict(params: Dict[str, Any], stats: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """PoseNet subtree (params, batch_stats) -> `PoseNet` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "w1", params["Dense_0"])
    n = 0
    while f"ResidualStage_{n}" in params:
        p, s = params[f"ResidualStage_{n}"], stats[f"ResidualStage_{n}"]
        _bn(sd, f"linear_stages.{n}.batch_norm1", p["BatchNorm_0"], s["BatchNorm_0"])
        _linear(sd, f"linear_stages.{n}.w1", p["Dense_0"])
        _bn(sd, f"linear_stages.{n}.batch_norm2", p["BatchNorm_1"], s["BatchNorm_1"])
        _linear(sd, f"linear_stages.{n}.w2", p["Dense_1"])
        n += 1
    _linear(sd, "w2", params["Dense_1"])
    return sd


def meshnet_state_dict(params: Dict[str, Any], stats: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """MeshNet subtree (params, batch_stats) -> `MeshNet` state dict, plus
    `bn.K.*` entries for convs whose BatchNorm is not folded."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "fc", params["Dense_0"])
    k = 0
    while f"ChebConv_{k}" in params:
        conv = params[f"ChebConv_{k}"]
        _linear(sd, f"cl.{k}", conv)
        if "BatchNorm_0" in conv:
            _bn(sd, f"bn.{k}", conv["BatchNorm_0"],
                stats[f"ChebConv_{k}"]["BatchNorm_0"])
        k += 1
    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Whole cascade: {"params", "batch_stats"} -> `Pose2Mesh` state dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = {f"pose_lifter.{k}": v for k, v in posenet_state_dict(
        params["pose_lifter"], stats.get("pose_lifter", {})).items()}
    sd.update({f"pose2mesh.{k}": v for k, v in meshnet_state_dict(
        params["pose2mesh"], stats.get("pose2mesh", {})).items()})
    return sd
