"""Flax variables of the JAX package's `Pose2Mesh` / `PoseNet` and its optax
optimizer state -> the port's state dict and torch optimizer state dict.

Takes the variables tree as nested dicts of numpy arrays ({"params": ...,
"batch_stats": ...}), folded or not.  Key map (the reference's names):

  pose_lifter/Dense_0, Dense_1        -> pose_lifter.w1, pose_lifter.w2
  pose_lifter/ResidualStage_N/{BatchNorm_0, Dense_0, BatchNorm_1, Dense_1}
                                      -> pose_lifter.linear_stages.N.{batch_norm1,
                                         w1, batch_norm2, w2}
  pose2mesh/ChebConv_K/{kernel, bias} -> pose2mesh.cl.K
  pose2mesh/ChebConv_K/BatchNorm_0    -> pose2mesh.bn.K (unfolded trees only)
  pose2mesh/Dense_0                   -> pose2mesh.fc

A `LiftTrainer`'s tree is a PoseNet alone (no `pose_lifter` level) and maps
to `PoseNet`'s names without the prefix.  Flax Dense kernels are (in, out);
torch Linear weights are (out, in).  The state dicts list the parameters in
the order of the port's `named_parameters()` (MeshNet: every conv, every
BatchNorm, then fc), which `optim_state_from_flax` numbers them by.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.optim import make_preconditioner

__all__ = ["state_dict_from_flax", "posenet_state_dict", "meshnet_state_dict",
           "flax_family", "optim_state_from_flax"]


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor of a numpy array or (a bfloat16 leaf) a tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _linear(sd, name: str, p: Dict[str, Any]):
    sd[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name: str, p: Dict[str, Any], s: Optional[Dict[str, Any]]):
    """A BatchNorm's affine and, where `s` is given, its running statistics
    (a tree shaped like the parameters, as an optimizer's, has none)."""
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{name}.running_mean"] = _t(s["mean"])
        sd[f"{name}.running_var"] = _t(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def posenet_state_dict(params: Dict[str, Any], stats: Optional[Dict[str, Any]]
                       ) -> Dict[str, torch.Tensor]:
    """PoseNet subtree (params, batch_stats) -> `PoseNet` state dict;
    stats None: the parameters alone."""
    sd: Dict[str, torch.Tensor] = {}
    _linear(sd, "w1", params["Dense_0"])
    n = 0
    while f"ResidualStage_{n}" in params:
        p = params[f"ResidualStage_{n}"]
        s = stats[f"ResidualStage_{n}"] if stats is not None else {}
        _bn(sd, f"linear_stages.{n}.batch_norm1", p["BatchNorm_0"], s.get("BatchNorm_0"))
        _linear(sd, f"linear_stages.{n}.w1", p["Dense_0"])
        _bn(sd, f"linear_stages.{n}.batch_norm2", p["BatchNorm_1"], s.get("BatchNorm_1"))
        _linear(sd, f"linear_stages.{n}.w2", p["Dense_1"])
        n += 1
    _linear(sd, "w2", params["Dense_1"])
    return sd


def meshnet_state_dict(params: Dict[str, Any], stats: Optional[Dict[str, Any]]
                       ) -> Dict[str, torch.Tensor]:
    """MeshNet subtree (params, batch_stats) -> `MeshNet` state dict, plus
    `bn.K.*` entries for convs whose BatchNorm is not folded; stats None:
    the parameters alone."""
    sd: Dict[str, torch.Tensor] = {}
    convs = []
    while f"ChebConv_{len(convs)}" in params:
        convs.append(params[f"ChebConv_{len(convs)}"])
    for k, conv in enumerate(convs):
        _linear(sd, f"cl.{k}", conv)
    for k, conv in enumerate(convs):
        if "BatchNorm_0" in conv:
            _bn(sd, f"bn.{k}", conv["BatchNorm_0"],
                stats[f"ChebConv_{k}"]["BatchNorm_0"] if stats is not None else None)
    _linear(sd, "fc", params["Dense_0"])
    return sd


def flax_family(params: Dict[str, Any]) -> str:
    """"cascade" for a `Pose2Mesh` params tree, "posenet" for a `PoseNet`
    alone (a `LiftTrainer`'s)."""
    if "pose_lifter" in params and "pose2mesh" in params:
        return "cascade"
    if "Dense_0" in params and "Dense_1" in params:
        return "posenet"
    raise ValueError(f"neither a Pose2Mesh nor a PoseNet params tree: keys {sorted(params)[:6]}")


def _port_state_dict(params: Dict[str, Any], stats: Optional[Dict[str, Any]]
                     ) -> Dict[str, torch.Tensor]:
    """A `Pose2Mesh` or `PoseNet` tree -> the port's state dict; stats None:
    the parameters alone (also of a tree shaped like them, as an
    optimizer's moments)."""
    if flax_family(params) == "posenet":
        return posenet_state_dict(params, stats)
    sub = lambda name: None if stats is None else stats.get(name, {})
    sd = {f"pose_lifter.{k}": v for k, v in posenet_state_dict(
        params["pose_lifter"], sub("pose_lifter")).items()}
    sd.update({f"pose2mesh.{k}": v for k, v in meshnet_state_dict(
        params["pose2mesh"], sub("pose2mesh")).items()})
    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} -> `Pose2Mesh` state dict, or `PoseNet`'s
    for a PoseNet tree."""
    return _port_state_dict(variables["params"], variables.get("batch_stats") or {})


def optim_state_from_flax(opt_state: Dict[str, Any], params: Dict[str, Any], step: int,
                          device: str | torch.device = "cpu") -> Dict[str, Any]:
    """The JAX package's optimizer state (`core/optim.py`'s preconditioners,
    as flax's state dict) -> a state dict for the port's optimizer over
    `model.parameters()` (`core.optim.make_preconditioner`):

      optax.scale_by_rms {nu}               -> RMSprop {step, square_avg}
      optax.scale_by_adam {count, mu, nu}   -> Adam {step, exp_avg, exp_avg_sq}
      optax.identity {}                     -> SGD, no state

    params: the params tree the state belongs to; step: the train state's
    step, RMSprop's step count (scale_by_rms keeps none).  A tree of another
    shape raises ValueError."""
    keys = set(opt_state)
    if keys == {"nu"}:
        name = "rmsprop"
    elif keys == {"count", "mu", "nu"}:
        name = "adam"
    elif not keys:
        name = "sgd"
    else:
        raise ValueError(f"optimizer state with keys {sorted(keys)}: the JAX package's "
                         "rmsprop ({nu}), adam ({count, mu, nu}) or sgd ({}) expected")
    ref = _port_state_dict(params, None)
    names = list(ref)
    try:
        moments = {k: _port_state_dict(opt_state[k], None) for k in keys - {"count"}}
    except (KeyError, ValueError) as e:
        raise ValueError(f"the {name} state does not match the params tree: {e}") from e
    for k, m in moments.items():
        if [(n, v.shape) for n, v in m.items()] != [(n, v.shape) for n, v in ref.items()]:
            raise ValueError(f"the {name} state's {k} does not match the params tree")
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if name != "sgd":
        count = int(np.asarray(opt_state["count"])) if name == "adam" else int(step)
        for i, n in enumerate(names):
            entry = {"step": torch.tensor(float(count))}
            if name == "rmsprop":
                entry["square_avg"] = moments["nu"][n].to(device)
            else:
                entry["exp_avg"] = moments["mu"][n].to(device)
                entry["exp_avg_sq"] = moments["nu"][n].to(device)
            state[i] = entry
    group = make_preconditioner(name, [torch.zeros(1)]).state_dict()["param_groups"][0]
    return {"state": state, "param_groups": [dict(group, params=list(range(len(names))))]}
