"""Checkpoint save / load with the reference's best/final semantics.

Reference: lib/funcs_utils.py:111-128 (checkpoint{N}.pth.tar per epoch,
best.pth.tar on test-error improvement, final.pth.tar at the end) and the
resume path lib/core/base.py:67-92.

Format: the reference's own, `torch.save` of {"epoch", "model_state_dict",
"optim_state_dict", "step", "train_log", "test_log"}.  The port's state
dicts use the reference's names (`pose_lifter.*`, `pose2mesh.cl.K`,
`pose2mesh.bn.K`, `pose2mesh.fc`; a standalone PoseNet `w1.*`), so one
loader reads the port's checkpoints and the reference's published ones.
The JAX package's flax msgpack `.ckpt` files ({"epoch", "state": {"params",
"batch_stats", "opt_state", "step"}, "train_log", "test_log"}) load into the
same payload: `core.flax_msgpack` decodes them without JAX, and
`parity.from_jax` maps the variables and the optimizer state onto the
port's names.  The port writes `.pth.tar` only.
"""
from __future__ import annotations

import io
import os
import os.path as osp
import pickle
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..parity.from_jax import optim_state_from_flax, state_dict_from_flax
from . import flax_msgpack

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint", "model_family"]


_UNUSED_REFERENCE_KEYS = ("pose_lifter.batch_norm1.", "batch_norm1.")


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    ckpt_dir: str,
    epoch: int,
    model: torch.nn.Module,
    optimizer: Optional[torch.optim.Optimizer] = None,
    *,
    step: int = 0,
    train_log: Optional[list] = None,
    test_log: Optional[dict] = None,
    is_best: bool = False,
    is_final: bool = False,
) -> str:
    """Write checkpoint{epoch}.pth.tar (and the same bytes as best.pth.tar /
    final.pth.tar); tensors are stored on the CPU."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_cpu(model.state_dict()),
        "optim_state_dict": _to_cpu(optimizer.state_dict()) if optimizer is not None else {},
        "step": int(step),
        "train_log": [float(v) for v in (train_log or [])],
        "test_log": test_log or {"surface": [], "joint": []},
    }
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    path = osp.join(ckpt_dir, f"checkpoint{epoch}.pth.tar")
    names = [path] + [osp.join(ckpt_dir, name) for flag, name in
                      ((is_best, "best.pth.tar"), (is_final, "final.pth.tar")) if flag]
    for name in names:
        with open(name, "wb") as f:
            f.write(blob)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint{N} file of the highest epoch N (the port's and the
    reference's `.pth.tar`, the JAX package's `.ckpt`), or None."""
    if not osp.isdir(ckpt_dir):
        return None
    best_epoch, best_path = -1, None
    for name in os.listdir(ckpt_dir):
        for suffix in (".ckpt", ".pth.tar"):
            if name.startswith("checkpoint") and name.endswith(suffix):
                try:
                    ep = int(name[len("checkpoint"):-len(suffix)])
                except ValueError:
                    continue
                if ep > best_epoch:
                    best_epoch, best_path = ep, osp.join(ckpt_dir, name)
    return best_path


def model_family(state_dict: Dict[str, torch.Tensor]) -> str:
    """"cascade" for a Pose2Mesh state dict (`pose_lifter.` / `pose2mesh.`
    keys, lib/models/pose2mesh_net.py:13-14), "posenet" for a standalone
    PoseNet (`w1.` / `linear_stages.`, lib/models/posenet.py:41-69)."""
    if any(k.startswith(("pose_lifter.", "pose2mesh.")) for k in state_dict):
        return "cascade"
    if "w1.weight" in state_dict:
        return "posenet"
    raise ValueError(f"cannot identify the model family: keys like {sorted(state_dict)[:4]}")


def _resolve(path_or_dir: str, pick_best: bool) -> str:
    if not osp.isdir(path_or_dir):
        return path_or_dir
    stems = ("best", "final") if pick_best else ("final", "best")
    candidates = [osp.join(path_or_dir, f"{stem}{ext}")
                  for stem in stems for ext in (".ckpt", ".pth.tar")]
    path = next((c for c in candidates if osp.exists(c)), None) \
        or latest_checkpoint(path_or_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoints in {path_or_dir}")
    # a caller asking for best.* must know when it got final.* (or vice versa)
    got = osp.basename(path).split(".")[0]
    if got != stems[0]:
        warnings.warn(f"load_checkpoint: {stems[0]}.* not found in {path_or_dir}; "
                      f"loading {osp.basename(path)} instead")
    return path


def _load_torch(path: str, dev: torch.device) -> Dict[str, Any]:
    try:
        blob = torch.load(path, map_location=dev, weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path} holds objects other than tensors and containers "
                         f"of numbers and strings: {e}") from e
    if not isinstance(blob, dict):
        raise ValueError(f"unrecognized checkpoint: {path}")
    return blob


def _load_flax(path: str, dev: torch.device) -> Dict[str, Any]:
    """The payload of a JAX package `.ckpt` (JAX core/checkpoint.py's
    save_checkpoint of core/engine.py's train state)."""
    with open(path, "rb") as f:
        blob = flax_msgpack.restore(f.read())
    if not (isinstance(blob, dict) and isinstance(blob.get("state"), dict)
            and "params" in blob["state"]):
        raise ValueError(f"{path}: not a JAX package checkpoint "
                         "({epoch, state: {params, ...}, ...})")
    state = blob["state"]
    step = int(np.asarray(state.get("step", 0)))
    sd = state_dict_from_flax({"params": state["params"],
                               "batch_stats": state.get("batch_stats") or {}})
    opt = state.get("opt_state")
    return {
        "epoch": int(blob.get("epoch", 0)),
        "model_state_dict": {k: v.to(dev) for k, v in sd.items()},
        "optim_state_dict": ({} if opt is None else
                             optim_state_from_flax(opt, state["params"], step, dev)),
        "step": step,
        "train_log": blob.get("train_log") or [],
        "test_log": blob.get("test_log") or {"surface": [], "joint": []},
    }


def load_checkpoint(path_or_dir: str, *, pick_best: bool = False,
                    device: str | torch.device | None = "cuda") -> Dict[str, Any]:
    """Load a `.pth.tar` / `.pth` checkpoint, or a JAX package `.ckpt`, onto
    `device`.

    A directory resolves to best / final (best first with pick_best, the
    posenet-pretrained load path, lib/core/base.py:69), else its latest
    checkpoint{N}.  Returns {"epoch", "model_state_dict" (DataParallel
    `module.` prefixes stripped, lib/funcs_utils.py:65-70), "family"
    (`model_family`), "optim_state_dict", "step", "train_log", "test_log"
    ({"joint": [...], ...})}; a `.ckpt`'s optimizer state is the port's
    (`parity.from_jax.optim_state_from_flax`)."""
    dev = resolve_device(device)
    path = _resolve(path_or_dir, pick_best)
    blob = _load_flax(path, dev) if path.endswith(".ckpt") else _load_torch(path, dev)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in blob.get("model_state_dict", blob).items()}
    # the reference's PoseNet holds a top-level batch_norm1 its forward never
    # uses (posenet.py:77-87); the port's PoseNet, as the JAX package's, has none
    sd = {k: v for k, v in sd.items() if not k.startswith(_UNUSED_REFERENCE_KEYS)}
    test_log = blob.get("test_log", {})
    if not isinstance(test_log, dict):
        test_log = {"joint": [float(v) for v in
                              torch.as_tensor(test_log, dtype=torch.float64).flatten()]}
    train_log = blob.get("train_log", [])
    optim = blob.get("optim_state_dict") or {}
    for state in optim.get("state", {}).values():
        # the optimizers keep their step counts on the CPU (not capturable)
        if torch.is_tensor(state.get("step")):
            state["step"] = state["step"].cpu()
    return {
        "epoch": int(blob.get("epoch", 0)),
        "model_state_dict": sd,
        "family": model_family(sd),
        "optim_state_dict": optim,
        "step": int(blob.get("step", 0)),
        "train_log": [float(v) for v in
                      torch.as_tensor(train_log, dtype=torch.float64).flatten()],
        "test_log": test_log,
    }
