"""Deploy-time BatchNorm folding for the MeshNet graph convs.

Eval-mode BatchNorm is a per-channel affine map, so it folds exactly into
the preceding conv's projection:

    BN(z) = z * s + (beta - mean * s),  s = gamma / sqrt(var + eps)
    =>  W' = W * s,  b' = b * s + beta - mean * s

Works on the port's (reference-named) state dict: every `pose2mesh.bn.K.*`
entry folds into `pose2mesh.cl.K.*` and is removed.  PoseNet's BatchNorms
are left as they are.
"""
from __future__ import annotations

import re
from typing import Dict

import torch

__all__ = ["fold_bn_variables"]

_BN_EPS = 1e-5
_BN_KEY = re.compile(r"pose2mesh\.bn\.(\d+)\.weight")


def fold_bn_variables(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Return a new state dict with every MeshNet conv BatchNorm folded into
    its conv weight and bias (float32 arithmetic)."""
    sd = dict(state_dict)
    for key in list(sd):
        m = _BN_KEY.fullmatch(key)
        if m is None:
            continue
        bn, cl = f"pose2mesh.bn.{m.group(1)}.", f"pose2mesh.cl.{m.group(1)}."
        gamma, beta = sd.pop(bn + "weight"), sd.pop(bn + "bias")
        mean, var = sd.pop(bn + "running_mean"), sd.pop(bn + "running_var")
        sd.pop(bn + "num_batches_tracked", None)
        s = gamma / torch.sqrt(var + _BN_EPS)
        sd[cl + "weight"] = sd[cl + "weight"] * s[:, None]  # (fout, fin*K)
        sd[cl + "bias"] = sd[cl + "bias"] * s + (beta - mean * s)
    return sd
