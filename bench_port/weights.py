"""The cascade's weights and the traffic's inputs, made on the device from
the run's seed.

Every float tensor of the state dict comes from one `torch.rand` call on
the device (a `torch.Generator` there), sliced and scaled: Linears
uniform(+-b) with b = 1/sqrt(fan_in) (graph convs: sqrt(2 / (fan_in +
fan_out)), the published init) and biases uniform(+-1/sqrt(fan_in));
BatchNorm affines and running statistics non-identity (weight and running
variance in [0.5, 1.5), bias and running mean in [-0.1, 0.1)), so the fold
does real work.  Float32, the parameters' type; the program computes in
its compute dtype from them.  Names are the reference's state-dict names,
which the port keeps.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["sub_seed", "param_shapes", "make_state_dict"]


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one consumer of the run's seed (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def param_shapes(cfg: Dict, coarse_vertices: int) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every float tensor: init is "linear", "conv",
    "bias:<fan_in>", "bn_weight", "bn_shift" or "bn_var"."""
    J, H = cfg["joint_set"]["joint_num"], cfg["posenet_hidden"]
    K = 3   # Chebyshev order: the port's band kernels and the reference are K=3
    out = []

    def linear(name, fout, fin, kind="linear"):
        out.append((name + ".weight", (fout, fin), kind))
        out.append((name + ".bias", (fout,), f"bias:{fin}"))

    def bn(name, n):
        out.extend([(name + ".weight", (n,), "bn_weight"), (name + ".bias", (n,), "bn_shift"),
                    (name + ".running_mean", (n,), "bn_shift"),
                    (name + ".running_var", (n,), "bn_var")])

    linear("pose_lifter.w1", H, 2 * J)
    for s in range(cfg["posenet_stages"]):
        pre = f"pose_lifter.linear_stages.{s}."
        bn(pre + "batch_norm1", H)
        linear(pre + "w1", H, H)
        bn(pre + "batch_norm2", H)
        linear(pre + "w2", H, H)
    linear("pose_lifter.w2", 3 * J, H)
    convs = [(c[i], c[i + 1]) for c in cfg["blocks"] for i in range(len(c) - 1)]
    for n, (fin, fout) in enumerate(convs):
        linear(f"pose2mesh.cl.{n}", fout, fin * K, "conv")
    for n, (_, fout) in enumerate(convs[:-1]):
        bn(f"pose2mesh.bn.{n}", fout)
    blocks = cfg["blocks"]
    linear("pose2mesh.fc", coarse_vertices * blocks[1][0], J * blocks[0][-1])
    return out


def make_state_dict(cfg: Dict, coarse_vertices: int, seed: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg, coarse_vertices)
    total = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    u = torch.rand(total, generator=g, device=device)
    sd, at = {}, 0
    for name, shape, init in shapes:
        n = math.prod(shape)
        t = u[at:at + n].view(shape)
        at += n
        if init == "linear":
            b = 1.0 / math.sqrt(shape[1])
            t = (2.0 * t - 1.0) * b
        elif init == "conv":
            b = math.sqrt(2.0 / (shape[0] + shape[1]))
            t = (2.0 * t - 1.0) * b
        elif init.startswith("bias:"):
            t = (2.0 * t - 1.0) / math.sqrt(int(init[5:]))
        elif init in ("bn_weight", "bn_var"):
            t = t + 0.5
        else:  # bn_shift
            t = (2.0 * t - 1.0) * 0.1
        sd[name] = t
        if name.endswith(".running_var"):
            sd[name[:-len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return sd
