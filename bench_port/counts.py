"""Operations and bytes of the cascade, counted from the configuration's
shapes and the reference pyramid's level sizes and nonzeros, whatever
implements them.

Model operations (the `mfu.*` metrics), one forward at batch B, 2 per
multiply-add: PoseNet's GEMMs; each Chebyshev conv's two hops at the
level's nonzeros (2 * 2 * nnz * B * fin) and its projection (2 * V * B *
3 fin * fout), V the level's rows; the FC onto the coarsest level; the
residual skip's channel interpolation where the width changes (two taps an
output, 4 * V * B * fout); the joint regressor (the rows of the
configuration's `target_joint_set` where it names one, else of its input
set).  The upsampling and `extract_mesh` are gathers and count 0.  A training step counts 3x the
forward's (forward, and the backward's two products per product), no
recompute; BatchNorm, activations and losses are not counted.

The band convs' least time (the `band_roofline.*` metrics) is chip_smoke's
`bound` recipe: per conv the larger of bytes / PEAK_BYTES and operations /
PEAK_BF16_FLOPS, each input read once and each output written once at the
real rows, the operator at its nonzeros, in the compute type (es bytes).
Deploy convs (group and commuted) as chip_smoke's `check_conv`; training
convs as its `check_train_conv` (K1 forward, K2 backward).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from .peaks import PEAK_BF16_FLOPS, PEAK_BYTES

__all__ = ["Conv", "conv_table", "forward_flops", "step_flops", "band_bound_s"]


@dataclass(frozen=True)
class Conv:
    block: int
    V: int          # rows of its level
    nnz: int        # nonzeros of its level's operator
    fin: int
    fout: int
    band: bool      # on a band level (V > dense_threshold): a kernel's conv
    final: bool     # the network's last conv (no BatchNorm, no ReLU)
    skip_fin: int   # >0: the block's residual skip is fused here (its width)
    fold: bool      # training form: the previous conv's BatchNorm folded into its read


def conv_table(cfg: Dict, sizes: Sequence[int], nnz: Sequence[int], joint_nnz: int
               ) -> List[Conv]:
    """Every conv of MeshNet in order.  sizes, nnz: the mesh levels' rows
    and nonzeros, finest first; the joint graph has joint_num rows."""
    blocks = cfg["blocks"]
    J = cfg["joint_set"]["joint_num"]
    n_mesh = len(sizes)
    if len(blocks) != n_mesh + 2:
        raise ValueError("block schedule does not fit the pyramid")
    levels = [(J, joint_nnz)] + [(sizes[k], nnz[k]) for k in range(n_mesh - 1, -1, -1)] \
        + [(sizes[0], nnz[0])]
    out = []
    for i, chans in enumerate(blocks):
        V, z = levels[i]
        band = i > 0 and V > cfg["dense_threshold"]
        has_skip = 0 < i < len(blocks) - 1
        for li in range(len(chans) - 1):
            last = li == len(chans) - 2
            out.append(Conv(block=i, V=V, nnz=z, fin=chans[li], fout=chans[li + 1], band=band,
                            final=i == len(blocks) - 1 and last,
                            skip_fin=chans[0] if band and has_skip and last else 0,
                            fold=li > 0))
    return out


def forward_flops(cfg: Dict, convs: Sequence[Conv], coarse_vertices: int, B: int) -> float:
    J, H = cfg["joint_set"]["joint_num"], cfg["posenet_hidden"]
    posenet = 2 * B * (2 * J * H + 2 * cfg["posenet_stages"] * H * H + H * 3 * J)
    blocks = cfg["blocks"]
    fc = 2 * B * (J * blocks[0][-1]) * (coarse_vertices * blocks[1][0])
    mesh = 0
    for c in convs:
        mesh += 2 * 2 * c.nnz * B * c.fin + 2 * c.V * B * 3 * c.fin * c.fout
    for i, chans in enumerate(blocks):
        if 0 < i < len(blocks) - 1 and chans[0] != chans[-1]:
            V = next(c.V for c in convs if c.block == i)
            mesh += 4 * V * B * chans[-1]
    V0 = convs[-1].V
    Jt = cfg.get("target_joint_set", cfg["joint_set"])["joint_num"]
    regressor = 2 * B * Jt * V0 * 3
    return float(posenet + fc + mesh + regressor)


def step_flops(cfg: Dict, convs: Sequence[Conv], coarse_vertices: int, B: int,
               train: bool) -> float:
    f = forward_flops(cfg, convs, coarse_vertices, B)
    return 3.0 * f if train else f


def _bound(flops: float, bytes_: float) -> float:
    return max(bytes_ / PEAK_BYTES, flops / PEAK_BF16_FLOPS)


def band_bound_s(convs: Sequence[Conv], B: int, train: bool, es: int = 2) -> float:
    """The band convs' least time, seconds, over one forward (deploy) or one
    training step (K1 and K2 of each)."""
    total = 0.0
    for c in convs:
        if not c.band:
            continue
        V, z, fin, fout = c.V, c.nnz, c.fin, c.fout
        W, b = 3 * fin * fout, fout
        if not train:
            commuted = fout < fin and not c.skip_fin and not c.final
            fs = c.skip_fin
            skip_w = fs and fs != fout
            flops = (2 * 2 * z * B * (fout if commuted else fin) + 2 * V * B * 3 * fin * fout
                     + (2 * V * B * fs * fout if skip_w else 0))
            bytes_ = es * (V * B * fin + V * B * fs + W + b + (fs * fout if skip_w else 0)
                           + V * B * fout + z)
            total += _bound(flops, bytes_)
            continue
        stats = not c.final
        fold_bytes = es * 2 * fin if c.fold else 0
        k1_flops = 2 * 2 * z * B * fin + 2 * V * B * 3 * fin * fout
        k1_bytes = (es * (V * B * fin + W + b + V * B * fout + z) + fold_bytes
                    + (2 * fout * 4 if stats else 0))
        k2_flops = 2 * 2 * z * B * fout + 2 * 2 * V * B * 3 * fout * fin
        k2_bytes = (es * (V * B * fout + V * B * fin + W) + es * V * B * fin + W * 4 + fout * 4
                    + es * z + (fold_bytes + 2 * fin * 4 if c.fold else 0))
        total += _bound(k1_flops, k1_bytes) + _bound(k2_flops, k2_bytes)
    return total
