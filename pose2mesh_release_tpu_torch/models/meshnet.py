"""MeshNet deploy forward: Chebyshev graph-CNN decoding a pose into a mesh.

The network walks the coarsening pyramid coarse -> fine: a block of K=3
Chebyshev convs per level, an FC "upsample" from the joint graph onto the
coarsest mesh level, channel-interpolated residual skips, and x2 nearest
vertex upsampling between levels as index gathers.

This is the deploy form: BatchNorm is folded into the conv weights
(`models.fold`) and each conv is one pass.
  * Dense levels (the joint graph and small mesh levels) run
    `chebyshev_stack` + matmul + ReLU.
  * Band levels run the fused kernels of `ops.fused_cheby` on a vertex-major
    (Vp, B, F) layout at the pack-time padded row count Vp, with the block's
    residual skip fused into the last conv.  A conv that narrows its
    channels (no skip, not the final conv) takes the commuted kernel.
Pad rows (>= num_vertices) carry values that never reach a real row; the
gathers into a band level index row 0 for them.

Parameters follow the reference's state dict: `cl.N` (Linear over the
fin-major Chebyshev stack, weight (fout, fin*K)) and `fc`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..graphs.artifact import LevelOperator, PyramidArtifact
from ..ops.cheby import chebyshev_stack
from ..ops.fused_cheby import fused_cheby_conv, fused_cheby_conv_commuted
from .posenet import linear

__all__ = ["MeshNet", "channel_interp_matrix", "SMPL_BLOCKS", "MANO_BLOCKS",
           "extract_mesh"]

# Per-block channel schedules (reference meshnet.py:23-33).
SMPL_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (5, 32, 64, 64),
    (64, 128, 256), (256, 256, 256), (256, 256, 256),
    (256, 256, 256), (256, 256, 256), (256, 128, 128),
    (128, 128, 128), (128, 128, 128), (128, 64, 3),
)
MANO_BLOCKS: Tuple[Tuple[int, ...], ...] = (
    (5, 32, 64, 64),
    (64, 128, 256), (256, 256, 256), (256, 256, 256),
    (256, 256, 256), (256, 128, 128), (128, 64, 3),
)


def channel_interp_matrix(fin: int, fout: int) -> np.ndarray:
    """Constant (fout, fin) matrix reproducing torch F.interpolate(
    mode='linear', align_corners=False) along the channel axis:
    out = x @ M.T."""
    p = (np.arange(fout) + 0.5) * fin / fout - 0.5
    p = np.maximum(p, 0.0)  # torch clamps negative source indices to 0
    i0 = np.floor(p).astype(np.int64)
    frac = p - i0
    i0 = np.clip(i0, 0, fin - 1)
    i1 = np.clip(i0 + 1, 0, fin - 1)
    M = np.zeros((fout, fin), dtype=np.float32)
    np.add.at(M, (np.arange(fout), i0), 1.0 - frac)
    np.add.at(M, (np.arange(fout), i1), frac)
    return M


class MeshNet(nn.Module):
    """Pose features (B, J, C_in) -> mesh vertices (B, V, 3) float32 in
    device vertex order; `extract_mesh` restores the original order.

    coarse_vertices: row count of the coarsest mesh level
    (art.mesh_ops[-1].num_vertices), the FC layer's output size."""

    def __init__(self, num_joint: int, coarse_vertices: int,
                 blocks: Sequence[Sequence[int]] = SMPL_BLOCKS, K: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if K != 3:
            raise NotImplementedError("the band-level kernels are K=3 convs")
        self.blocks = tuple(tuple(c) for c in blocks)
        self.K = K
        self.dtype = dtype
        self.cl = nn.ModuleList(
            nn.Linear(c[li] * K, c[li + 1])
            for c in self.blocks for li in range(len(c) - 1))
        self.fc = nn.Linear(num_joint * self.blocks[0][-1],
                            coarse_vertices * self.blocks[1][0])
        self._interp = {}
        self._band_weights = {}

    def _skip_w(self, fin: int, fout: int, dtype, device) -> torch.Tensor:
        """(fin, fout) channel-interpolation matrix, cached per dtype/device."""
        key = (fin, fout, dtype, device)
        if key not in self._interp:
            M = torch.from_numpy(channel_interp_matrix(fin, fout).T.copy())
            self._interp[key] = M.to(device=device, dtype=dtype)
        return self._interp[key]

    def _dense_conv(self, op: LevelOperator, x, lin: nn.Linear, relu: bool):
        x = x.to(self.dtype)
        y = linear(chebyshev_stack(op, x, self.K), lin, self.dtype)
        return torch.relu(y) if relu else y

    def _band_weights_for(self, lin: nn.Linear, commuted: bool):
        """The kernels' weight layout of one conv, (3*fin, fout) and (fout,)
        in the compute dtype: basis-major [W_x; W_Lx; W_cheb2], or
        [W_x - W_cheb2; W_Lx; W_cheb2] for the commuted kernel.  Built once
        per set of weights; a new state dict (or any in-place update of the
        weights) bumps the tensors' versions and rebuilds it."""
        w, bias = lin.weight, lin.bias
        key = (w.data_ptr(), w._version, bias.data_ptr(), bias._version,
               self.dtype, w.device, commuted)
        hit = self._band_weights.get(id(lin))
        if hit is not None and hit[0] == key:
            return hit[1], hit[2]
        fout, fin_k = w.shape
        fin = fin_k // self.K
        # fin-major (fin*K, fout) -> basis-major
        W = w.detach().to(self.dtype).t().reshape(fin, self.K, fout).permute(1, 0, 2)
        if commuted:
            W = torch.stack([W[0] - W[2], W[1], W[2]])
        W = W.reshape(self.K * fin, fout).contiguous()
        b = bias.detach().to(self.dtype).contiguous()
        self._band_weights[id(lin)] = (key, W, b)
        return W, b

    def _band_conv(self, op: LevelOperator, x, lin: nn.Linear, *, relu: bool,
                   final: bool, skip=None, skip_w=None):
        fout, fin_k = lin.weight.shape
        commuted = fout < fin_k // self.K and skip is None and not final
        W, b = self._band_weights_for(lin, commuted)
        band = op.band_val.to(self.dtype)
        x = x.to(self.dtype).contiguous()
        if commuted:
            return fused_cheby_conv_commuted(band, x, W, b, relu=relu)
        if skip is not None:
            skip = skip.to(self.dtype).contiguous()
        return fused_cheby_conv(band, x, W, b, relu=relu, skip=skip, skip_w=skip_w)

    def forward(self, art: PyramidArtifact, x: torch.Tensor) -> torch.Tensor:
        n_blocks, n_mesh = len(self.blocks), len(art.mesh_ops)
        if n_blocks != n_mesh + 2:
            raise ValueError(
                f"block schedule length {n_blocks} incompatible with pyramid of "
                f"{n_mesh} mesh levels (need n_mesh + 2)")

        def op_for_block(i: int) -> LevelOperator:
            if i == 0:
                return art.joint_op
            if i == n_blocks - 1:
                return art.mesh_ops[0]
            return art.mesh_ops[n_mesh - i]

        B = x.shape[0]
        x = x.transpose(0, 1)  # (J, B, C_in): vertex-major throughout
        ci = 0
        for i, chans in enumerate(self.blocks):
            op = op_for_block(i)
            band = op.kind == "band"
            if band and x.shape[0] != op.padded_vertices:
                # band level straight after the FC: pad rows once
                x = F.pad(x, (0, 0, 0, 0, 0, op.padded_vertices - x.shape[0]))
            input_x = x
            has_skip = 0 < i < n_blocks - 1
            for li in range(len(chans) - 1):
                final = i == n_blocks - 1 and li == len(chans) - 2
                lin = self.cl[ci]
                ci += 1
                if not band:
                    x = self._dense_conv(op, x, lin, relu=not final)
                    continue
                skip = skip_w = None
                if has_skip and li == len(chans) - 2:
                    skip = input_x
                    if chans[0] != chans[-1]:
                        skip_w = self._skip_w(chans[0], chans[-1],
                                              self.dtype, x.device)
                x = self._band_conv(op, x, lin, relu=not final, final=final,
                                    skip=skip, skip_w=skip_w)

            if i == 0:
                # FC "upsample": joint graph -> coarsest mesh level
                f = self.blocks[1][0]
                flat = x.transpose(0, 1).reshape(B, -1)
                x = linear(flat, self.fc, self.dtype)
                x = x.reshape(B, -1, f).transpose(0, 1)
            elif i < n_blocks - 1:
                if not band:
                    # channel-interpolated residual skip (fused on band levels)
                    res = input_x.to(x.dtype)
                    if res.shape[-1] != x.shape[-1]:
                        M = self._skip_w(res.shape[-1], x.shape[-1], x.dtype, x.device)
                        res = res @ M
                    x = x + res
                if i < n_blocks - 2:
                    # x2 nearest vertex upsample: a precomputed gather
                    up = art.up_idx[n_mesh - i - 1]
                    next_op = op_for_block(i + 1)
                    if next_op.kind == "band":
                        up = F.pad(up, (0, next_op.padded_vertices - up.shape[0]))
                    x = x.index_select(0, up)
        x = x[:art.mesh_ops[0].num_vertices]
        # (V, B, 3) -> (B, V, 3); coordinates leave the net in float32
        return x.transpose(0, 1).float()


def extract_mesh(art: PyramidArtifact, mesh_out: torch.Tensor) -> torch.Tensor:
    """(B, V_dev, 3) device-order output -> (B, V, 3) original vertex order."""
    return mesh_out.index_select(1, art.vertex_gather)
