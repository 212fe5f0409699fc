"""MeshNet: Chebyshev graph-CNN decoding a pose into a mesh.

The network walks the coarsening pyramid coarse -> fine: a block of K=3
Chebyshev convs per level, an FC "upsample" from the joint graph onto the
coarsest mesh level, channel-interpolated residual skips, and x2 nearest
vertex upsampling between levels as index gathers.  It comes in two forms.

Deploy form (`inference_fused=True`): BatchNorm is folded into the conv
weights (`models.fold`) and each conv is one pass.
  * Dense levels (the joint graph and small mesh levels) run
    `chebyshev_stack` + matmul + ReLU.
  * Band levels run the fused kernels of `ops.fused_cheby` on a vertex-major
    (Vp, B, F) layout at the pack-time padded row count Vp, with the block's
    residual skip fused into the last conv.  A conv that narrows its
    channels (no skip, not the final conv) takes the commuted kernel.
  Pad rows (>= num_vertices) carry values that never reach a real row; the
  gathers into a band level index row 0 for them.

Training form (`inference_fused=False`, `forward(art, x, train)`): every
conv but the last has a BatchNorm (`bn.N`), batch statistics in float32 in
training, running ones at eval; activations stay (V, B, F) at the real row
count.
  * Dense levels: `chebyshev_stack` + matmul, BatchNorm, ReLU.
  * Band levels: the fused training convs of `ops.fused_cheby_train`, in the
    JAX package's fold chain: a conv that is not the last of its block
    hands its BatchNorm's (scale, shift) to the next conv, which applies
    relu(x*scale + shift) on its input read; training convs also emit their
    own batch-stat sums.  The block's last conv applies its BatchNorm and
    ReLU to its output; the network's last conv has neither.
  The residual skip is an add after the block.

Parameters follow the reference's state dict: `cl.N` (Linear over the
fin-major Chebyshev stack, weight (fout, fin*K)), `bn.N` and `fc`.
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
from ..ops.fused_cheby_train import (
    fused_cheby_project, fused_cheby_project_folded,
    fused_cheby_project_folded_stats, fused_cheby_project_stats,
)
from .posenet import bn_affine, linear

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
    (art.mesh_ops[-1].num_vertices), the FC layer's output size.
    inference_fused: the deploy form (BatchNorm folded) or the training form."""

    def __init__(self, num_joint: int, coarse_vertices: int,
                 blocks: Sequence[Sequence[int]] = SMPL_BLOCKS, K: int = 3,
                 dtype: torch.dtype = torch.float32, inference_fused: bool = True):
        super().__init__()
        if K != 3:
            raise NotImplementedError("the band-level kernels are K=3 convs")
        self.blocks = tuple(tuple(c) for c in blocks)
        self.K = K
        self.dtype = dtype
        self.inference_fused = inference_fused
        self.cl = nn.ModuleList(
            nn.Linear(c[li] * K, c[li + 1])
            for c in self.blocks for li in range(len(c) - 1))
        if not inference_fused:
            self.bn = nn.ModuleList(nn.BatchNorm1d(lin.out_features, eps=1e-5)
                                    for lin in list(self.cl)[:-1])
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

    def _ops(self, art: PyramidArtifact) -> Tuple[LevelOperator, ...]:
        """The level operator of each block: the joint graph, the mesh levels
        coarse -> fine, the finest level again."""
        n_blocks, n_mesh = len(self.blocks), len(art.mesh_ops)
        if n_blocks != n_mesh + 2:
            raise ValueError(
                f"block schedule length {n_blocks} incompatible with pyramid of "
                f"{n_mesh} mesh levels (need n_mesh + 2)")
        return (art.joint_op,) + art.mesh_ops[::-1] + (art.mesh_ops[0],)

    def _fc_upsample(self, x: torch.Tensor, B: int) -> torch.Tensor:
        """FC "upsample": (J, B, F) joint features -> (Vc, B, f) on the
        coarsest mesh level."""
        f = self.blocks[1][0]
        flat = x.transpose(0, 1).reshape(B, -1)
        return linear(flat, self.fc, self.dtype).reshape(B, -1, f).transpose(0, 1)

    def _skip(self, x: torch.Tensor, input_x: torch.Tensor) -> torch.Tensor:
        """x + the block input, channel-interpolated to x's width."""
        res = input_x.to(x.dtype)
        if res.shape[-1] != x.shape[-1]:
            res = res @ self._skip_w(res.shape[-1], x.shape[-1], x.dtype, x.device)
        return x + res

    def forward(self, art: PyramidArtifact, x: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        if not self.inference_fused:
            return self._forward_train_form(art, x, train)
        if train:
            raise ValueError("the deploy form (BatchNorm folded) does not train; "
                             "build MeshNet(inference_fused=False)")
        ops = self._ops(art)
        n_blocks, n_mesh = len(self.blocks), len(art.mesh_ops)
        B = x.shape[0]
        x = x.transpose(0, 1)  # (J, B, C_in): vertex-major throughout
        ci = 0
        for i, chans in enumerate(self.blocks):
            op = ops[i]
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
                x = self._fc_upsample(x, B)
            elif i < n_blocks - 1:
                if not band:
                    # channel-interpolated residual skip (fused on band levels)
                    x = self._skip(x, input_x)
                if i < n_blocks - 2:
                    # x2 nearest vertex upsample: a precomputed gather
                    up = art.up_idx[n_mesh - i - 1]
                    if ops[i + 1].kind == "band":
                        up = F.pad(up, (0, ops[i + 1].padded_vertices - up.shape[0]))
                    x = x.index_select(0, up)
        x = x[:art.mesh_ops[0].num_vertices]
        # (V, B, 3) -> (B, V, 3); coordinates leave the net in float32
        return x.transpose(0, 1).float()

    # ---- training form --------------------------------------------------

    def _basis_weights(self, lin: nn.Linear):
        """Basis-major (3*fin, fout) weight [W_x; W_Lx; W_cheb2] and the bias,
        in the compute dtype, differentiable back to the float32 parameters."""
        fout, fin_k = lin.weight.shape
        fin = fin_k // self.K
        W = lin.weight.to(self.dtype).t().reshape(fin, self.K, fout).permute(1, 0, 2)
        return W.reshape(self.K * fin, fout).contiguous(), lin.bias.to(self.dtype)

    def _bn_apply_relu(self, y, bn, train, sums=None):
        """relu(BatchNorm(y)): the affine in float32, rounded to the compute
        dtype; batch statistics of y unless the kernel's sums are given."""
        scale, shift = self._bn_scale_shift(y, bn, train, sums)
        return torch.relu((y.float() * scale + shift).to(self.dtype))

    def _bn_scale_shift(self, y, bn, train, sums=None):
        if train and sums is None:
            yf = y.float()
            sums = (yf.sum((0, 1)), (yf * yf).sum((0, 1)))
        return bn_affine(bn, sums, y.shape[0] * y.shape[1], train)

    def _band_block(self, op: LevelOperator, x, convs, bns, train: bool):
        """One block's convs on a band level, as the JAX fold chain: a conv
        that is not the block's last hands its BatchNorm affine to the next
        conv's input read.  bns[li] is None for the network's last conv."""
        band = op.band_val.to(self.dtype)
        fold = None
        for li, (lin, bn) in enumerate(zip(convs, bns)):
            W, b = self._basis_weights(lin)
            x = x.to(self.dtype).contiguous()
            stats = train and bn is not None
            if fold is None:
                conv = fused_cheby_project_stats if stats else fused_cheby_project
                out = conv(band, x, W, b)
            else:
                conv = (fused_cheby_project_folded_stats if stats
                        else fused_cheby_project_folded)
                out = conv(band, x, W, b, *fold)
            y, sums = (out[0], out[1:]) if stats else (out, None)
            if bn is None:
                x, fold = y, None
            elif li < len(convs) - 1:
                x, fold = y, self._bn_scale_shift(y, bn, train, sums)
            else:
                x, fold = self._bn_apply_relu(y, bn, train, sums), None
        return x

    def _forward_train_form(self, art: PyramidArtifact, x: torch.Tensor,
                            train: bool) -> torch.Tensor:
        ops = self._ops(art)
        n_blocks, n_mesh = len(self.blocks), len(art.mesh_ops)
        bns = list(self.bn) + [None]
        B = x.shape[0]
        x = x.transpose(0, 1)  # (J, B, C_in): vertex-major throughout
        ci = 0
        for i, chans in enumerate(self.blocks):
            op, n = ops[i], len(chans) - 1
            convs, block_bns = self.cl[ci:ci + n], bns[ci:ci + n]
            ci += n
            input_x = x
            if op.kind == "band":
                x = self._band_block(op, x, convs, block_bns, train)
            else:
                for lin, bn in zip(convs, block_bns):
                    x = linear(chebyshev_stack(op, x.to(self.dtype), self.K), lin,
                               self.dtype)
                    if bn is not None:
                        x = self._bn_apply_relu(x, bn, train)
            if i == 0:
                x = self._fc_upsample(x, B)
            elif i < n_blocks - 1:
                x = self._skip(x, input_x)
                if i < n_blocks - 2:
                    x = x.index_select(0, art.up_idx[n_mesh - i - 1])
        # (V, B, 3) -> (B, V, 3); coordinates leave the net in float32
        return x.transpose(0, 1).float()


def extract_mesh(art: PyramidArtifact, mesh_out: torch.Tensor) -> torch.Tensor:
    """(B, V_dev, 3) device-order output -> (B, V, 3) original vertex order."""
    return mesh_out.index_select(1, art.vertex_gather)
