"""MeshNet: Chebyshev graph-CNN decoding a pose into a mesh.

The network walks the coarsening pyramid coarse -> fine: a block of K=3
Chebyshev convs per level, an FC "upsample" from the joint graph onto the
coarsest mesh level, channel-interpolated residual skips, and x2 nearest
vertex upsampling between levels as index gathers.  It comes in two forms.

Deploy form (`inference_fused=True`): BatchNorm is folded into the conv
weights (`models.fold`) and each conv is one pass.
  * Dense levels (the joint graph and small mesh levels) run
    `ops.dense_cheby.dense_cheby_stack` + matmul + ReLU.
  * Band levels run on a vertex-major (Vp, B, F) layout at the pack-time
    padded row count Vp.  `flat_impl` picks the fused kernels (the JAX
    package's P2M_FLAT_IMPL, routed per level by `flat_route`), each with
    the block's residual skip fused into the last conv:
      "group": `ops.fused_cheby`; a conv that narrows its channels (no skip,
        not the final conv) takes the commuted kernel;
      "strip": `ops.strip_cheby` on the level's strip form, commuted order
        where the conv narrows its channels;
      "window": `ops.window_cheby` on the sliding-window form.
    `fused=False` (the JAX package's P2M_FUSED=0) takes none of them: each
    conv is two differentiable hops (`ops.hop`) and three projections
    (`ops.fused_cheby_train.cheby_project_unfused`), then ReLU, and the skip
    is an add after the block.
  Pad rows (>= num_vertices) carry values that never reach a real row; the
  gathers into a band level index row 0 for them.

Training form (`inference_fused=False`, `forward(art, x, train)`): every
conv but the last has a BatchNorm (`bn.N`), batch statistics in float32 in
training, running ones at eval; activations stay (V, B, F) at the real row
count.
  * Dense levels: `dense_cheby_stack` + matmul, BatchNorm, ReLU.
  * Band levels: the fused training convs of `ops.fused_cheby_train`, in the
    JAX package's fold chain: a conv that is not the last of its block
    hands its BatchNorm's (scale, shift) to the next conv, which applies
    relu(x*scale + shift) on its input read; training convs also emit their
    own batch-stat sums.  The block's last conv applies its BatchNorm and
    ReLU to its output; the network's last conv has neither.
  The residual skip is an add after the block.  With `fused=False` the convs
  that the JAX package sends through `fused_cheby_project` (in eval, the first
  conv of each band block) take its unfused form.

On a mesh (`mesh`, set by `Pose2Mesh.use_mesh`), the JAX package's
spmd_mesh: x holds this data rank's rows of the batch, and every BatchNorm
takes its statistics over the global batch (`posenet.bn_affine`).  With a
graph axis > 1 the band levels of kind "halo" (`parallel.sharding.
shard_artifact`) hold this graph rank's rows, padded to the level's tile
count over the axis; dense levels (and band levels too small to split) are
replicated on the graph ranks.  On a halo level each conv is the JAX halo
branch: the basis through `parallel.halo.halo_banded_hop`, stacked as
`chebyshev_stack` stacks it, projected by `linear`; in the training form its
pad rows are zeroed and its BatchNorm (`masked_batch_norm`) sums the rows of
every rank of the world over the real row count.  No fold chain and no fused
kernel there, as in the JAX package.  Level transitions: out of a halo
level `collectives.gather_rows` (the upsample gathers on the replicated
tensor), into one the padded replicated rows through `scatter_rows`; the
mesh output is gathered once at the end and its pad rows dropped.

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
from ..ops.dense_cheby import dense_cheby_stack
from ..ops.fused_cheby import fused_cheby_conv, fused_cheby_conv_commuted
from ..ops.fused_cheby_train import (
    cheby_project_unfused, fused_cheby_project, fused_cheby_project_folded,
    fused_cheby_project_folded_stats, fused_cheby_project_stats,
)
from ..ops.strip_cheby import strip_cheby_conv, strip_mode
from ..ops.window_cheby import window_cheby_conv
from ..parallel.audit import FINAL_ROWS, LEVEL_ENTRY, LEVEL_TRANSITION
from ..parallel.collectives import gather_rows, scatter_rows
from ..parallel.halo import global_rows, halo_banded_hop, row_mask
from ..utils.profiling import dtype_name, span
from .posenet import bn_affine, linear

__all__ = ["MeshNet", "channel_interp_matrix", "flat_route", "FLAT_IMPLS",
           "masked_batch_norm", "SMPL_BLOCKS", "MANO_BLOCKS",
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
    inference_fused: the deploy form (BatchNorm folded) or the training form.
    flat_impl, fused: the band convs' kernels (see the module note)."""

    def __init__(self, num_joint: int, coarse_vertices: int,
                 blocks: Sequence[Sequence[int]] = SMPL_BLOCKS, K: int = 3,
                 dtype: torch.dtype = torch.float32, inference_fused: bool = True,
                 flat_impl: str = "group", fused: bool = True):
        super().__init__()
        if K != 3:
            raise NotImplementedError("the band-level kernels are K=3 convs")
        self.flat_impl, self.fused = _check_path(flat_impl, fused)
        self.blocks = tuple(tuple(c) for c in blocks)
        self.K = K
        self.dtype = dtype
        self.dtype_name = dtype_name(dtype)   # the band convs' span attribute
        self.inference_fused = inference_fused
        self.mesh = None
        self.cl = nn.ModuleList(
            nn.Linear(c[li] * K, c[li + 1])
            for c in self.blocks for li in range(len(c) - 1))
        if not inference_fused:
            self.bn = nn.ModuleList(nn.BatchNorm1d(lin.out_features, eps=1e-5)
                                    for lin in list(self.cl)[:-1])
        self.fc = nn.Linear(num_joint * self.blocks[0][-1],
                            coarse_vertices * self.blocks[1][0])
        self._interp = {}

    def _skip_w(self, fin: int, fout: int, dtype, device) -> torch.Tensor:
        """(fin, fout) channel-interpolation matrix, cached per dtype/device."""
        key = (fin, fout, dtype, device)
        if key not in self._interp:
            M = torch.from_numpy(channel_interp_matrix(fin, fout).T.copy())
            self._interp[key] = M.to(device=device, dtype=dtype)
        return self._interp[key]

    def _dense_conv(self, op: LevelOperator, x, lin: nn.Linear, relu: bool = False):
        """One conv on a dense level: the basis (`dense_cheby_stack`) and its
        projection, then the ReLU where `relu`."""
        with span("p2m.dense_conv", dtype=self.dtype_name, vertices=op.num_vertices):
            y = linear(dense_cheby_stack(op, x.to(self.dtype)), lin, self.dtype)
            return torch.relu(y) if relu else y

    def _conv_weights(self, lin: nn.Linear, commuted: bool = False):
        """The kernels' weight layout of one band conv, (3*fin, fout) and
        (fout,) in the compute dtype: basis-major [W_x; W_Lx; W_cheb2], or
        [W_x - W_cheb2; W_Lx; W_cheb2] for the commuted kernel.  Derived
        from the parameters on every call, so a captured step reads them as
        they are; differentiable back to them."""
        fout, fin_k = lin.weight.shape
        fin = fin_k // self.K
        # fin-major (fin*K, fout) -> basis-major
        W = lin.weight.to(self.dtype).t().reshape(fin, self.K, fout).permute(1, 0, 2)
        if commuted:
            W = torch.stack([W[0] - W[2], W[1], W[2]])
        return W.reshape(self.K * fin, fout).contiguous(), lin.bias.to(self.dtype)

    def _band_conv(self, op: LevelOperator, x, lin: nn.Linear, route: str, *,
                   relu: bool, final: bool, skip=None, skip_w=None):
        """One deploy conv on a band level by `route`: "unfused" or a
        `flat_route` kernel family, whose "group" conv takes the commuted
        kernel where it narrows its channels, has no skip and is not the
        network's last."""
        fout, fin_k = lin.weight.shape
        fin = fin_k // self.K
        if route == "group" and fout < fin and skip is None and not final:
            route = "commuted"
        with span("p2m.band_conv", route=route, dtype=self.dtype_name):
            x = x.to(self.dtype).contiguous()
            if skip is not None:
                skip = skip.to(self.dtype).contiguous()
            mode = strip_mode(fin, fout) if route == "strip" else None
            W, b = self._conv_weights(lin, route == "commuted" or mode == "commuted")
            if route == "strip":
                return strip_cheby_conv(op.strip_val.to(self.dtype), op.strip_off,
                                        op.strip_h, x, W, b, mode=mode, relu=relu,
                                        skip=skip, skip_w=skip_w)
            if route == "window":
                return window_cheby_conv(op.window_val.to(self.dtype), op.window_off, x,
                                         W, b, relu=relu, skip=skip, skip_w=skip_w)
            band = op.band_val.to(self.dtype)
            if route == "unfused":
                y = cheby_project_unfused(band, x, W, b)
                return torch.relu(y) if relu else y
            if route == "commuted":
                return fused_cheby_conv_commuted(band, x, W, b, relu=relu)
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
        split = False  # whether x holds this graph rank's rows of a halo level
        for i, chans in enumerate(self.blocks):
            op = ops[i]
            with span("p2m.meshnet.block", i=i, kind=op.kind, vertices=op.num_vertices):
                band = op.kind == "band"
                route = None
                if band:
                    route = flat_route(op, self.flat_impl) if self.fused else "unfused"
                fuse_skip = band and self.fused
                if band and x.shape[0] != op.padded_vertices:
                    # band level straight after the FC: pad rows once
                    x = F.pad(x, (0, 0, 0, 0, 0, op.padded_vertices - x.shape[0]))
                if op.kind == "halo" and not split:
                    x, split = self._split(op, x), True
                input_x = x
                has_skip = 0 < i < n_blocks - 1
                for li in range(len(chans) - 1):
                    final = i == n_blocks - 1 and li == len(chans) - 2
                    lin = self.cl[ci]
                    ci += 1
                    if op.kind == "halo":
                        x = linear(self._halo_stack(op, x), lin, self.dtype)
                        x = x if final else torch.relu(x)
                        continue
                    if not band:
                        x = self._dense_conv(op, x, lin, relu=not final)
                        continue
                    skip = skip_w = None
                    if fuse_skip and has_skip and li == len(chans) - 2:
                        skip = input_x
                        if chans[0] != chans[-1]:
                            skip_w = self._skip_w(chans[0], chans[-1],
                                                  self.dtype, x.device)
                    x = self._band_conv(op, x, lin, route, relu=not final, final=final,
                                        skip=skip, skip_w=skip_w)

                if i == 0:
                    x = self._fc_upsample(x, B)
                elif i < n_blocks - 1:
                    if not fuse_skip:
                        # channel-interpolated residual skip (fused into the
                        # fused kernels' last conv)
                        x = self._skip(x, input_x)
                    if i < n_blocks - 2:
                        # x2 nearest vertex upsample: a precomputed gather
                        if split:
                            x, split = self._gather(x, LEVEL_TRANSITION), False
                        up = art.up_idx[n_mesh - i - 1]
                        if ops[i + 1].kind == "band":
                            up = F.pad(up, (0, ops[i + 1].padded_vertices - up.shape[0]))
                        x = x.index_select(0, up)
        if split:
            x = self._gather(x, FINAL_ROWS)
        x = x[:art.mesh_ops[0].num_vertices]
        # (V, B, 3) -> (B, V, 3); coordinates leave the net in float32
        return x.transpose(0, 1).float()

    # ---- the graph axis ---------------------------------------------------

    def _split(self, op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
        """The replicated (V, B, F) rows entering halo level `op`, zero-padded
        to the level's rows over the graph axis: this rank's share."""
        x = F.pad(x, (0, 0, 0, 0, 0, global_rows(op, self.mesh.graph) - x.shape[0]))
        return scatter_rows(x, self.mesh, "graph", site=LEVEL_ENTRY)

    def _gather(self, x: torch.Tensor, site: str) -> torch.Tensor:
        return gather_rows(x, self.mesh, "graph", site=site)

    def _halo_stack(self, op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
        """The fin-major Chebyshev stack [x, Lx, 2L(Lx) - x] of this rank's
        rows, each hop a halo hop."""
        x = x.to(self.dtype)
        z1 = halo_banded_hop(op, x, self.mesh)
        z2 = 2.0 * halo_banded_hop(op, z1, self.mesh) - x
        return torch.stack([x, z1, z2], dim=-1).reshape(x.shape[:-1] + (3 * x.shape[-1],))

    def _halo_block(self, op: LevelOperator, x, convs, bns, train: bool):
        """One block's convs on a halo level: projection, pad rows zeroed,
        masked BatchNorm and ReLU (none after the network's last conv)."""
        mask = row_mask(op, self.mesh.graph_rank, x.device)
        for lin, bn in zip(convs, bns):
            y = torch.where(mask, linear(self._halo_stack(op, x), lin, self.dtype), 0.0)
            x = y if bn is None else torch.relu(
                masked_batch_norm(y, bn, train, op.num_vertices, mask, self.mesh))
        return x

    def graph_split_parameters(self, art: PyramidArtifact):
        """The parameters of the convs on `art`'s halo levels and of their
        BatchNorms: each graph rank holds their gradient for its rows only."""
        ops, out, ci = self._ops(art), [], 0
        bns = list(self.bn) if hasattr(self, "bn") else []
        for op, chans in zip(ops, self.blocks):
            for c in range(ci, ci + len(chans) - 1):
                if op.kind == "halo":
                    out += list(self.cl[c].parameters())
                    out += list(bns[c].parameters()) if c < len(bns) else []
            ci += len(chans) - 1
        return out

    # ---- training form --------------------------------------------------

    def _bn_apply_relu(self, y, bn, train, sums=None):
        """relu(BatchNorm(y)): the affine in float32, rounded to the compute
        dtype; batch statistics of y unless the kernel's sums are given."""
        scale, shift = self._bn_scale_shift(y, bn, train, sums)
        return torch.relu((y.float() * scale + shift).to(self.dtype))

    def _bn_scale_shift(self, y, bn, train, sums=None):
        if train and sums is None:
            yf = y.float()
            sums = (yf.sum((0, 1)), (yf * yf).sum((0, 1)))
        data = self.mesh.data if self.mesh is not None else 1
        return bn_affine(bn, sums, y.shape[0] * y.shape[1] * data, train, self.mesh)

    def _band_block(self, op: LevelOperator, x, convs, bns, train: bool):
        """One block's convs on a band level, as the JAX fold chain: a conv
        that is not the block's last hands its BatchNorm affine to the next
        conv's input read.  bns[li] is None for the network's last conv.
        fused=False: a conv without fold or stats takes the unfused form."""
        band = op.band_val.to(self.dtype)
        fold = None
        for li, (lin, bn) in enumerate(zip(convs, bns)):
            stats = train and bn is not None
            unfused = fold is None and not stats and not self.fused
            with span("p2m.band_conv", route="unfused" if unfused else "train",
                      dtype=self.dtype_name):
                W, b = self._conv_weights(lin)
                x = x.to(self.dtype).contiguous()
                if fold is None:
                    out = (fused_cheby_project_stats(band, x, W, b) if stats
                           else fused_cheby_project(band, x, W, b, fused=self.fused))
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
        split = False  # whether x holds this graph rank's rows of a halo level
        for i, chans in enumerate(self.blocks):
            op, n = ops[i], len(chans) - 1
            with span("p2m.meshnet.block", i=i, kind=op.kind, vertices=op.num_vertices):
                convs, block_bns = self.cl[ci:ci + n], bns[ci:ci + n]
                ci += n
                if op.kind == "halo" and not split:
                    x, split = self._split(op, x), True
                input_x = x
                if op.kind == "halo":
                    x = self._halo_block(op, x, convs, block_bns, train)
                elif op.kind == "band":
                    x = self._band_block(op, x, convs, block_bns, train)
                else:
                    for lin, bn in zip(convs, block_bns):
                        x = self._dense_conv(op, x, lin)
                        if bn is not None:
                            x = self._bn_apply_relu(x, bn, train)
                if i == 0:
                    x = self._fc_upsample(x, B)
                elif i < n_blocks - 1:
                    x = self._skip(x, input_x)
                    if i < n_blocks - 2:
                        if split:
                            x, split = self._gather(x, LEVEL_TRANSITION), False
                        x = x.index_select(0, art.up_idx[n_mesh - i - 1])
        if split:
            x = self._gather(x, FINAL_ROWS)[:art.mesh_ops[0].num_vertices]
        # (V, B, 3) -> (B, V, 3); coordinates leave the net in float32
        return x.transpose(0, 1).float()


def masked_batch_norm(y: torch.Tensor, bn: nn.BatchNorm1d, train: bool, real_rows: int,
                      mask: torch.Tensor, mesh) -> torch.Tensor:
    """BatchNorm of this graph rank's (rows, B, F) share of a halo level
    whose pad rows (mask False) are zero: in training the sums over every
    rank of the world, divided by the real rows of the global batch
    (real_rows B D), as the JAX `_MaskedBatchNorm` divides on the whole
    padded tensor; pad rows zero again after.  Float32, cast back."""
    yf = y.float()
    sums = (yf.sum((0, 1)), (yf * yf).sum((0, 1))) if train else None
    scale, shift = bn_affine(bn, sums, real_rows * y.shape[1] * mesh.data, train, mesh,
                             "world")
    return torch.where(mask, (yf * scale + shift).to(y.dtype), 0.0)


FLAT_IMPLS = ("group", "strip", "window")


def flat_route(op: LevelOperator, impl: str) -> str:
    """The kernel family a deploy conv on band level `op` takes under `impl`,
    by the level's shapes, as the JAX package's `fused_conv_flat_dispatch`
    does under P2M_FLAT_IMPL without its VMEM-size limits: "strip" where the
    level has a strip form, "window" where it has the window form (nt >=
    2k+1 row tiles), else "group"."""
    if impl not in FLAT_IMPLS:
        raise ValueError(f"flat_impl={impl!r}: expected one of {FLAT_IMPLS}")
    if impl == "strip" and op.strip_h and op.strip_val.numel() \
            and op.strip_val.shape[0] >= op.strip_val.shape[1]:
        return "strip"
    if impl == "window" and op.window_val.numel():
        return "window"
    return "group"


def _check_path(flat_impl: str, fused: bool) -> Tuple[str, bool]:
    if flat_impl not in FLAT_IMPLS:
        raise ValueError(f"flat_impl={flat_impl!r}: expected one of {FLAT_IMPLS}")
    if not isinstance(fused, bool):
        raise ValueError(f"fused={fused!r}: expected True or False")
    if not fused and flat_impl != "group":
        raise ValueError(f"flat_impl={flat_impl!r} picks fused kernels; fused=False "
                         f"takes none")
    return flat_impl, fused


def extract_mesh(art: PyramidArtifact, mesh_out: torch.Tensor) -> torch.Tensor:
    """(B, V_dev, 3) device-order output -> (B, V, 3) original vertex order."""
    return mesh_out.index_select(1, art.vertex_gather)
