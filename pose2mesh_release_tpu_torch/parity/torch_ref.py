"""Reference-architecture torch model, the reference's own arithmetic.

Implements the same computation as the reference cascade
(lib/models/pose2mesh_net.py:8-22, posenet.py:11-87, meshnet.py:11-117,
backbones/cheby_graph_conv.py:5-42) with the same state-dict key names
(w1 / batch_norm1 / linear_stages.N / cl.N / bn.N / fc), so that real
reference checkpoints load unmodified and a `torch.save` of its state dict
is a reference-layout `.pth.tar`.  It is a reference, as the kernels' plain
versions are: the port's main path does not use it.  It runs on any device
(`.to(device)` moves the Laplacians too, kept as buffers outside the state
dict); the Chebyshev hops are `torch.sparse.mm` in float32.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _to_torch_sparse(L) -> torch.Tensor:
    L = L.tocoo()
    idx = torch.from_numpy(np.stack([L.row, L.col]).astype(np.int64))
    val = torch.from_numpy(L.data.astype(np.float32))
    return torch.sparse_coo_tensor(idx, val, L.shape, check_invariants=True).coalesce()


def cheby_conv(x: torch.Tensor, lin: nn.Linear, bn, L: torch.Tensor,
               fout: int, K: int) -> torch.Tensor:
    """K-term Chebyshev conv, fin-major stacked basis
    (cheby_graph_conv.py:5-42 semantics)."""
    B, V, fin = x.shape
    x0 = x.permute(1, 2, 0).reshape(V, fin * B)
    basis = [x0]
    if K > 1:
        basis.append(torch.sparse.mm(L, x0))
    for _ in range(2, K):
        basis.append(2.0 * torch.sparse.mm(L, basis[-1]) - basis[-2])
    xt = torch.stack(basis)                            # (K, V, fin*B)
    xt = xt.reshape(K, V, fin, B).permute(3, 1, 2, 0)  # (B, V, fin, K)
    y = lin(xt.reshape(B * V, fin * K))
    if bn is not None:
        y = bn(y)
    return y.reshape(B, V, fout)


class RefPoseNet(nn.Module):
    """State-dict-compatible lifter (posenet.py:11-87)."""

    def __init__(self, num_joint: int, hidden: int = 4096, stages: int = 2,
                 p_dropout: float = 0.5):
        super().__init__()
        self.w1 = nn.Linear(num_joint * 2, hidden)
        self.batch_norm1 = nn.BatchNorm1d(hidden)  # present but unused in
        # the reference forward (posenet.py:77-87)

        class Stage(nn.Module):
            def __init__(self):
                super().__init__()
                self.w1 = nn.Linear(hidden, hidden)
                self.batch_norm1 = nn.BatchNorm1d(hidden)
                self.w2 = nn.Linear(hidden, hidden)
                self.batch_norm2 = nn.BatchNorm1d(hidden)
                self.dropout = nn.Dropout(p_dropout)

            def forward(self, x):
                y = self.dropout(F.relu(self.batch_norm1(x)))
                y = self.w1(y)
                y = self.dropout(F.relu(self.batch_norm2(y)))
                return x + self.w2(y)

        self.linear_stages = nn.ModuleList(Stage() for _ in range(stages))
        self.w2 = nn.Linear(hidden, num_joint * 3)

    def forward(self, x):
        y = self.w1(x)
        for stage in self.linear_stages:
            y = stage(y)
        return self.w2(y)


class RefMeshNet(nn.Module):
    """State-dict-compatible graph CNN (meshnet.py:11-117).

    laplacians: scipy rescaled Laplacians [finest mesh, ..., coarsest mesh,
    joint graph] — i.e. the reference's graph_L AFTER `del graph_L[-2]`.
    """

    def __init__(self, blocks: Sequence[Sequence[int]], laplacians,
                 K: int = 3):
        super().__init__()
        self.blocks = [tuple(b) for b in blocks]
        self.K = K
        for i, L in enumerate(laplacians):
            self.register_buffer(f"L{i}", _to_torch_sparse(L), persistent=False)
        self.num_laplacians = len(laplacians)

        v_joint = laplacians[-1].shape[0]
        v_coarse = laplacians[-2].shape[0]
        self.fc = nn.Linear(v_joint * self.blocks[0][-1],
                            v_coarse * self.blocks[1][0])

        cl, bn = [], []
        n = len(self.blocks)
        for i, chans in enumerate(self.blocks):
            for li in range(len(chans) - 1):
                cl.append(nn.Linear(K * chans[li], chans[li + 1]))
                last = i == n - 1 and li == len(chans) - 2
                bn.append(None if last else nn.BatchNorm1d(chans[li + 1]))
        self.cl = nn.ModuleList(cl)
        self.bn = nn.ModuleList([m for m in bn if m is not None])
        self._bn_slots = [m is not None for m in bn]

    @property
    def L(self) -> List[torch.Tensor]:
        return [getattr(self, f"L{i}") for i in range(self.num_laplacians)]

    def forward(self, x):
        n = len(self.blocks)
        L = self.L
        k = 0
        bn_iter = iter(self.bn)
        bns: List = [next(bn_iter) if has else None for has in self._bn_slots]
        for i, chans in enumerate(self.blocks):
            ldx = -(i + 1) if i < n - 1 else -n + 1
            input_x = x
            for li in range(len(chans) - 1):
                last = i == n - 1 and li == len(chans) - 2
                x = cheby_conv(x, self.cl[k], bns[k], L[ldx],
                               chans[li + 1], self.K)
                if not last:
                    x = F.relu(x)
                k += 1
            if i == 0:
                B = x.shape[0]
                v_coarse = L[-2].shape[0]
                x = self.fc(x.reshape(B, -1)).reshape(B, v_coarse,
                                                      self.blocks[1][0])
            elif i < n - 2:
                skip = F.interpolate(input_x, size=x.shape[2], mode="linear")
                x = skip + x
                x = x.repeat_interleave(2, dim=1)  # x2 nearest tree upsample
            elif i == n - 2:
                skip = F.interpolate(input_x, size=x.shape[2], mode="linear")
                x = skip + x
        return x


class RefCascade(nn.Module):
    """FlatPose2Mesh (pose2mesh_net.py:8-22): lift -> detach/1000 -> mesh."""

    def __init__(self, num_joint: int, blocks, laplacians, hidden: int = 4096):
        super().__init__()
        self.pose_lifter = RefPoseNet(num_joint, hidden)
        self.pose2mesh = RefMeshNet(blocks, laplacians)
        self.num_joint = num_joint

    def forward(self, pose2d):
        B = pose2d.shape[0]
        pose3d = self.pose_lifter(pose2d.reshape(B, -1))
        combined = torch.cat(
            (pose2d, pose3d.detach().reshape(B, self.num_joint, 3) / 1000.0),
            dim=2,
        )
        mesh = self.pose2mesh(combined)
        return mesh, pose3d.reshape(B, self.num_joint, 3)
