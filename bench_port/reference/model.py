"""The plain reference of the Pose2Mesh cascade: PoseNet, MeshNet, the eval
step, the five training losses and RMSprop, in plain PyTorch.

It follows the published model (hongsukchoi/Pose2Mesh_RELEASE,
lib/models/{posenet,meshnet}.py, lib/core/loss.py) with the port's
documented choices: Chebyshev K=3 convs over the rescaled Laplacians of
`pyramid.RefPyramid`, BatchNorm after every MeshNet conv but the last (never
folded here: eval uses the running statistics), the channel-interpolated
residual skip between blocks (`F.interpolate`, linear), nearest upsampling
by the coarsening tree, PoseNet's dropout keep masks drawn from the caller's
generator four times a step in the order the stages use them, the vertex,
normal, edge and two joint losses, and RMSprop (alpha 0.99, eps 1e-8).

Parameters and buffers are a dict under the reference's state-dict names
(`pose_lifter.*`, `pose2mesh.cl.N`, `pose2mesh.bn.N`, `pose2mesh.fc`), the
same tensors that the benchmark hands the program.  Precision "f32" is the
reference: float32 with TF32 off.  Precision "fp8" is the control, computed
one step below the configuration's bf16 as the program computes in bf16:
every product's operands (weights, activations, Laplacian values, the
regressor) and every activation it stores (each product's and hop's output,
BatchNorm-ReLU's, the skip sums) rounded to float8 e4m3 under a per-tensor
scale (amax / 448), products accumulating and BatchNorm's statistics taken
in float32; in the backward, as fp8 training's hybrid recipe has it, every
gradient that flows back through one of those rounding points is rounded to
float8 e5m2 under its own per-tensor scale (amax / 57344), so the
backward's products take fp8 operands and the optimizer gets fp8 weight
gradients.
Imports nothing of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .pyramid import RefPyramid

__all__ = ["RefModel", "fake_fp8", "set_reference_precision"]

FP8_MAX = 448.0            # float8 e4m3, the forward's
FP8_GRAD_MAX = 57344.0     # float8 e5m2, the gradients'
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
RMSPROP_ALPHA, RMSPROP_EPS = 0.99, 1e-8   # torch's defaults, as the port uses them


def set_reference_precision() -> None:
    """float32 products stay float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn, top=FP8_MAX) -> torch.Tensor:
    amax = t.abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return t
    s = amax / top
    return (t / s).to(dtype).float() * s


class _Fp8(torch.autograd.Function):
    """Rounds the value to e4m3 on the way forward and its gradient to e5m2
    on the way back."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in float32;
    its gradient is rounded to float8 e5m2."""
    return _Fp8.apply(t) if t.requires_grad else _round_fp8(t)


def _csr(L, device, fp8: bool) -> torch.Tensor:
    L = L.tocsr().astype(np.float32)
    vals = torch.from_numpy(L.data.copy())
    if fp8:
        vals = fake_fp8(vals)
    return torch.sparse_csr_tensor(torch.from_numpy(L.indptr.astype(np.int64)),
                                   torch.from_numpy(L.indices.astype(np.int64)), vals,
                                   size=L.shape, device=device)


class _Hop(torch.autograd.Function):
    """y = L x for x (V, ...); the backward is L^T g."""

    @staticmethod
    def forward(ctx, L, Lt, x):
        ctx.Lt = Lt
        return torch.sparse.mm(L, x.reshape(x.shape[0], -1)).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        gx = torch.sparse.mm(ctx.Lt, g.reshape(g.shape[0], -1)).reshape(g.shape)
        return None, None, gx


class RefModel:
    """The cascade over `pyr`, with `j_regressor` (J, V) regressing the eval
    step's joints and the joint loss's, on `device`.  cfg: the
    configuration's dict (blocks, posenet_stages, dropout, loss_weights,
    optimizer: RMSprop only).  params: the state dict (float32); fault
    "half_batch" takes each training step over the first half of its batch
    only (a planted fault, for calibration)."""

    def __init__(self, cfg: Dict, pyr: RefPyramid, j_regressor: np.ndarray,
                 params: Dict[str, torch.Tensor], device, precision: str = "f32",
                 fault: Optional[str] = None):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        if cfg["optimizer"]["name"] != "rmsprop":
            raise ValueError(f"optimizer {cfg['optimizer']['name']!r}: the reference is RMSprop")
        set_reference_precision()
        self.cfg, self.device = cfg, torch.device(device)
        self.fp8, self.fault = precision == "fp8", fault
        self.q = fake_fp8 if self.fp8 else (lambda t: t)
        self.blocks = [list(b) for b in cfg["blocks"]]
        mk = lambda L: (_csr(L, device, self.fp8), _csr(L.T, device, self.fp8))  # noqa: E731
        self.mesh_ops = [mk(L) for L in pyr.laplacians]
        self.joint_op = mk(pyr.joint_laplacian)
        self.up = [torch.from_numpy(u).to(device) for u in pyr.up]
        self.vertex_row = torch.from_numpy(pyr.vertex_row).to(device)
        self.jreg = torch.as_tensor(j_regressor, dtype=torch.float32, device=device)
        self.p = {k: v.detach().clone().float() if v.is_floating_point() else v.clone()
                  for k, v in params.items()}
        self.trainable = [k for k in self.p
                          if self.p[k].is_floating_point() and "running_" not in k]
        self.sq = {}
        self.bn_momentum, self.dropout = BN_MOMENTUM, True
        if len(self.blocks) != len(self.mesh_ops) + 2:
            raise ValueError("block schedule does not fit the pyramid")

    # ---- layers -----------------------------------------------------------

    def _linear(self, x, name):
        q = self.q
        return q(F.linear(q(x), q(self.p[name + ".weight"]), self.p[name + ".bias"]))

    def _bn(self, x, name, train):
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), self.p[name + ".running_mean"],
                         self.p[name + ".running_var"], self.p[name + ".weight"],
                         self.p[name + ".bias"], training=train, momentum=self.bn_momentum,
                         eps=BN_EPS)
        return y.reshape(shape)

    def _hop(self, op, x):
        return self.q(_Hop.apply(op[0], op[1], self.q(x)))

    def _conv(self, op, x, ci):
        """The Chebyshev conv cl.ci: [x, Lx, 2L(Lx) - x] stacked fin-major,
        then the projection."""
        z1 = self._hop(op, x)
        z2 = self.q(2.0 * self._hop(op, z1) - x)
        s = torch.stack([x, z1, z2], dim=-1).reshape(x.shape[:-1] + (3 * x.shape[-1],))
        return self._linear(s, f"pose2mesh.cl.{ci}")

    def _dropout(self, x, gen):
        rate = float(self.cfg["dropout"])
        keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=gen)
        return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))

    def posenet(self, x2d, train=False, gen=None):
        y = self._linear(x2d.reshape(x2d.shape[0], -1), "pose_lifter.w1")
        for s in range(int(self.cfg["posenet_stages"])):
            pre = f"pose_lifter.linear_stages.{s}."
            h = self.q(torch.relu(self._bn(y, pre + "batch_norm1", train)))
            h = self._linear(self._dropout(h, gen) if train and self.dropout else h,
                             pre + "w1")
            h = self.q(torch.relu(self._bn(h, pre + "batch_norm2", train)))
            h = self._linear(self._dropout(h, gen) if train and self.dropout else h,
                             pre + "w2")
            y = self.q(y + h)
        return self._linear(y, "pose_lifter.w2")

    def meshnet(self, feats, train=False):
        """feats (B, J, C) -> mesh (B, V, 3) in original vertex order."""
        ops = [self.joint_op] + self.mesh_ops[::-1] + [self.mesh_ops[0]]
        nb, n_mesh, B = len(self.blocks), len(self.mesh_ops), feats.shape[0]
        x = feats.transpose(0, 1)
        ci = 0
        for i, chans in enumerate(self.blocks):
            inp = x
            for li in range(len(chans) - 1):
                final = i == nb - 1 and li == len(chans) - 2
                x = self._conv(ops[i], x, ci)
                if not final:
                    x = self.q(torch.relu(self._bn(x, f"pose2mesh.bn.{ci}", train)))
                ci += 1
            if i == 0:
                f = self.blocks[1][0]
                flat = x.transpose(0, 1).reshape(B, -1)
                x = self._linear(flat, "pose2mesh.fc").reshape(B, -1, f).transpose(0, 1)
            elif i < nb - 1:
                res = inp
                if res.shape[-1] != x.shape[-1]:
                    r = self.q(res).reshape(-1, 1, res.shape[-1])
                    res = F.interpolate(r, size=x.shape[-1], mode="linear",
                                        align_corners=False).reshape(x.shape)
                x = self.q(x + res)
                if i < nb - 2:
                    x = x.index_select(0, self.up[n_mesh - i - 1])
        return x.index_select(0, self.vertex_row).transpose(0, 1)

    def forward(self, pose2d, train=False, gen=None) -> Tuple[torch.Tensor, torch.Tensor]:
        B, J = pose2d.shape[0], pose2d.shape[1]
        pose3d = self.posenet(pose2d, train, gen).reshape(B, J, 3)
        feats = torch.cat([pose2d.float(), pose3d.detach() / 1000.0], dim=2)
        return self.meshnet(feats, train), pose3d

    @torch.no_grad()
    def batch_norm_statistics(self, pose2d) -> Dict[str, torch.Tensor]:
        """Every BatchNorm's running statistics set to its batch statistics
        on `pose2d` (mean, unbiased variance; training-mode normalisation,
        no dropout), as a trained model carries statistics that match its
        activations; returned under their state-dict names."""
        self.bn_momentum, self.dropout = 1.0, False
        try:
            self.forward(pose2d.to(self.device).float(), train=True)
        finally:
            self.bn_momentum, self.dropout = BN_MOMENTUM, True
        return {k: v.clone() for k, v in self.p.items() if ".running_" in k}

    def regress(self, mesh_mm):
        return torch.einsum("jv,bvc->bjc", self.q(self.jreg), self.q(mesh_mm))

    # ---- steps ------------------------------------------------------------

    @torch.no_grad()
    def eval_step(self, pose2d):
        """(mesh mm (B, V, 3), regressed joints mm (B, J, 3), lifted pose mm
        (B, J, 3)), as the eval step returns them."""
        mesh, pose3d = self.forward(pose2d.to(self.device).float())
        mesh_mm = mesh * 1000.0
        return mesh_mm, self.regress(mesh_mm), pose3d

    def losses(self, mesh, pose3d, reg, batch, faces):
        w = self.cfg["loss_weights"]

        def l1(a, b, v):
            return (a * v - b * v).abs().mean()

        tgt = batch["mesh"].float()
        p, g = mesh[:, faces], tgt[:, faces]  # (B, F, corner, 3)
        n = lambda v: F.normalize(v, dim=-1)  # noqa: E731
        ng = n(torch.linalg.cross(n(g[:, :, 1] - g[:, :, 0]), n(g[:, :, 2] - g[:, :, 0]),
                                  dim=-1))
        cos = [(n(p[:, :, b] - p[:, :, a]) * ng).sum(-1).abs()
               for a, b in ((0, 1), (0, 2), (1, 2))]
        edge = [((p[:, :, a] - p[:, :, b]).norm(dim=-1)
                 - (g[:, :, a] - g[:, :, b]).norm(dim=-1)).abs()
                for a, b in ((0, 1), (0, 2), (1, 2))]
        out = {
            "vertex": l1(mesh, tgt, batch["mesh_valid"]),
            "normal": w["normal"] * torch.stack(cos).mean(),
            "edge": w["edge"] * torch.stack(edge).mean(),
            "reg_joint": w["joint"] * l1(reg, batch["reg_pose3d"], batch["reg_pose3d_valid"]),
            "lift_joint": w["joint"] * l1(pose3d, batch["lift_pose3d"],
                                          batch["lift_pose3d_valid"]),
        }
        out["total"] = sum(out[k] for k in ("vertex", "normal", "edge", "reg_joint",
                                            "lift_joint"))
        return out

    def train_step(self, batch: Dict[str, torch.Tensor], faces: torch.Tensor,
                   gen: torch.Generator) -> Dict[str, float]:
        """One step: forward in training mode, the losses, the backward and
        RMSprop; returns the losses and leaves each parameter's gradient in
        self.grads."""
        if self.fault == "half_batch":
            half = batch["pose2d"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        for k in self.trainable:
            self.p[k].requires_grad_(True)
        mesh, pose3d = self.forward(batch["pose2d"], True, gen)
        reg = self.regress(mesh * 1000.0)
        losses = self.losses(mesh, pose3d, reg, batch, faces)
        grads = torch.autograd.grad(losses["total"], [self.p[k] for k in self.trainable],
                                    allow_unused=True)
        alpha, eps, lr = RMSPROP_ALPHA, RMSPROP_EPS, float(self.cfg["optimizer"]["lr"])
        self.grads = {}
        with torch.no_grad():
            for k, g in zip(self.trainable, grads):
                if g is None:
                    g = torch.zeros_like(self.p[k])
                self.grads[k] = g
                sq = self.sq.setdefault(k, torch.zeros_like(g))
                sq.mul_(alpha).addcmul_(g, g, value=1.0 - alpha)
                self.p[k].requires_grad_(False)
                self.p[k].addcdiv_(g, sq.sqrt().add_(eps), value=-lr)
        return {k: float(v.detach()) for k, v in losses.items()}

    def params(self, names: Sequence[str]) -> Dict[str, torch.Tensor]:
        return {k: self.p[k] for k in names}
