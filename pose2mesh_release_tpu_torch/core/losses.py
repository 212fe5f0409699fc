"""Training losses of the cascade.

Same definitions as the JAX package's `core/losses.py` (the reference's
CoordLoss, normal-vector, edge-length and Laplacian losses and their
weighting).  The validity mask of the L1 losses scales both operands before
the mean over every element, masked ones included.  `_normalize` and the
edge length keep the JAX package's grad-safe forms: a zero-length edge or a
collapsed triangle yields zero, not NaN, in the forward and the gradient.

The normal and edge losses share one gather of the face corners
(`_face_corners`), whose backward takes one of three forms, as in the JAX
package: `face_take3_band` (the train step's: the cotangent reordered by the
artifact's `face_perm` and one float32 batched product against its 0/1
selector `face_sel`), `face_take` (the ELL-inverse gather of `face_inv`),
or, with neither table, index gathers whose backward is autograd's
index-add.  The forward values are identical; the gradients agree up to
the order of summation.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["coord_l1", "normal_vector_loss", "edge_length_loss",
           "pose2mesh_loss", "make_laplacian_loss", "face_take", "face_take3_band"]


class _FaceTake(torch.autograd.Function):
    """pred[:, fidx] with a gather VJP: vertex v sums the cotangent rows
    inv[v] (padded with F, a zero pad row)."""

    @staticmethod
    def forward(ctx, pred, fidx, inv):
        ctx.save_for_backward(inv)
        ctx.vertices = pred.shape[1]
        return pred.index_select(1, fidx)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        if inv.shape[0] != ctx.vertices:
            raise ValueError(f"face_inv tables for V={inv.shape[0]} applied to a "
                             f"pred of {ctx.vertices} vertices")
        gp = torch.nn.functional.pad(g, (0, 0, 0, 1))  # zero pad row at F
        B, C = g.shape[0], g.shape[2]
        dpred = gp.index_select(1, inv.reshape(-1)).reshape(B, *inv.shape, C).sum(2)
        return dpred, None, None


def face_take(pred: torch.Tensor, fidx: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """pred[:, fidx] (pred (B, V, C)) whose backward gathers through the
    ELL inverse `inv` (V, K) of fidx (`graphs.artifact.face_inverse_tables`)."""
    return _FaceTake.apply(pred, fidx, inv)


class _FaceTake3Band(torch.autograd.Function):
    """All three face corners, (B, F, 3 corners, 3 coords), with the banded
    selector VJP."""

    @staticmethod
    def forward(ctx, pred, faces, perm, sel, vgather):
        ctx.save_for_backward(perm, sel, vgather)
        ctx.pshape = pred.shape
        B, F = pred.shape[0], faces.shape[0]
        return pred.index_select(1, faces.reshape(-1)).reshape(B, F, 3, pred.shape[2])

    @staticmethod
    def backward(ctx, g):
        perm, sel, vgather = ctx.saved_tensors
        B, V, C = ctx.pshape
        F = g.shape[1]
        nt, T, W = sel.shape
        # corner-major cotangent rows (3F, B*C), row c*F + f, and the zero
        # row 3F that the pad slots of perm select
        rows = g.permute(2, 1, 0, 3).reshape(3 * F, B * C).float()
        rows = torch.cat([rows, rows.new_zeros(1, B * C)])
        gs = rows.index_select(0, perm).reshape(nt, W, B * C)
        ddev = torch.bmm(sel, gs).reshape(nt * T, B, C)  # rows: device positions
        # back to pred's original vertex order: vertex i sits at vgather[i]
        dpred = ddev.index_select(0, vgather).transpose(0, 1)
        if dpred.shape != (B, V, C):
            raise ValueError(f"face_sel of nt*T={nt * T} rows applied to a pred "
                             f"of shape {tuple(ctx.pshape)}")
        return dpred.to(g.dtype), None, None, None, None


def face_take3_band(pred: torch.Tensor, faces: torch.Tensor, perm: torch.Tensor,
                    sel: torch.Tensor, vgather: torch.Tensor) -> torch.Tensor:
    """pred[:, faces] (B, F, 3, C) in one gather, whose backward reorders the
    cotangent by the corner vertex's device tile (`perm`) and makes one
    float32 batched product against the 0/1 selector `sel` (nt, T, W)
    (`graphs.artifact.face_band_tables`); `vgather` maps each original
    vertex to its device position."""
    return _FaceTake3Band.apply(pred, faces, perm, sel, vgather)


FaceBand = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _face_corners(pred: torch.Tensor, faces: torch.Tensor,
                  face_inv: Sequence[torch.Tensor] = (),
                  face_band: Optional[FaceBand] = None):
    """(p0, p1, p2), the corner gathers shared by the normal and edge losses:
    through the banded VJP when `face_band` = (face_perm, face_sel,
    vertex_gather) holds tables, else per corner through the ELL-inverse
    VJP when `face_inv` does, else index gathers."""
    if face_band is not None and face_band[1].numel():
        c = face_take3_band(pred, faces, *face_band)
        return c[:, :, 0], c[:, :, 1], c[:, :, 2]
    if face_inv:
        return tuple(face_take(pred, faces[:, c], face_inv[c]) for c in range(3))
    return _corners(pred, faces)


def coord_l1(pred: torch.Tensor, target: torch.Tensor,
             valid: torch.Tensor | None = None) -> torch.Tensor:
    """Masked L1: mean over all elements, masked ones contributing zero."""
    if valid is not None:
        pred = pred * valid
        target = target * valid
    return (pred - target).abs().mean()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / ||v|| with a grad-safe zero branch: 0 where ||v|| <= eps (torch's
    F.normalize returns v / eps there; unreachable in float32 for distinct
    points, see the JAX package's note)."""
    n2 = (v * v).sum(-1, keepdim=True)
    ok = n2 > eps * eps
    inv = torch.rsqrt(torch.where(ok, n2, torch.ones_like(n2)))
    return torch.where(ok, v * inv, torch.zeros_like(v))


def _corners(pred: torch.Tensor, faces: torch.Tensor):
    return tuple(pred[:, faces[:, c]] for c in range(3))


def normal_vector_loss(pred: torch.Tensor, gt: torch.Tensor, faces: torch.Tensor,
                       corners=None) -> torch.Tensor:
    """|cos| between predicted edge vectors and ground-truth face normals,
    averaged over faces.  corners: precomputed (p0, p1, p2) gathers."""
    p0, p1, p2 = corners if corners is not None else _corners(pred, faces)
    v1o = _normalize(p1 - p0)
    v2o = _normalize(p2 - p0)
    v3o = _normalize(p2 - p1)
    g0, g1, g2 = _corners(gt, faces)
    v1g = _normalize(g1 - g0)
    v2g = _normalize(g2 - g0)
    ng = _normalize(torch.linalg.cross(v1g, v2g, dim=-1))
    cos = [((v * ng).sum(-1)).abs() for v in (v1o, v2o, v3o)]
    return torch.stack(cos).mean()


def _edge_len(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| with a grad-safe zero at coincident points."""
    n2 = ((a - b) ** 2).sum(-1)
    ok = n2 > 1e-24
    return torch.where(ok, torch.sqrt(torch.where(ok, n2, torch.ones_like(n2))),
                       torch.zeros_like(n2))


def edge_length_loss(pred: torch.Tensor, gt: torch.Tensor, faces: torch.Tensor,
                     corners=None) -> torch.Tensor:
    """Edge-length preservation against the ground-truth mesh."""
    p = corners if corners is not None else _corners(pred, faces)
    g = _corners(gt, faces)
    d = [(_edge_len(p[a], p[b]) - _edge_len(g[a], g[b])).abs()
         for a, b in ((0, 1), (0, 2), (1, 2))]
    return torch.stack(d).mean()


def make_laplacian_loss(faces):
    """Uniform-Laplacian smoothness loss: delta_i = x_i - mean of x over the
    neighbours of i (an index-add over the undirected edge list), loss =
    mean_i ||delta_i||^2, or sum / batch with average=True.  The edge list
    and degrees are copied to a device once, the first time the loss sees
    it (`loss.tables`)."""
    f = np.asarray(faces)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    src = torch.from_numpy(np.concatenate([e[:, 0], e[:, 1]]))
    dst = torch.from_numpy(np.concatenate([e[:, 1], e[:, 0]]))
    num_v = int(f.max()) + 1
    deg = np.bincount(src.numpy(), minlength=num_v).astype(np.float32)
    inv_deg = torch.from_numpy(1.0 / (deg + 1e-8))

    tables = {}   # device -> (src, dst, inv_deg) there, copied once

    def loss(x: torch.Tensor, average: bool = False) -> torch.Tensor:
        if x.device not in tables:
            tables[x.device] = tuple(t.to(x.device) for t in (src, dst, inv_deg))
        s, d, inv = tables[x.device]
        nbr = torch.zeros_like(x).index_add_(1, s, x[:, d])
        delta = x - nbr * inv[None, :, None]
        sq = (delta ** 2).sum(-1)
        return sq.sum() / x.shape[0] if average else sq.mean()

    loss.tables = tables
    return loss


_GATES: Dict[Tuple[bool, torch.device], torch.Tensor] = {}


def _edge_gate(use_edge_loss: bool | torch.Tensor, device: torch.device) -> torch.Tensor:
    """The edge term's gate on `device`: a tensor as given (cast to bool
    there), a Python bool as a constant made once a device (a fresh one
    would be a host-to-device copy every step)."""
    if torch.is_tensor(use_edge_loss):
        return use_edge_loss.to(device=device, dtype=torch.bool)
    key = (bool(use_edge_loss), device)
    if key not in _GATES:
        _GATES[key] = torch.tensor(key[0], device=device)
    return _GATES[key]


def pose2mesh_loss(pred_mesh: torch.Tensor, lift_pose: torch.Tensor,
                   pred_reg_pose: torch.Tensor, targets: Dict[str, torch.Tensor],
                   faces: torch.Tensor, *, normal_weight: float = 0.1,
                   edge_weight: float = 20.0, joint_weight: float = 1e-3,
                   use_edge_loss: bool | torch.Tensor = False,
                   face_inv: Sequence[torch.Tensor] = (),
                   face_band: Optional[FaceBand] = None
                   ) -> Dict[str, torch.Tensor]:
    """The full training objective.

    pred_mesh (B, V, 3) m in original vertex order; lift_pose (B, J, 3) mm;
    pred_reg_pose (B, J_t, 3) mm; targets: mesh, mesh_valid, reg_pose3d,
    reg_pose3d_valid, lift_pose3d, lift_pose3d_valid.  `use_edge_loss`
    gates the edge term.  face_inv / face_band pick the face corners'
    backward (`_face_corners`)."""
    l_vert = coord_l1(pred_mesh, targets["mesh"], targets["mesh_valid"])
    corners = _face_corners(pred_mesh, faces, face_inv, face_band)
    l_norm = normal_weight * normal_vector_loss(pred_mesh, targets["mesh"], faces,
                                                corners=corners)
    l_edge = edge_weight * edge_length_loss(pred_mesh, targets["mesh"], faces,
                                            corners=corners)
    l_edge = torch.where(_edge_gate(use_edge_loss, l_edge.device), l_edge,
                         torch.zeros_like(l_edge))
    l_reg = joint_weight * coord_l1(pred_reg_pose, targets["reg_pose3d"],
                                    targets["reg_pose3d_valid"])
    l_lift = joint_weight * coord_l1(lift_pose, targets["lift_pose3d"],
                                     targets["lift_pose3d_valid"])
    return {
        "total": l_vert + l_norm + l_edge + l_reg + l_lift,
        "vertex": l_vert,
        "normal": l_norm,
        "edge": l_edge,
        "reg_joint": l_reg,
        "lift_joint": l_lift,
    }
