"""Fused K=3 Chebyshev graph convs of the training step, and their backward.

Counterpart of the training half of the JAX package's `ops/pallas_cheby.py`:

  fused_cheby_conv_train  <- _fused_call (Pallas; CUDA csrc/fused_cheby_train.cu)
      u = x, or relu(x*s + c) with in_fold = (s, c)
      y = [u, Lu, 2L(Lu) - u] @ W + b, with emit_stats also the float32
      per-channel sums (sum y, sum y^2) over the real V*B rows
  fused_cheby_conv_bwd    <- _fused_bwd_call (Pallas; CUDA csrc/fused_cheby_bwd.cu)
      g1 = Lg, h2 = 2L g1 - g, G = [g, g1, h2]; dx = G @ [W0^T; W1^T; W2^T]
      (through the fold's mask and scale), dW = u^T G basis-major, db = sum g,
      and with in_fold ds, dc

Activations keep the JAX training layout (V, B, F) at the real row count;
`band_val` is (2k+1, nt, T, T) with nt*T >= V, k in {1, 2}.  Rows >= V are
zero for the hops and never written.  bf16 operands, float32 accumulation,
hop results rounded to the working dtype where the Pallas kernels round them;
the fold's scale and shift are cast to the working dtype before use.

`_FusedChebyConv` is the `torch.autograd.Function` of the four JAX custom
VJPs `_fused`, `_fused_stats`, `_fused_fold` and `_fused_fold_stats`: its
backward is the fused backward, never autograd through the forward.  With
stats it first folds their cotangents into the output's, g = gy + gs +
2 y gs2 in float32 rounded to y's dtype, as the JAX VJPs do.

Each kernel wrapper runs the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card, counting the launch in
`launches`.  There is no fallback: a CUDA input the kernel does not take
raises.  Each kernel's bound on the H100 is in its source note.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _MAX_SMEM, _T, _check_cuda, _pad_cols, _ptr, \
    _raise_on, _stream
from .spmm import band_hop

__all__ = ["fused_cheby_conv_train", "fused_cheby_conv_bwd",
           "fused_cheby_conv_train_plain", "fused_cheby_conv_bwd_plain",
           "fused_cheby_project", "fused_cheby_project_stats",
           "fused_cheby_project_folded", "fused_cheby_project_folded_stats",
           "launches"]

Fold = Optional[Tuple[torch.Tensor, torch.Tensor]]

# kernel launches since the last reset, by wrapper name
launches = {"fused_cheby_conv_train": 0, "fused_cheby_conv_bwd": 0}

_WARPS = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fold_f32(in_fold: Fold, dt: torch.dtype):
    """(s, c) rounded to the working dtype, as float32."""
    return tuple(v.to(dt).float() for v in in_fold)


def _hops(band_val, u):
    """(z1, z2) = (Lu, 2L z1 - u) rounded to u's dtype, for u of V <= nt*T
    rows (missing rows zero)."""
    nbd, nt, T, _ = band_val.shape
    V, dt = u.shape[0], u.dtype
    up = F.pad(u, (0, 0, 0, 0, 0, nt * T - V))
    band = band_val.to(dt)
    z1 = band_hop(band, up).to(dt)
    z2 = (2.0 * band_hop(band, z1) - up.float()).to(dt)
    return z1[:V], z2[:V]


def fused_cheby_conv_train_plain(band_val, x, W, b, *, in_fold: Fold = None,
                                 emit_stats: bool = False):
    """Plain PyTorch version of `fused_cheby_conv_train`."""
    dt, Fin = x.dtype, x.shape[-1]
    u = x
    if in_fold is not None:
        s, c = _fold_f32(in_fold, dt)
        u = torch.relu(x.float() * s + c).to(dt)
    z1, z2 = _hops(band_val, u)
    Wf = W.to(dt).float()
    acc = (u.float() @ Wf[:Fin] + z1.float() @ Wf[Fin:2 * Fin]
           + z2.float() @ Wf[2 * Fin:] + b.to(dt).float())
    y = acc.to(dt)
    if emit_stats:
        return y, acc.sum((0, 1)), (acc * acc).sum((0, 1))
    return y


def fused_cheby_conv_bwd_plain(band_val, g, x, W, *, in_fold: Fold = None):
    """Plain PyTorch version of `fused_cheby_conv_bwd`."""
    dt, (V, B, Fin), Fout = x.dtype, x.shape, g.shape[-1]
    g = g.to(dt)
    g1, h2 = _hops(band_val, g)
    G = torch.cat([g, g1, h2], dim=-1).float().reshape(V * B, 3 * Fout)
    W3 = W.to(dt).float().reshape(3, Fin, Fout)
    du = G @ W3.transpose(1, 2).reshape(3 * Fout, Fin)
    xf = x.float().reshape(V * B, Fin)
    if in_fold is not None:
        s, c = _fold_f32(in_fold, dt)
        t = xf * s + c
        u = torch.relu(t).to(dt).float()
        dt_ = torch.where(t > 0, du, torch.zeros_like(du))
        dx = (dt_ * s).to(dt)
        extra = ((dt_ * xf).sum(0), dt_.sum(0))
    else:
        u, dx, extra = xf, du.to(dt), ()
    dW = (u.t() @ G).reshape(Fin, 3, Fout).transpose(0, 1).reshape(3 * Fin, Fout)
    db = g.float().sum((0, 1))
    return (dx.reshape(V, B, Fin), dW, db) + extra


def _check_train(band_val, x, W, b=None):
    if band_val.dim() != 4 or band_val.shape[2] != band_val.shape[3] \
            or band_val.shape[0] not in (3, 5):
        raise ValueError(f"band_val must be (2k+1, nt, T, T) with k in {{1, 2}}, "
                         f"got {tuple(band_val.shape)}")
    nbd, nt, T, _ = band_val.shape
    if x.dim() != 3 or not 0 < x.shape[0] <= nt * T:
        raise ValueError(f"x must be (V, B, F) with V <= {nt * T}, got {tuple(x.shape)}")
    Fin = x.shape[2]
    if W.dim() != 2 or W.shape[0] != 3 * Fin:
        raise ValueError(f"W must be ({3 * Fin}, Fout), got {tuple(W.shape)}")
    if b is not None and b.shape != (W.shape[1],):
        raise ValueError(f"b must be ({W.shape[1]},), got {tuple(b.shape)}")
    return nbd // 2, nt, T, Fin, W.shape[1]


def _fold_args(in_fold: Fold, Fin: int, dev):
    if in_fold is None:
        return {}
    s, c = in_fold
    if s.shape != (Fin,) or c.shape != (Fin,):
        raise ValueError(f"in_fold must be two ({Fin},) vectors, got "
                         f"{tuple(s.shape)}, {tuple(c.shape)}")
    if s.device != dev or c.device != dev:
        raise ValueError(f"in_fold is on {s.device}/{c.device}, x on {dev}")
    return {"fold_s": s.to(torch.bfloat16).contiguous(),
            "fold_c": c.to(torch.bfloat16).contiguous()}


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _hop_smem(fc: int, k: int) -> int:
    """Shared memory of one hop chunk (csrc/common.cuh hop_smem)."""
    return ((4 * k + 1) + (2 * k + 1) + 1) * _T * fc * 2 + _WARPS * 16 * fc * 4


def _chunk(C: int, k: int, extra: int) -> int:
    """Largest channel chunk dividing C whose shared memory fits."""
    for fc in (64, 32, 16):
        if C % fc == 0 and _hop_smem(fc, k) + extra <= _MAX_SMEM:
            return fc
    raise ValueError(f"{C} channels with band_k={k} do not fit the kernel's "
                     f"shared memory")


@functools.cache
def _train_lib():
    lib = load_library("fused_cheby_train")
    lib.p2m_train_conv.argtypes = [_C_PTR] * 9 + [_C_INT] * 11 + [_C_PTR]
    lib.p2m_train_conv.restype = _C_INT
    lib.p2m_train_conv_error_string.argtypes = [_C_INT]
    lib.p2m_train_conv_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = load_library("fused_cheby_bwd")
    lib.p2m_fused_cheby_bwd.argtypes = [_C_PTR] * 14 + [_C_INT] * 14 + [_C_PTR]
    lib.p2m_fused_cheby_bwd.restype = _C_INT
    lib.p2m_fused_cheby_bwd_error_string.argtypes = [_C_INT]
    lib.p2m_fused_cheby_bwd_error_string.restype = ctypes.c_char_p
    return lib


def fused_cheby_conv_train(band_val, x, W, b, *, in_fold: Fold = None,
                           emit_stats: bool = False):
    """y = [u, Lu, 2L(Lu) - u] @ W + b with u = x or relu(x*s + c).

    band_val (2k+1, nt, T, T); x (V, B, F), V <= nt*T; W (3F, Fout)
    basis-major; b (Fout,); in_fold (s, c) two (F,) vectors.  Returns y
    (V, B, Fout) in x's dtype, and with emit_stats (y, sum_y, sum_y2), the
    sums float32 (Fout,) over the V*B rows of the float32 y before rounding."""
    k, nt, T, Fin, Fout = _check_train(band_val, x, W, b)
    if x.device.type == "cpu":
        return fused_cheby_conv_train_plain(band_val, x, W, b, in_fold=in_fold,
                                            emit_stats=emit_stats)
    fold = _fold_args(in_fold, Fin, x.device)
    _check_cuda(x, T, Fin, band_val=band_val, W=W, b=b, **fold)
    V, B = x.shape[:2]
    fo_pad = _cdiv(Fout, 16) * 16
    fo = next(f for f in (128, 64, 32, 16) if fo_pad % f == 0)
    fc = _chunk(Fin, k, 2 * _WARPS * fo_pad * 4)
    grid = min(nt * B * (fo_pad // fo), 2 * _sm_count(x.device))
    Wp = _pad_cols(W, fo_pad)
    out = torch.empty((V, B, Fout), dtype=x.dtype, device=x.device)
    part = stats = None
    if emit_stats:
        part = torch.empty((grid, 2 * Fout), dtype=torch.float32, device=x.device)
        stats = torch.empty((2, Fout), dtype=torch.float32, device=x.device)
    lib = _train_lib()
    with torch.cuda.device(x.device):
        err = lib.p2m_train_conv(
            _ptr(band_val), _ptr(x), _ptr(Wp), _ptr(b), _ptr(fold.get("fold_s")),
            _ptr(fold.get("fold_c")), _ptr(out), _ptr(part), _ptr(stats),
            V, nt, k, B, Fin, Fout, fo_pad, int(emit_stats), fc, fo, grid, _stream(x))
    _raise_on(err, lib, "p2m_train_conv_error_string")
    launches["fused_cheby_conv_train"] += 1
    return (out, stats[0], stats[1]) if emit_stats else out


def fused_cheby_conv_bwd(band_val, g, x, W, *, in_fold: Fold = None):
    """Fused backward of `fused_cheby_conv_train` for the output cotangent g
    (V, B, Fout) and the saved input x (V, B, F).  Returns (dx (V, B, F) in
    x's dtype, dW (3F, Fout) basis-major float32, db (Fout,) float32), and
    with in_fold also (ds, dc), float32 (F,)."""
    k, nt, T, Fin, Fout = _check_train(band_val, x, W)
    if g.shape != x.shape[:2] + (Fout,):
        raise ValueError(f"g must be {tuple(x.shape[:2]) + (Fout,)}, got {tuple(g.shape)}")
    if x.device.type == "cpu":
        return fused_cheby_conv_bwd_plain(band_val, g, x, W, in_fold=in_fold)
    fold = _fold_args(in_fold, Fin, x.device)
    _check_cuda(x, T, Fin, band_val=band_val, g=g, W=W, **fold)
    V, B = x.shape[:2]
    M, dev = V * B, x.device
    Mp = _cdiv(M, 128) * 128
    fo_pad = _cdiv(Fout, 16) * 16
    Gw = _cdiv(3 * fo_pad, 64) * 64
    Fp = _cdiv(Fin, 64) * 64
    fc = _chunk(fo_pad, k, _WARPS * fo_pad * 4)
    sm2 = 2 * _sm_count(dev)
    grid_hop = min(nt * B, sm2)
    grid_dx = min(Mp // 128 * (Fp // 64), sm2)
    tiles = (Fp // 64) * (Gw // 64)
    slice_rows = _cdiv(Mp // 64, max(1, min(_cdiv(sm2, tiles), Mp // 64))) * 64
    S = _cdiv(Mp, slice_rows)
    # [W0^T; W1^T; W2^T], each block's rows padded to fo_pad, columns to Fp
    Wt = torch.zeros((Gw, Fp), dtype=W.dtype, device=dev)
    Wt[:3 * fo_pad].view(3, fo_pad, Fp)[:, :Fout, :Fin] = \
        W.view(3, Fin, Fout).transpose(1, 2)
    G = torch.empty((Mp, Gw), dtype=x.dtype, device=dev)
    G[M:].zero_()
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    dW, db = torch.empty((3 * Fin, Fout), **f32), torch.empty((Fout,), **f32)
    dsdc = torch.empty((2, Fin), **f32) if fold else None
    part_hop = torch.empty((grid_hop, Fout), **f32)
    part_dx = torch.empty((grid_dx, 2 * Fin), **f32) if fold else None
    part_dw = torch.empty((S, Fp, Gw), **f32)
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        err = lib.p2m_fused_cheby_bwd(
            _ptr(band_val), _ptr(g), _ptr(x), _ptr(Wt), _ptr(fold.get("fold_s")),
            _ptr(fold.get("fold_c")), _ptr(G), _ptr(dx), _ptr(dW), _ptr(db),
            _ptr(dsdc), _ptr(part_hop), _ptr(part_dx), _ptr(part_dw),
            V, nt, k, B, Fin, Fout, fo_pad, Gw, Fp, fc, grid_hop, grid_dx, S,
            slice_rows, _stream(x))
    _raise_on(err, lib, "p2m_fused_cheby_bwd_error_string")
    launches["fused_cheby_conv_bwd"] += 1
    if fold:
        return dx, dW, db, dsdc[0], dsdc[1]
    return dx, dW, db


class _FusedChebyConv(torch.autograd.Function):
    """The training conv with the fused backward as its gradient; mirrors the
    JAX custom VJPs `_fused` (no fold, no stats), `_fused_stats`,
    `_fused_fold` and `_fused_fold_stats`."""

    @staticmethod
    def forward(ctx, band_val, x, W, b, scale, shift, emit_stats):
        fold = None if scale is None else (scale, shift)
        out = fused_cheby_conv_train(band_val, x, W, b, in_fold=fold,
                                     emit_stats=emit_stats)
        y = out[0] if emit_stats else out
        ctx.emit_stats, ctx.b_dtype = emit_stats, b.dtype
        ctx.save_for_backward(band_val, x, W, scale, shift,
                              y if emit_stats else None)
        return out

    @staticmethod
    def backward(ctx, *grads):
        band_val, x, W, scale, shift, y = ctx.saved_tensors
        if ctx.emit_stats:
            gy, gs, gs2 = grads
            g = (gy.float() + gs + 2.0 * y.float() * gs2).to(y.dtype)
        else:
            g = grads[0].to(x.dtype)
        fold = None if scale is None else (scale, shift)
        res = fused_cheby_conv_bwd(band_val, g.contiguous(), x, W, in_fold=fold)
        gx, dW, db = res[:3]
        ds = dc = None
        if fold is not None:
            ds, dc = res[3].to(scale.dtype), res[4].to(shift.dtype)
        return None, gx, dW.to(W.dtype), db.to(ctx.b_dtype), ds, dc, None


def fused_cheby_project(band_val, x, W, b):
    """Training conv y = [x, Lx, 2L(Lx) - x] @ W + b (JAX `fused_cheby_project`
    on its fused path): x (V, B, F), W (3F, Fout) basis-major."""
    return _FusedChebyConv.apply(band_val, x, W, b, None, None, False)


def fused_cheby_project_stats(band_val, x, W, b):
    """(y, sum_y, sum_y2): the conv plus its BatchNorm batch-stat sums over
    the real V*B rows, float32."""
    return _FusedChebyConv.apply(band_val, x, W, b, None, None, True)


def fused_cheby_project_folded(band_val, x_raw, W, b, scale, shift):
    """The conv of relu(x_raw*scale + shift): the previous conv's BatchNorm
    affine and ReLU applied on the kernel's input read."""
    return _FusedChebyConv.apply(band_val, x_raw, W, b, scale, shift, False)


def fused_cheby_project_folded_stats(band_val, x_raw, W, b, scale, shift):
    """`fused_cheby_project_folded` plus this conv's batch-stat sums."""
    return _FusedChebyConv.apply(band_val, x_raw, W, b, scale, shift, True)
