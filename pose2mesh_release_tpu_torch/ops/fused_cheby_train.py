"""Fused K=3 Chebyshev graph convs of the training step, and their backward.

Counterpart of the training half of the JAX package's `ops/pallas_cheby.py`:

  fused_cheby_conv_train  <- _fused_call (Pallas; CUDA csrc/fused_cheby_train.cu)
      u = x, or relu(x*s + c) with in_fold = (s, c)
      y = [u, Lu, 2L(Lu) - u] @ W + b, with emit_stats also the float32
      per-channel sums (sum y, sum y^2) over the real V*B rows, or with
      keep_basis also the basis z1 = Lu, z2 = 2L z1 - u (no gradient);
      the fold pass, two launches of the banded hop engine and the
      three-operand projection GEMM, which `train_launcher` runs apart
  fused_cheby_conv_bwd    <- _fused_bwd_call (Pallas; CUDA csrc/fused_cheby_bwd.cu)
      g1 = Lg, h2 = 2L g1 - g (two launches of the banded hop engine);
      dx = g W0^T + g1 W1^T + h2 W2^T (through the fold's mask and scale),
      dW = u^T [g, g1, h2] basis-major, db = sum g, and with in_fold ds, dc;
      `bwd_plan` lays out its launches

Activations keep the JAX training layout (V, B, F) at the real row count;
`band_val` is (2k+1, nt, T, T) with nt*T >= V, k in {1, 2}.  Rows >= V are
zero for the hops and never written.  bf16 or float32 operands, all of one
dtype, float32 accumulation, hop results rounded to the working dtype where
the Pallas kernels round them; the fold's scale and shift are cast to the
working dtype before use.

`_FusedChebyConv` is the `torch.autograd.Function` of the four JAX custom
VJPs `_fused`, `_fused_stats`, `_fused_fold` and `_fused_fold_stats`: its
backward is the fused backward, never autograd through the forward.  With
stats it first folds their cotangents into the output's, g = gy + gs +
2 y gs2 in float32 rounded to y's dtype, as the JAX VJPs do.

`fused_cheby_project(..., fused=False)` is the JAX package's unfused conv
(P2M_FUSED=0): two differentiable hops (`ops.hop.banded_hop`), 2 L z1 - x in
x's dtype, and three projections with float32 accumulation.

Each kernel wrapper runs the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card, counting the launch in
`launches`.  There is no fallback: a CUDA input the kernel does not take
raises.  Each kernel's bound on the H100 is in its source note.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import dtype_name, span
from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _check_cuda, _pad_cols, _ptr, _raise_on, _stream, \
    proj_plan
from .gemm_f32 import DW_F32_STAGES, dx_f32_stages, gemm_f32_smem
from .hop import _BLOCK_SMEM_RESERVED, _SM_SMEM, HopPlan, band_span, banded_hop, hop_plan, \
    sm_count
from .spmm import band_hop

__all__ = ["BWD_STAGES", "BwdPlan", "TRAIN_STAGES", "bwd_launcher", "bwd_plan",
           "fused_cheby_conv_train", "fused_cheby_conv_bwd",
           "fused_cheby_conv_train_plain", "fused_cheby_conv_bwd_plain",
           "fused_cheby_project", "fused_cheby_project_stats", "cheby_project_unfused",
           "fused_cheby_project_folded", "fused_cheby_project_folded_stats",
           "launches", "train_launcher"]

Fold = Optional[Tuple[torch.Tensor, torch.Tensor]]

# kernel launches since the last reset, by wrapper name
launches = {"fused_cheby_conv_train": 0, "fused_cheby_conv_bwd": 0}


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
                                 emit_stats: bool = False, keep_basis: bool = False):
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
    if keep_basis:
        return y, z1, z2
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


def _fold_args(in_fold: Fold, Fin: int, x):
    """The fold's (s, c) in x's dtype (the conv's working dtype), as the
    plain version rounds them."""
    if in_fold is None:
        return {}
    s, c = in_fold
    if s.shape != (Fin,) or c.shape != (Fin,):
        raise ValueError(f"in_fold must be two ({Fin},) vectors, got "
                         f"{tuple(s.shape)}, {tuple(c.shape)}")
    if s.device != x.device or c.device != x.device:
        raise ValueError(f"in_fold is on {s.device}/{c.device}, x on {x.device}")
    return {"fold_s": s.to(x.dtype).contiguous(), "fold_c": c.to(x.dtype).contiguous()}


# the dx and dW kernels' tiles (csrc/fused_cheby_bwd.cu; bf16 ring depth and
# dx tile width, dx blocks an SM where their shared memory fits)
_BK, _STAGES, _DX_BM, _DX_BN = 32, 3, 128, 64
_DX_BLOCKS_PER_SM = 3
_DW_BLOCKS_PER_SM = 4


def dx_bn(fp: int, esize: int = 2) -> int:
    """dx's tile width: bf16 64; float32 128 where fp is a multiple of 128,
    else 64 (csrc dx_f32_bn)."""
    return _DX_BN if esize == 2 or fp % 128 else 128


def dw_smem(esize: int = 2) -> int:
    """Shared memory of the dW kernel: bf16 its static u and G rings of 3
    stages; float32 the dynamic planes and the 3-stage raw ring of a 64 x 64
    tile (gemm_f32_smem), one warp-specialized block an SM."""
    if esize == 2:
        return 2 * _STAGES * _BK * (64 + 8) * esize
    return gemm_f32_smem(64, 64, DW_F32_STAGES)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The launches of K2 for one shape: the channel padding, the two hop
    engine launches (`hop`), the dx GEMM's persistent grid over `dx_items`
    128 x `dx_bn` tiles with `dx_smem` bytes, and dW's `slices` row slices of
    `slice_rows` rows over (Fp/64) x (gw/64) tiles, `dw_grid` blocks with
    `dw_smem` bytes."""
    fo_pad: int
    gw: int
    fp: int
    hop: HopPlan
    dx_items: int
    grid_dx: int
    dx_smem: int
    slices: int
    slice_rows: int
    dw_grid: int
    dw_smem: int
    dx_bn: int = _DX_BN


def dx_smem(fp: int, esize: int = 2) -> int:
    """Dynamic shared memory of the dx kernel (csrc dx_smem) for `esize`-byte
    operands: bf16 its ring (A's row stride 8 elements of pad) and 4 row
    groups' ds / dc slots; float32 the planes and raw ring of a 128 x dx_bn
    tile (dx_f32_stages) and 8 row groups' slots."""
    if esize == 2:
        return _STAGES * (_DX_BM * (_BK + 8) + _BK * (_DX_BN + 8)) * esize + 8 * fp * 4
    bn = dx_bn(fp, esize)
    return gemm_f32_smem(_DX_BM, bn, dx_f32_stages(bn)) + 2 * 8 * fp * 4


def bwd_plan(V: int, B: int, nt: int, k: int, Fin: int, Fout: int, sms: int,
             esize: int = 2) -> BwdPlan:
    """K2's launch plan at V rows, batch B, Fin -> Fout of `esize`-byte
    operands on a card of `sms` SMs: bf16 dx keeps _DX_BLOCKS_PER_SM blocks
    on an SM where their shared memory fits, float32 dx one (warp-specialized
    on wgmma: two consumer and two producer warpgroups)."""
    if esize not in (2, 4):
        raise ValueError(f"K2 takes 2- or 4-byte elements, got {esize}")
    M = V * B
    fo_pad = _cdiv(Fout, 16) * 16
    gw = _cdiv(3 * fo_pad, 64) * 64
    fp = _cdiv(Fin, 64) * 64
    bn = dx_bn(fp, esize)
    dx_items = _cdiv(M, _DX_BM) * (fp // bn)
    tiles = (fp // 64) * (gw // 64)
    k_tiles = _cdiv(M, _BK)
    slices = min(k_tiles, max(1, _cdiv(_DW_BLOCKS_PER_SM * sms, tiles)))
    slice_rows = _cdiv(k_tiles, slices) * _BK
    slices = _cdiv(M, slice_rows)
    dxs = dx_smem(fp, esize)
    dx_blocks = (1 if esize == 4
                 else min(_DX_BLOCKS_PER_SM, _SM_SMEM // (dxs + _BLOCK_SMEM_RESERVED)))
    return BwdPlan(fo_pad, gw, fp, hop_plan(nt, band_span(k), B * fo_pad, sms, esize),
                   dx_items, min(dx_items, dx_blocks * sms), dxs, slices, slice_rows,
                   tiles * slices, dw_smem(esize), bn)


@functools.cache
def _train_lib():
    lib = load_library("fused_cheby_train")
    lib.p2m_train_conv.argtypes = [_C_PTR] * 12 + [_C_INT] * 15 + [_C_PTR]
    lib.p2m_train_conv.restype = _C_INT
    lib.p2m_train_conv_error_string.argtypes = [_C_INT]
    lib.p2m_train_conv_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib():
    lib = load_library("fused_cheby_bwd")
    lib.p2m_fused_cheby_bwd.argtypes = [_C_PTR] * 15 + [_C_INT] * 17 + [_C_PTR]
    lib.p2m_fused_cheby_bwd.restype = _C_INT
    lib.p2m_fused_cheby_bwd_error_string.argtypes = [_C_INT]
    lib.p2m_fused_cheby_bwd_error_string.restype = ctypes.c_char_p
    return lib


def fused_cheby_conv_train(band_val, x, W, b, *, in_fold: Fold = None,
                           emit_stats: bool = False, keep_basis: bool = False):
    """y = [u, Lu, 2L(Lu) - u] @ W + b with u = x or relu(x*s + c).

    band_val (2k+1, nt, T, T); x (V, B, F), V <= nt*T; W (3F, Fout)
    basis-major; b (Fout,); in_fold (s, c) two (F,) vectors.  Returns y
    (V, B, Fout) in x's dtype; with emit_stats (y, sum_y, sum_y2), the sums
    float32 (Fout,) over the V*B rows of the float32 y before rounding; with
    keep_basis (y, z1, z2), z1 = Lu and z2 = 2L z1 - u (V, B, F) in x's dtype.
    emit_stats and keep_basis exclude each other, as in the TPU kernel."""
    _check_train(band_val, x, W, b)
    if emit_stats and keep_basis:
        raise ValueError("keep_basis and emit_stats exclude each other")
    if x.device.type == "cpu":
        return fused_cheby_conv_train_plain(band_val, x, W, b, in_fold=in_fold,
                                            emit_stats=emit_stats, keep_basis=keep_basis)
    run, out = train_launcher(band_val, x, W, b, in_fold, emit_stats, keep_basis)
    run(_TRAIN_ALL_STAGES)
    launches["fused_cheby_conv_train"] += 1
    return out


# K1's launches (csrc/fused_cheby_train.cu `stages`): the fold pass, the two
# hops, then the projection with the statistics' reduction
TRAIN_STAGES = {"fold": 1, "hops": 2, "proj": 4}
_TRAIN_ALL_STAGES = 7


def train_launcher(band_val, x, W, b, in_fold: Fold, emit_stats: bool, keep_basis: bool):
    """K1 on CUDA inputs (checked here): (run, outputs), where run(stages)
    launches the stages named by the bit mask (TRAIN_STAGES) into the
    outputs, those `fused_cheby_conv_train` returns.  The wrapper runs all of
    them once; running them apart only times the split."""
    k, nt, T, Fin, Fout = _check_train(band_val, x, W, b)
    fold = _fold_args(in_fold, Fin, x)
    _check_cuda(x, T, Fin, band_val=band_val, W=W, b=b, **fold)
    V, B = x.shape[:2]
    dev = x.device
    sms, es = sm_count(dev), x.element_size()
    hp = hop_plan(nt, band_span(k), B * Fin, sms, es)
    pp = proj_plan(V * B, Fin, Fout, sms, stats=emit_stats, esize=es)
    Wp = _pad_cols(W, pp.np)
    u = torch.empty_like(x) if fold else None
    z1, z2 = torch.empty_like(x), torch.empty_like(x)
    out = torch.empty((V, B, Fout), dtype=x.dtype, device=dev)
    part = stats = None
    if emit_stats:
        part = torch.empty((pp.grid, 2 * Fout), dtype=torch.float32, device=dev)
        stats = torch.empty((2, Fout), dtype=torch.float32, device=dev)
    lib = _train_lib()

    def run(stages: int):
        with torch.cuda.device(dev):
            err = lib.p2m_train_conv(
                _ptr(band_val), _ptr(x), _ptr(Wp), _ptr(b), _ptr(fold.get("fold_s")),
                _ptr(fold.get("fold_c")), _ptr(u), _ptr(z1), _ptr(z2), _ptr(out), _ptr(part),
                _ptr(stats), V, nt, k, B, Fin, Fout, pp.np, int(emit_stats), hp.cc, hp.grid,
                hp.per_block, pp.bn, pp.grid, stages, int(es == 4), _stream(x))
        _raise_on(err, lib, "p2m_train_conv_error_string")

    if emit_stats:
        return run, (out, stats[0], stats[1])
    return run, ((out, z1, z2) if keep_basis else out)


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
    run, out = bwd_launcher(band_val, g, x, W, in_fold)
    run(_ALL_STAGES)
    launches["fused_cheby_conv_bwd"] += 1
    return out


# K2's launches (csrc/fused_cheby_bwd.cu `stages`): the two hops, dx, then
# dW with db and the reductions
BWD_STAGES = {"hops": 1, "dx": 2, "dW": 4}
_ALL_STAGES = 7


def bwd_launcher(band_val, g, x, W, in_fold: Fold):
    """K2 on CUDA inputs (checked here): (run, outputs), where run(stages) launches
    the stages named by the bit mask (BWD_STAGES) into the outputs.  The
    wrapper runs all of them once; running them apart only times the split."""
    k, nt, T, Fin, Fout = _check_train(band_val, x, W)
    fold = _fold_args(in_fold, Fin, x)
    _check_cuda(x, T, Fin, band_val=band_val, g=g, W=W, **fold)
    V, B = x.shape[:2]
    dev = x.device
    es = x.element_size()
    p = bwd_plan(V, B, nt, k, Fin, Fout, sm_count(dev), es)
    fo_pad, gw, fp = p.fo_pad, p.gw, p.fp
    # g at fo_pad channels (a copy only where Fout is not a multiple of 16)
    gp = _pad_cols(g, fo_pad).contiguous()
    if es == 4:  # float32 dx reads W as it lies, (3F, fo_pad): K-major by block
        Wt = _pad_cols(W, fo_pad).contiguous()
    else:  # [W0^T; W1^T; W2^T], each block's rows padded to fo_pad, columns to fp
        Wt = torch.zeros((gw, fp), dtype=W.dtype, device=dev)
        Wt[:3 * fo_pad].view(3, fo_pad, fp)[:, :Fout, :Fin] = \
            W.view(3, Fin, Fout).transpose(1, 2)
    g1, h2 = torch.empty_like(gp), torch.empty_like(gp)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=dev)
    dW, db = torch.empty((3 * Fin, Fout), **f32), torch.empty((Fout,), **f32)
    dsdc = torch.empty((2, Fin), **f32) if fold else None
    part_db = torch.empty((p.slices, Fout), **f32)
    part_dx = torch.empty((p.grid_dx, 2 * Fin), **f32) if fold else None
    part_dw = torch.empty((p.slices, fp, gw), **f32)
    lib = _bwd_lib()

    def run(stages: int):
        with torch.cuda.device(dev):
            err = lib.p2m_fused_cheby_bwd(
                _ptr(band_val), _ptr(gp), _ptr(x), _ptr(Wt), _ptr(fold.get("fold_s")),
                _ptr(fold.get("fold_c")), _ptr(g1), _ptr(h2), _ptr(dx), _ptr(dW), _ptr(db),
                _ptr(dsdc), _ptr(part_db), _ptr(part_dx), _ptr(part_dw),
                V, nt, k, B, Fin, Fout, fo_pad, gw, fp, p.hop.cc, p.hop.grid,
                p.hop.per_block, p.grid_dx, p.slices, p.slice_rows, stages, int(es == 4),
                _stream(x))
        _raise_on(err, lib, "p2m_fused_cheby_bwd_error_string")

    return run, ((dx, dW, db, dsdc[0], dsdc[1]) if fold else (dx, dW, db))


class _FusedChebyConv(torch.autograd.Function):
    """The training conv with the fused backward as its gradient; mirrors the
    JAX custom VJPs `_fused` (no fold, no stats), `_fused_stats`, `_fused_fold`
    and `_fused_fold_stats`."""

    @staticmethod
    def forward(ctx, band_val, x, W, b, scale, shift, emit_stats):
        fold = None if scale is None else (scale, shift)
        out = fused_cheby_conv_train(band_val, x, W, b, in_fold=fold,
                                     emit_stats=emit_stats)
        y = out[0] if emit_stats else out
        ctx.emit_stats, ctx.b_dtype, ctx.dtype_name = emit_stats, b.dtype, dtype_name(x.dtype)
        ctx.save_for_backward(band_val, x, W, scale, shift,
                              y if emit_stats else None)
        return out

    @staticmethod
    def backward(ctx, *grads):
        with span("p2m.band_conv.bwd", dtype=ctx.dtype_name):
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


def cheby_project_unfused(band_val, x, W, b):
    """The unfused conv (JAX `fused_cheby_project` with P2M_FUSED=0):
    z1 = L x and z2 = 2 L z1 - x by two differentiable hops, z2 formed in x's
    dtype, then x W0 + z1 W1 + z2 W2 + b accumulated in float32 and rounded
    to x's dtype.  x (V, B, F) with V <= nt*T rows."""
    Fin = x.shape[-1]
    z1 = banded_hop(band_val, x)
    z2 = 2.0 * banded_hop(band_val, z1) - x
    Wf = W.float()
    y = (x.float() @ Wf[:Fin] + z1.float() @ Wf[Fin:2 * Fin]
         + z2.float() @ Wf[2 * Fin:])
    return (y + b.float()).to(x.dtype)


def fused_cheby_project(band_val, x, W, b, *, fused: bool = True):
    """Training conv y = [x, Lx, 2L(Lx) - x] @ W + b (JAX `fused_cheby_project`):
    x (V, B, F), W (3F, Fout) basis-major.  fused: the fused conv K1 with its
    backward K2 (else `cheby_project_unfused`)."""
    if not fused:
        return cheby_project_unfused(band_val, x, W, b)
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
