"""K=3 Chebyshev graph conv over the strip form of a band level (deploy).

Counterpart of the JAX package's `ops/pallas_strip.py::fused_conv_flat_strip`
(Pallas; CUDA csrc/strip_cheby.cu).  The strip form (`graphs.artifact.
_pack_strip`) keeps, for each h-row tile t, only the columns [o_t, o_t + W)
that the bandwidth-minimised order populates, so a hop of tile t is one
(h, W) @ (W, C) product over rows [o_t, o_t + W) of its source:

  basis:     z1 = S x;  z2 = 2 S z1 - x;  y = act([x, z1, z2] @ W + b)
  commuted:  u = x W2;  t = 2 S u + x W1;  y = act(S t + x (W0 - W2) + b)

each followed by the block's skip (+ skip, or + skip @ skip_w).  The mode
follows the JAX rule: commuted when the conv narrows its channels (Fout <
Fin), basis otherwise.  Rounding points are the TPU kernel's: z1, z2 in
basis order; u, x W1, t and the bias-carrying x (W0 - W2) + b in commuted
order, all to the working dtype (bf16, or float32: nothing rounded; the
kernels take either, `fused_cheby.KERNEL_DTYPES`).  The commuted weights
are passed formed, W = [W0 - W2; W1; W2] in the working dtype.

`strip_cheby_conv` runs the plain PyTorch version for a tensor on the CPU and
the CUDA kernels for a tensor on the card, counting one launch per conv in
`launches`; there is no fallback.  On the card the conv is three CUDA
launches in either order (four in commuted order with a skip projection),
on the banded hop engine reading the strip form (csrc/band_hop.cuh, its
strip layout; `hop.hop_layout` mirrors the addressing) and the projection
GEMM (csrc/cheby_proj.cuh): basis order two hops, then the projection;
commuted order the projection into [p | t0 | u], then two hops.
`strip_launcher` runs the launches apart.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _T, _check_cuda, _check_skip, _pad_cols, _ptr, \
    _raise_on, _stream, commuted_plan, proj_plan
from .hop import hop_layout, hop_plan, sm_count

__all__ = ["STRIP_STAGES", "strip_cheby_conv", "strip_cheby_conv_plain", "strip_launcher",
           "strip_mode", "strip_span", "windowed_hop", "launches"]

# kernel launches since the last reset, by wrapper name (one per conv)
launches = {"strip_cheby_conv": 0}

MODES = ("basis", "commuted")


def strip_mode(fin: int, fout: int) -> str:
    """The JAX rule (pallas_strip.py, P2M_STRIP_MODE=auto): commuted order
    when the conv narrows its channels, so both hops run on Fout columns."""
    return "commuted" if fout < fin else "basis"


def windowed_hop(mat: torch.Tensor, off: torch.Tensor, h: int,
                 src: torch.Tensor) -> torch.Tensor:
    """sum_j mat[r, j] * src[off[r // h] + j] in float32, for mat (Vp, W) and
    src (Vp, ...): a hop through a strip or sliding-window form."""
    Vp, W = mat.shape
    s2 = src.reshape(Vp, -1).float()
    idx = off.long()[:, None] + torch.arange(W, device=off.device)
    y = torch.bmm(mat.float().reshape(Vp // h, h, W), s2[idx])
    return y.reshape(src.shape)


def _epilogue(acc, dt, relu, skip, skip_w):
    if relu:
        acc = torch.relu(acc)
    if skip is not None:
        s = skip.to(dt).float()
        acc = acc + (s if skip_w is None else s @ skip_w.to(dt).float())
    return acc.to(dt)


def strip_cheby_conv_plain(strip_val, strip_off, h: int, x, W, b, *, mode: str,
                           relu: bool, skip: Optional[torch.Tensor] = None,
                           skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `strip_cheby_conv`."""
    dt, Fin = x.dtype, x.shape[-1]
    S = strip_val.to(dt)
    xf = x.float()
    Wf = W.to(dt).float()
    bf = b.to(dt).float()
    if mode == "basis":
        z1 = windowed_hop(S, strip_off, h, x).to(dt)
        z2 = (2.0 * windowed_hop(S, strip_off, h, z1) - xf).to(dt)
        acc = (xf @ Wf[:Fin] + z1.float() @ Wf[Fin:2 * Fin] + z2.float() @ Wf[2 * Fin:]
               + bf)
    else:
        u = (xf @ Wf[2 * Fin:]).to(dt)
        t = (xf @ Wf[Fin:2 * Fin]).to(dt)
        t = (2.0 * windowed_hop(S, strip_off, h, u) + t.float()).to(dt)
        p = (xf @ Wf[:Fin] + bf).to(dt)
        acc = windowed_hop(S, strip_off, h, t) + p.float()
    return _epilogue(acc, dt, relu, skip, skip_w)


@functools.cache
def _strip_lib():
    lib = load_library("strip_cheby")
    lib.p2m_strip_cheby_conv.argtypes = [_C_PTR] * 11 + [_C_INT] * 20 + [_C_PTR]
    lib.p2m_strip_cheby_conv.restype = _C_INT
    lib.p2m_strip_cheby_error_string.argtypes = [_C_INT]
    lib.p2m_strip_cheby_error_string.restype = ctypes.c_char_p
    return lib


def _check_args(strip_val, strip_off, h: int, x, W, b, mode: str):
    """(Vp, Wd, B, Fin, Fout) after checking the shapes."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    Vp, Wd = strip_val.shape
    if h <= 0 or Vp % h or strip_off.shape != (Vp // h,):
        raise ValueError(f"strip_off must be ({Vp} // h,) for h={h}, "
                         f"got {tuple(strip_off.shape)}")
    if x.dim() != 3 or x.shape[0] != Vp:
        raise ValueError(f"x must be ({Vp}, B, F), got {tuple(x.shape)}")
    B, Fin = x.shape[1:]
    if W.dim() != 2 or W.shape[0] != 3 * Fin or b.shape != (W.shape[1],):
        raise ValueError(f"W must be ({3 * Fin}, Fout) and b (Fout,), got "
                         f"{tuple(W.shape)}, {tuple(b.shape)}")
    return Vp, Wd, B, Fin, W.shape[1]


# the engine's tables of an offsets tensor, by id (each entry holds its
# tensor, so the id is not reused while it is cached): {id: (tensor, h, Wd,
# warp source rows, span)}
_tables: dict = {}


def _strip_tables(strip_off, h: int, Wd: int):
    """(wrow, span) of the strip form's offsets, once per offsets tensor (the
    pack-time table, not changed in place): wrow (Vp / T, 8) int32 on the
    offsets' device, the source row off[(t T + 16 w) / h] of warp w in row
    tile t, which the hop engine reads; span, the 16-row x groups it stages
    per row tile (`hop.HopLayout.span`): Wd / 16 where h is a multiple of T
    (a row tile's warps share one offset), otherwise from the offsets, read
    from the card and checked by `hop.hop_layout`."""
    hit = _tables.get(id(strip_off))
    if hit is None or hit[1:3] != (h, Wd):
        nt = strip_off.shape[0] * h // _T
        rows = torch.arange(nt)[:, None] * _T + 16 * torch.arange(8)[None, :]
        wrow = strip_off[(rows // h).to(strip_off.device)].contiguous()
        if h % _T == 0:
            span = Wd // 16
        else:
            span = hop_layout(nt, off=strip_off.cpu().tolist(), h=h, wd=Wd).span
        if len(_tables) >= 64:
            _tables.clear()
        hit = _tables[id(strip_off)] = (strip_off, h, Wd, wrow, span)
    return hit[3], hit[4]


def strip_span(strip_off, h: int, Wd: int) -> int:
    """The 16-row x groups the hop engine stages per row tile of the strip
    form (`hop.HopLayout.span`; `_strip_tables`)."""
    return _strip_tables(strip_off, h, Wd)[1]


# the strip conv's launches (csrc/strip_cheby.cu `stages`) in each order
STRIP_STAGES = {"basis": {"hops": 1, "proj": 2},
                "commuted": {"proj": 1, "hop1": 2, "hop2": 4}}
_ALL_STAGES = {"basis": 3, "commuted": 7}


def strip_launcher(strip_val, strip_off, h: int, x, W, b, mode: str, relu: bool, skip=None,
                   skip_w=None):
    """`strip_cheby_conv` on CUDA inputs (checked here): (run, out), where
    run(stages) launches the stages named by the bit mask (STRIP_STAGES[mode])
    into out: (Vp, B, Fout) in basis order, (Vp, B, fo_pad) in commuted order
    (fo_pad = Fout rounded up to 16; the wrapper narrows it to Fout).  The
    wrapper runs all of them once; running them apart only times the split.
    Raises where a row tile's warps need more than hop.MAX_SPAN staged
    16-row groups."""
    Vp, Wd, B, Fin, Fout = _check_args(strip_val, strip_off, h, x, W, b, mode)
    Fs = _check_skip(x, Fout, skip, skip_w)
    extra = {k: v for k, v in (("skip", skip), ("skip_w", skip_w)) if v is not None}
    _check_cuda(x, _T, Fin, strip_val=strip_val, W=W, b=b, **extra)
    if strip_off.device != x.device or strip_off.dtype != torch.int32:
        raise ValueError("strip_off must be int32 on x's device")
    if h % 16 or Wd % 16 or Vp % _T or (skip_w is not None and Fs % 16):
        raise ValueError(f"the kernel takes h, W, Fs multiples of 16 and Vp of {_T}, "
                         f"got h={h}, W={Wd}, Vp={Vp}, Fs={Fs}")
    sms, es = sm_count(x.device), x.element_size()
    wrow, span = _strip_tables(strip_off, h, Wd)
    M, nt = Vp * B, Vp // _T
    skip_mode = 0 if skip is None else (1 if skip_w is None else 2)
    sp, skip_bn, skip_grid = None, 0, 0  # the skip projection's (commuted order)
    if mode == "basis":
        hp = hop_plan(nt, span, B * Fin, sms, es)
        pp = proj_plan(M, Fin, Fout, sms, esize=es)
        Wp = _pad_cols(W, pp.np)
        swp = None if skip_w is None else _pad_cols(skip_w, pp.np)
        s0, s1 = torch.empty_like(x), torch.empty_like(x)
        out = torch.empty((Vp, B, Fout), dtype=x.dtype, device=x.device)
    else:
        pp = commuted_plan(M, Fin, Fout, sms, esize=es)
        fo_pad = pp.np // 3
        hp = hop_plan(nt, span, B * fo_pad, sms, es)
        Wp = _pad_cols(W, fo_pad)
        swp = None if skip_w is None else _pad_cols(skip_w, fo_pad)
        if skip_mode == 1:  # the last hop adds it in the (Vp, B, fo_pad) layout
            skip = _pad_cols(skip, fo_pad)
        if skip_mode == 2:
            sk = commuted_plan(M, Fs, Fout, sms, blocks=1, esize=es)
            skip_bn, skip_grid = sk.bn, sk.grid
            sp = torch.empty((Vp, B, fo_pad), dtype=torch.float32, device=x.device)
        s0 = torch.empty((3, Vp, B, fo_pad), dtype=x.dtype, device=x.device)
        s1, out = (torch.empty((Vp, B, fo_pad), dtype=x.dtype, device=x.device)
                   for _ in range(2))
    lib = _strip_lib()

    def run(stages: int):
        with torch.cuda.device(x.device):
            err = lib.p2m_strip_cheby_conv(
                _ptr(strip_val), _ptr(wrow), _ptr(x), _ptr(Wp), _ptr(b), _ptr(skip),
                _ptr(swp), _ptr(s0), _ptr(s1), _ptr(sp), _ptr(out), Vp, Wd, span, B, Fin,
                Fout, pp.np, Fs, int(mode == "commuted"), int(relu), skip_mode, hp.cc, hp.grid,
                hp.per_block, pp.bn, pp.grid, skip_bn, skip_grid, stages, int(es == 4),
                _stream(x))
        _raise_on(err, lib, "p2m_strip_cheby_error_string")

    return run, out


def strip_cheby_conv(strip_val, strip_off, h: int, x, W, b, *, mode: str, relu: bool,
                     skip: Optional[torch.Tensor] = None,
                     skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv of one band level in its strip form.  strip_val (Vp, Wd),
    strip_off (Vp // h,) int32 window starts, h the strip tile height; x
    (Vp, B, F); W (3F, Fout): [W0; W1; W2] for mode "basis", [W0 - W2; W1;
    W2] for "commuted"; b (Fout,); skip (Vp, B, Fs), skip_w (Fs, Fout).
    Returns (Vp, B, Fout) in x's dtype."""
    Vp, Wd, B, Fin, Fout = _check_args(strip_val, strip_off, h, x, W, b, mode)
    _check_skip(x, Fout, skip, skip_w)
    if x.device.type == "cpu":
        return strip_cheby_conv_plain(strip_val, strip_off, h, x, W, b, mode=mode,
                                      relu=relu, skip=skip, skip_w=skip_w)
    run, out = strip_launcher(strip_val, strip_off, h, x, W, b, mode, relu, skip, skip_w)
    run(_ALL_STAGES[mode])
    launches["strip_cheby_conv"] += 1
    return out if out.shape[-1] == Fout else out[..., :Fout].contiguous()
