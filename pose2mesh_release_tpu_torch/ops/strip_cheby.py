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
order, all to the working dtype.  The commuted weights are passed formed,
W = [W0 - W2; W1; W2] in the working dtype.

`strip_cheby_conv` runs the plain PyTorch version for a tensor on the CPU and
the CUDA kernels for a tensor on the card, counting one launch per conv in
`launches` (the CUDA version runs the conv as 3 launches in basis order and 5
in commuted order); there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _check_cuda, _check_skip, _pad_cols, _ptr, \
    _raise_on, _stream

__all__ = ["strip_cheby_conv", "strip_cheby_conv_plain", "strip_mode", "windowed_hop",
           "launches"]

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
    lib.p2m_strip_cheby_conv.argtypes = [_C_PTR] * 11 + [_C_INT] * 11 + [_C_PTR]
    lib.p2m_strip_cheby_conv.restype = _C_INT
    lib.p2m_strip_cheby_error_string.argtypes = [_C_INT]
    lib.p2m_strip_cheby_error_string.restype = ctypes.c_char_p
    return lib


def strip_cheby_conv(strip_val, strip_off, h: int, x, W, b, *, mode: str, relu: bool,
                     skip: Optional[torch.Tensor] = None,
                     skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv of one band level in its strip form.  strip_val (Vp, Wd),
    strip_off (Vp // h,) int32 window starts, h the strip tile height; x
    (Vp, B, F); W (3F, Fout): [W0; W1; W2] for mode "basis", [W0 - W2; W1;
    W2] for "commuted"; b (Fout,); skip (Vp, B, Fs), skip_w (Fs, Fout).
    Returns (Vp, B, Fout) in x's dtype."""
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
    Fout = W.shape[1]
    Fs = _check_skip(x, Fout, skip, skip_w)
    if x.device.type == "cpu":
        return strip_cheby_conv_plain(strip_val, strip_off, h, x, W, b, mode=mode,
                                      relu=relu, skip=skip, skip_w=skip_w)
    extra = {k: v for k, v in (("skip", skip), ("skip_w", skip_w)) if v is not None}
    _check_cuda(x, 128, Fin, strip_val=strip_val, W=W, b=b, **extra)
    if strip_off.device != x.device or strip_off.dtype != torch.int32:
        raise ValueError("strip_off must be int32 on x's device")
    if h % 16 or Wd % 16 or Vp % 128 or (skip_w is not None and Fs % 16):
        raise ValueError(f"the kernel takes h, W, Fs multiples of 16 and Vp of 128, "
                         f"got h={h}, W={Wd}, Vp={Vp}, Fs={Fs}")
    fo_pad = -(-Fout // 16) * 16
    Wp = _pad_cols(W, fo_pad)
    bp = _pad_cols(b, fo_pad)
    swp = None if skip_w is None else _pad_cols(skip_w, fo_pad)
    skip_mode = 0 if skip is None else (1 if skip_w is None else 2)
    commuted = mode == "commuted"
    width = fo_pad if commuted else Fin
    scratch = [torch.empty((Vp, B, width), dtype=x.dtype, device=x.device)
               for _ in range(3 if commuted else 2)] + [None]
    out = torch.empty((Vp, B, Fout), dtype=x.dtype, device=x.device)
    lib = _strip_lib()
    with torch.cuda.device(x.device):
        err = lib.p2m_strip_cheby_conv(
            _ptr(strip_val), _ptr(strip_off), _ptr(x), _ptr(Wp), _ptr(bp), _ptr(skip),
            _ptr(swp), _ptr(out), _ptr(scratch[0]), _ptr(scratch[1]), _ptr(scratch[2]),
            Vp, h, Wd, B, Fin, Fout, fo_pad, Fs, int(commuted), int(relu), skip_mode,
            _stream(x))
    _raise_on(err, lib, "p2m_strip_cheby_error_string")
    launches["strip_cheby_conv"] += 1
    return out
