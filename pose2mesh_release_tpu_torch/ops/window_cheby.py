"""K=3 Chebyshev graph conv over the sliding-window form of a band level
(deploy).

Counterpart of the JAX package's `ops/pallas_window.py::fused_conv_flat_window`
(Pallas; CUDA csrc/window_cheby.cu).  `window_cat` turns the block band
(2k+1, nt, T, T) into the sliding-window form (nt*T, (2k+1)*T): row tile j
holds L[jT:(j+1)T, s_j : s_j + (2k+1)T] with s_j = clip((j - k) T, 0,
nt*T - (2k+1)T), so interior tiles keep the aligned block concatenation and
the first and last k tiles shift their entries instead of clamping.  The
conv always runs in basis order, as the TPU kernel does:

  z1 = L x;  z2 = 2 L z1 - x;  y = act([x, z1, z2] @ W + b)  (+ skip)

z1 and z2 rounded to the working dtype.  The form needs nt >= 2k+1 tiles.

`window_cheby_conv` runs the plain PyTorch version for a tensor on the CPU and
launches the CUDA kernel for a tensor on the card, counting the call in
`launches` (once, whatever the number of CUDA launches); there is no
fallback.  On the card the conv is the group conv's design run on the window
form: two launches of the banded hop engine reading `win` and `woff`
(csrc/band_hop.cuh, its WIN layout; `hop.hop_layout` mirrors the addressing)
and the projection GEMM; `window_launcher` runs the launches apart.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _check_cuda, _check_skip, _pad_cols, _ptr, \
    _raise_on, _stream, proj_plan
from .hop import hop_plan, sm_count
from .strip_cheby import strip_cheby_conv_plain

__all__ = ["WINDOW_STAGES", "window_cat", "window_offsets", "window_cheby_conv",
           "window_cheby_conv_plain", "window_launcher", "launches"]

# kernel launches since the last reset, by wrapper name
launches = {"window_cheby_conv": 0}


def window_offsets(nt: int, k: int, T: int) -> np.ndarray:
    """s_j = clip((j - k) T, 0, nt*T - (2k+1) T) for the nt row tiles."""
    return np.clip((np.arange(nt) - k) * T, 0, (nt - 2 * k - 1) * T).astype(np.int32)


def window_cat(band_val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2k+1, nt, T, T) block band -> (win (nt*T, (2k+1)*T), offsets (nt,)
    int32), on band_val's device and in its dtype."""
    nbd, nt, T, _ = band_val.shape
    k = nbd // 2
    if nt < nbd:
        raise ValueError(f"the window form needs nt >= 2k+1 tiles, got nt={nt}, k={k}")
    cat = band_val.permute(1, 2, 0, 3).reshape(nt, T, nbd * T)
    win = cat.clone()
    for j in range(k):  # top edge: shift left by (k - j) tiles
        sh = (k - j) * T
        win[j] = torch.nn.functional.pad(cat[j, :, sh:], (0, sh))
    for j in range(nt - k, nt):  # bottom edge: shift right
        sh = (j + k + 1 - nt) * T
        win[j] = torch.nn.functional.pad(cat[j, :, :nbd * T - sh], (sh, 0))
    off = torch.from_numpy(window_offsets(nt, k, T)).to(band_val.device)
    return win.reshape(nt * T, nbd * T), off


def window_cheby_conv_plain(win, woff, x, W, b, *, relu: bool,
                            skip: Optional[torch.Tensor] = None,
                            skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `window_cheby_conv`: the basis-order conv of
    a hop through a windowed form, with T-row tiles."""
    T = win.shape[0] // woff.shape[0]
    return strip_cheby_conv_plain(win, woff, T, x, W, b, mode="basis", relu=relu,
                                  skip=skip, skip_w=skip_w)


@functools.cache
def _window_lib():
    lib = load_library("window_cheby")
    lib.p2m_window_cheby_conv.argtypes = [_C_PTR] * 10 + [_C_INT] * 15 + [_C_PTR]
    lib.p2m_window_cheby_conv.restype = _C_INT
    lib.p2m_window_cheby_error_string.argtypes = [_C_INT]
    lib.p2m_window_cheby_error_string.restype = ctypes.c_char_p
    return lib


def _check_window(win, woff, x, W, b):
    """(nt, T, k, B, Fin, Fout) after checking the shapes."""
    nt = woff.shape[0]
    Vp, Wd = win.shape
    if woff.dim() != 1 or Vp % nt or Wd % (Vp // nt) or Wd // (Vp // nt) not in (3, 5) \
            or nt < Wd // (Vp // nt):
        raise ValueError(f"win (nt*T, (2k+1)*T) and woff (nt,) with k in {{1, 2}} and "
                         f"nt >= 2k+1, got {tuple(win.shape)}, {tuple(woff.shape)}")
    T = Vp // nt
    if x.dim() != 3 or x.shape[0] != Vp:
        raise ValueError(f"x must be ({Vp}, B, F), got {tuple(x.shape)}")
    B, Fin = x.shape[1:]
    if W.dim() != 2 or W.shape[0] != 3 * Fin or b.shape != (W.shape[1],):
        raise ValueError(f"W must be ({3 * Fin}, Fout) and b (Fout,), got "
                         f"{tuple(W.shape)}, {tuple(b.shape)}")
    return nt, T, Wd // T // 2, B, Fin, W.shape[1]


# the window conv's launches (csrc/window_cheby.cu `stages`): the two hops,
# then the projection
WINDOW_STAGES = {"hops": 1, "proj": 2}
_WINDOW_ALL_STAGES = 3


def window_launcher(win, woff, x, W, b, relu: bool, skip=None, skip_w=None):
    """`window_cheby_conv` on CUDA inputs (checked here): (run, out), where
    run(stages) launches the stages named by the bit mask (WINDOW_STAGES)
    into out.  The wrapper runs all of them once; running them apart only
    times the split."""
    nt, T, k, B, Fin, Fout = _check_window(win, woff, x, W, b)
    Fs = _check_skip(x, Fout, skip, skip_w)
    extra = {k_: v for k_, v in (("skip", skip), ("skip_w", skip_w)) if v is not None}
    _check_cuda(x, T, Fin, win=win, W=W, b=b, **extra)
    if woff.device != x.device or woff.dtype != torch.int32:
        raise ValueError("woff must be int32 on x's device")
    if skip_w is not None and Fs % 16:
        raise ValueError(f"the skip projection takes Fs % 16 == 0, got Fs={Fs}")
    sms = sm_count(x.device)
    hp = hop_plan(nt, k, B * Fin, sms)
    pp = proj_plan(x.shape[0] * B, Fin, Fout, sms)
    Wp = _pad_cols(W, pp.np)
    swp = None if skip_w is None else _pad_cols(skip_w, pp.np)
    skip_mode = 0 if skip is None else (1 if skip_w is None else 2)
    z1, z2 = torch.empty_like(x), torch.empty_like(x)
    out = torch.empty((x.shape[0], B, Fout), dtype=x.dtype, device=x.device)
    lib = _window_lib()

    def run(stages: int):
        with torch.cuda.device(x.device):
            err = lib.p2m_window_cheby_conv(
                _ptr(win), _ptr(woff), _ptr(x), _ptr(Wp), _ptr(b), _ptr(skip), _ptr(swp),
                _ptr(z1), _ptr(z2), _ptr(out), nt, k, B, Fin, Fout, pp.np, Fs, int(relu),
                skip_mode, hp.cc, hp.grid, hp.per_block, pp.bn, pp.grid, stages, _stream(x))
        _raise_on(err, lib, "p2m_window_cheby_error_string")

    return run, out


def window_cheby_conv(win, woff, x, W, b, *, relu: bool,
                      skip: Optional[torch.Tensor] = None,
                      skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act([x, Lx, 2L(Lx) - x] @ W + b) (+ skip) with L in its window form
    (win, woff) = `window_cat(band_val)`.  x (nt*T, B, F); W (3F, Fout)
    basis-major; b (Fout,); skip (nt*T, B, Fs), skip_w (Fs, Fout).  Returns
    (nt*T, B, Fout) in x's dtype."""
    _check_window(win, woff, x, W, b)
    _check_skip(x, W.shape[1], skip, skip_w)
    if x.device.type == "cpu":
        return window_cheby_conv_plain(win, woff, x, W, b, relu=relu, skip=skip,
                                       skip_w=skip_w)
    run, out = window_launcher(win, woff, x, W, b, relu, skip, skip_w)
    run(_WINDOW_ALL_STAGES)
    launches["window_cheby_conv"] += 1
    return out
