"""K=3 Chebyshev graph conv over the sliding-window form of a band level
(deploy).

Counterpart of the JAX package's `ops/pallas_window.py::fused_conv_flat_window`
(Pallas; CUDA csrc/strip_cheby.cu).  `window_cat` (`graphs.artifact`, where
each band level of nt >= 2k+1 tiles carries the form as `window_val` and
`window_off`) turns the block band (2k+1, nt, T, T) into the sliding-window
form (nt*T, (2k+1)*T): row tile j
holds L[jT:(j+1)T, s_j : s_j + (2k+1)T] with s_j = clip((j - k) T, 0,
nt*T - (2k+1)T), so interior tiles keep the aligned block concatenation and
the first and last k tiles shift their entries instead of clamping.  The
conv always runs in basis order, as the TPU kernel does:

  z1 = L x;  z2 = 2 L z1 - x;  y = act([x, z1, z2] @ W + b)  (+ skip)

z1 and z2 rounded to the working dtype.  The form needs nt >= 2k+1 tiles.

The window form is the strip form (`strip_cheby`) with T-row strip tiles,
width (2k+1) T and the offsets s_j, so the conv is the strip conv's basis
order there, on the card as off it: `window_cheby_conv` runs the plain
PyTorch version for a tensor on the CPU and the strip conv's CUDA launches
(two hops of the banded hop engine reading the form, then the projection
GEMM; csrc/strip_cheby.cu) for a tensor on the card, counting the call in
`launches` (once, whatever the number of CUDA launches); there is no
fallback.  `window_launcher` runs the launches apart.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graphs.artifact import window_cat, window_offsets
from .fused_cheby import _check_skip
from .strip_cheby import STRIP_STAGES, strip_cheby_conv_plain, strip_launcher

__all__ = ["WINDOW_STAGES", "window_cat", "window_offsets", "window_cheby_conv",
           "window_cheby_conv_plain", "window_launcher", "launches"]

# kernel launches since the last reset, by wrapper name
launches = {"window_cheby_conv": 0}


def window_cheby_conv_plain(win, woff, x, W, b, *, relu: bool,
                            skip: Optional[torch.Tensor] = None,
                            skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `window_cheby_conv`: the basis-order conv of
    a hop through a windowed form, with T-row tiles."""
    T = win.shape[0] // woff.shape[0]
    return strip_cheby_conv_plain(win, woff, T, x, W, b, mode="basis", relu=relu,
                                  skip=skip, skip_w=skip_w)


def _check_window(win, woff, x, W, b) -> int:
    """The row-tile height T after checking the shapes."""
    nt = woff.shape[0]
    Vp, Wd = win.shape
    if woff.dim() != 1 or Vp % nt or Wd % (Vp // nt) or Wd // (Vp // nt) not in (3, 5) \
            or nt < Wd // (Vp // nt):
        raise ValueError(f"win (nt*T, (2k+1)*T) and woff (nt,) with k in {{1, 2}} and "
                         f"nt >= 2k+1, got {tuple(win.shape)}, {tuple(woff.shape)}")
    T = Vp // nt
    if x.dim() != 3 or x.shape[0] != Vp:
        raise ValueError(f"x must be ({Vp}, B, F), got {tuple(x.shape)}")
    Fin = x.shape[2]
    if W.dim() != 2 or W.shape[0] != 3 * Fin or b.shape != (W.shape[1],):
        raise ValueError(f"W must be ({3 * Fin}, Fout) and b (Fout,), got "
                         f"{tuple(W.shape)}, {tuple(b.shape)}")
    return T


# the window conv's launches: the strip conv's in basis order (the two hops,
# then the projection)
WINDOW_STAGES = STRIP_STAGES["basis"]
_WINDOW_ALL_STAGES = 3


def window_launcher(win, woff, x, W, b, relu: bool, skip=None, skip_w=None):
    """`window_cheby_conv` on CUDA inputs (checked here): (run, out), where
    run(stages) launches the stages named by the bit mask (WINDOW_STAGES)
    into out: `strip_cheby.strip_launcher` in basis order with T-row strip
    tiles.  The wrapper runs all of them once; running them apart only times
    the split."""
    T = _check_window(win, woff, x, W, b)
    return strip_launcher(win, woff, T, x, W, b, "basis", relu, skip, skip_w)


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
