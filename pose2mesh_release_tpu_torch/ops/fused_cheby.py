"""Fused K=3 Chebyshev graph convs on band levels (deploy forward).

Counterpart of the JAX package's `ops/pallas_cheby.py` deploy kernels:

  fused_cheby_conv            <- fused_conv_flat (Pallas; CUDA csrc/fused_cheby.cu)
      y = act([x, Lx, 2L(Lx) - x] @ W + b)  (+ skip | + skip @ skip_w)
  fused_cheby_conv_commuted   <- fused_conv_flat_commuted
      (Pallas; CUDA csrc/fused_cheby_commuted.cu)
      y = act(x (W0 - W2) + L (x W1 + 2 L (x W2)) + b),  Wc = [W0 - W2; W1; W2]

Band levels keep a vertex-major (Vp, B, F) layout at the pack-time padded
row count Vp = nt * T; `band_val` is (2k+1, nt, T, T), k in {1, 2}.  Both
convs take bf16 or float32 operands, all of one dtype (`KERNEL_DTYPES`, the
rule of every kernel of the port), accumulate in float32 and round the hop
results to the working dtype at the same points as the TPU kernels (in
float32: nowhere).

`fused_cheby_conv` runs on the card as two launches of the banded hop
engine (z1 = L x, z2 = 2 L z1 - x, csrc/band_hop.cuh) and one of the
three-operand projection GEMM (csrc/cheby_proj.cuh); `proj_plan` lays out
that GEMM's launch in pure Python, `conv_launcher` runs the launches apart.
`fused_cheby_conv_commuted` runs as one projection GEMM (a = x (W0 - W2) + b
and p1 = x W1 in float32, p2 = x W2 in x's dtype; `commuted_plan`) and two
engine launches (t = 2 L p2 + p1, y = act(L t + a), each rounded to x's
dtype); `commuted_launcher` runs them apart.

Each wrapper runs the plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on the card, counting the call in
`launches` (once, whatever the number of CUDA launches).  There is no
fallback: a CUDA input the kernel does not take raises.  The bounds of each
kernel on the H100 are in its source note.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import load_library
from .gemm_f32 import gemm_f32_smem, proj_f32_stages
from .spmm import band_hop

__all__ = ["COMMUTED_STAGES", "CONV_STAGES", "KERNEL_DTYPES", "ProjPlan", "check_dtypes",
           "commuted_launcher", "commuted_plan", "conv_launcher", "fused_cheby_conv",
           "fused_cheby_conv_commuted", "fused_cheby_conv_plain",
           "fused_cheby_conv_commuted_plain", "launches", "proj_blocks_per_sm", "proj_plan",
           "proj_smem"]

# kernel launches since the last reset, by wrapper name
launches = {"fused_cheby_conv": 0, "fused_cheby_conv_commuted": 0}

_T = 128             # the kernels' band tile height
_C_INT, _C_PTR = ctypes.c_int, ctypes.c_void_p
# the operand dtypes of every kernel (each has a bf16 and a float32 instance)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def fused_cheby_conv_plain(band_val, x, W, b, *, relu: bool,
                           skip: Optional[torch.Tensor] = None,
                           skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of `fused_cheby_conv`."""
    dt, Fin = x.dtype, x.shape[-1]
    band = band_val.to(dt)
    xf = x.float()
    z1 = band_hop(band, x).to(dt)
    z2 = (2.0 * band_hop(band, z1) - xf).to(dt)
    Wf = W.to(dt).float()
    y = (xf @ Wf[:Fin] + z1.float() @ Wf[Fin:2 * Fin] + z2.float() @ Wf[2 * Fin:]
         + b.to(dt).float())
    if relu:
        y = torch.relu(y)
    if skip is not None:
        s = skip.to(dt).float()
        y = y + (s if skip_w is None else s @ skip_w.to(dt).float())
    return y.to(dt)


def fused_cheby_conv_commuted_plain(band_val, x, Wc, b, *,
                                    relu: bool) -> torch.Tensor:
    """Plain PyTorch version of `fused_cheby_conv_commuted`."""
    dt, Fin = x.dtype, x.shape[-1]
    band = band_val.to(dt)
    xf = x.float()
    Wf = Wc.to(dt).float()
    u = (xf @ Wf[2 * Fin:]).to(dt)
    t = (xf @ Wf[Fin:2 * Fin] + 2.0 * band_hop(band, u)).to(dt)
    y = xf @ Wf[:Fin] + band_hop(band, t) + b.to(dt).float()
    if relu:
        y = torch.relu(y)
    return y.to(dt)


def _check_shapes(band_val, x, W, b):
    if band_val.dim() != 4 or band_val.shape[2] != band_val.shape[3] \
            or band_val.shape[0] not in (3, 5):
        raise ValueError(f"band_val must be (2k+1, nt, T, T) with k in {{1, 2}}, "
                         f"got {tuple(band_val.shape)}")
    nbd, nt, T, _ = band_val.shape
    if x.dim() != 3 or x.shape[0] != nt * T:
        raise ValueError(f"x must be ({nt * T}, B, F), got {tuple(x.shape)}")
    Fin = x.shape[2]
    if W.dim() != 2 or W.shape[0] != 3 * Fin:
        raise ValueError(f"W must be ({3 * Fin}, Fout), got {tuple(W.shape)}")
    if b.shape != (W.shape[1],):
        raise ValueError(f"b must be ({W.shape[1]},), got {tuple(b.shape)}")
    return nbd // 2, nt, T, x.shape[1], Fin, W.shape[1]


def _check_skip(x, Fout: int, skip, skip_w) -> int:
    """The skip's width Fs (0 without a skip), after checking its shapes:
    skip (rows, B, Fs) as x, skip_w (Fs, Fout) or, for a plain add, Fs = Fout."""
    if skip is None:
        if skip_w is not None:
            raise ValueError("skip_w given without skip")
        return 0
    Fs = skip.shape[-1]
    if skip.shape != x.shape[:2] + (Fs,):
        raise ValueError(f"skip must be {tuple(x.shape[:2])} + (Fs,), got {tuple(skip.shape)}")
    if skip_w is None and Fs != Fout:
        raise ValueError(f"skip-add needs Fs == Fout ({Fs} vs {Fout})")
    if skip_w is not None and skip_w.shape != (Fs, Fout):
        raise ValueError(f"skip_w must be ({Fs}, {Fout}), got {tuple(skip_w.shape)}")
    return Fs


def check_dtypes(**tensors) -> torch.dtype:
    """The one dtype of a kernel's operands `tensors` (the first named is the
    input): every operand in it, and it one of KERNEL_DTYPES.  Raises
    TypeError."""
    name0, t0 = next(iter(tensors.items()))
    if t0.dtype not in KERNEL_DTYPES:
        takes = " or ".join(str(d).replace("torch.", "") for d in KERNEL_DTYPES)
        raise TypeError(f"{name0}: the kernel takes {takes}, got {t0.dtype}")
    for name, t in tensors.items():
        if t.dtype != t0.dtype:
            raise TypeError(f"{name} is {t.dtype}, {name0} {t0.dtype}: the kernel takes "
                            f"every operand in one dtype")
    return t0.dtype


def _check_cuda(x, T, Fin, **tensors):
    check_dtypes(x=x, **tensors)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if T != _T:
        raise ValueError(f"the kernel takes {_T}-row band tiles, got {T}")
    if Fin % 16:
        raise ValueError(f"the kernel takes F % 16 == 0, got F={Fin}")
    for name, t in dict(x=x, **tensors).items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")


def _pad_cols(w: torch.Tensor, cols: int) -> torch.Tensor:
    return w if w.shape[-1] == cols else F.pad(w, (0, cols - w.shape[-1]))


def _raise_on(err: int, lib, fn: str):
    if err:
        msg = getattr(lib, fn)(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed ({err}): {msg}")


def _stream(x):
    return _C_PTR(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t: Optional[torch.Tensor]):
    return _C_PTR(t.data_ptr() if t is not None else 0)


@functools.cache
def _fused_lib():
    lib = load_library("fused_cheby")
    lib.p2m_fused_cheby_conv.argtypes = [_C_PTR] * 9 + [_C_INT] * 16 + [_C_PTR]
    lib.p2m_fused_cheby_conv.restype = _C_INT
    lib.p2m_fused_cheby_error_string.argtypes = [_C_INT]
    lib.p2m_fused_cheby_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _commuted_lib():
    lib = load_library("fused_cheby_commuted")
    lib.p2m_fused_cheby_conv_commuted.argtypes = [_C_PTR] * 8 + [_C_INT] * 14 + [_C_PTR]
    lib.p2m_fused_cheby_conv_commuted.restype = _C_INT
    lib.p2m_fused_cheby_commuted_error_string.argtypes = [_C_INT]
    lib.p2m_fused_cheby_commuted_error_string.restype = ctypes.c_char_p
    return lib


# the projection GEMM's tiles (csrc/cheby_proj.cuh; bf16 ring depth)
_PROJ_BM, _PROJ_BK, _PROJ_STAGES = 128, 32, 3


def proj_blocks_per_sm(esize: int = 2) -> int:
    """The projection's blocks on an SM (csrc kProjBlocksPerSm; the float32
    kernel's launch bounds): bf16 2 (registers: at most 128 a thread),
    float32 1 (512 threads, their registers rebalanced between consumers
    and producers)."""
    return 2 if esize == 2 else 1


@dataclasses.dataclass(frozen=True)
class ProjPlan:
    """A launch of the projection GEMM: `bn`-column output tiles of 128 rows
    over W padded to `np` columns (Fout rounded up to 16, then to `bn`), a
    persistent grid of `grid` blocks walking `items` tiles, `smem` bytes of
    dynamic shared memory per block.  bf16 keeps two blocks on an SM,
    float32 one (warp-specialized on wgmma: two consumer and two producer
    warpgroups)."""
    bn: int
    np: int
    items: int
    grid: int
    smem: int


def proj_smem(bn: int, np_: int, stats: bool, esize: int = 2) -> int:
    """Dynamic shared memory of the projection (csrc proj_smem) for
    `esize`-byte operands: bf16 the cp.async ring (A's row stride 8 elements
    of pad) or the staged output tile, whichever is larger; float32 the
    GEMM's planes and raw ring (gemm_f32_smem, proj_f32_stages); then with
    the statistics one float32 sum and sum of squares per (warp row group,
    column): bf16 4 row groups at bn >= 64, else 8; float32 8 (16-row
    warps)."""
    if esize == 2:
        ring = _PROJ_STAGES * (_PROJ_BM * (_PROJ_BK + 8) + _PROJ_BK * (bn + 8)) * esize
        base = max(ring, _PROJ_BM * (bn + 8) * esize)
        row_groups = 8 // (2 if bn >= 64 else 1)
    else:
        base, row_groups = gemm_f32_smem(_PROJ_BM, bn, proj_f32_stages(bn, stats)), 8
    return base + (2 * row_groups * np_ * 4 if stats else 0)


def _proj_widths(esize: int) -> tuple:
    """The tile widths of the projection's instances, widest first (bf16 and
    float32 alike)."""
    if esize not in (2, 4):
        raise ValueError(f"the projection takes 2- or 4-byte elements, got {esize}")
    return (128, 64, 32, 16)


def proj_plan(M: int, F: int, Fout: int, sms: int, stats: bool = False,
              esize: int = 2) -> ProjPlan:
    """The projection's launch for M rows, F -> Fout, of `esize`-byte
    operands on a card of `sms` SMs (with `stats`, the statistics epilogue's
    shared memory)."""
    if M <= 0 or F <= 0 or F % 16 or Fout <= 0:
        raise ValueError(f"the projection takes M > 0, F % 16 == 0 and Fout > 0, "
                         f"got M={M}, F={F}, Fout={Fout}")
    widest = _proj_widths(esize)[0]
    fo_pad = -(-Fout // 16) * 16
    if fo_pad <= 64:
        bn = next(b for b in (16, 32, 64) if fo_pad <= b)
    else:
        bn = 128 if fo_pad % 128 == 0 and widest == 128 else 64
    np_ = -(-fo_pad // bn) * bn
    items = -(-M // _PROJ_BM) * (np_ // bn)
    return ProjPlan(bn, np_, items, min(items, proj_blocks_per_sm(esize) * sms),
                    proj_smem(bn, np_, stats, esize))


def commuted_plan(M: int, F: int, Fo: int, sms: int, blocks: int = 3,
                  esize: int = 2) -> ProjPlan:
    """The commuted conv's projection (epilogues kEpiCommuted,
    kEpiCommutedT) for M rows of x, F -> [a | p1 | p2] or [p | t0 | u]:
    three column blocks of fo_pad (Fo rounded up to 16), `bn` the widest tile
    dividing fo_pad, so a tile lies in one block; np = 3 fo_pad.  With
    blocks=1 the one-block projection of kEpiF32 (np = fo_pad).  esize: the
    operands' element size."""
    if M <= 0 or F <= 0 or F % 16 or Fo <= 0 or blocks not in (1, 3):
        raise ValueError(f"the projection takes M > 0, F % 16 == 0, Fo > 0 and 1 or 3 "
                         f"blocks, got M={M}, F={F}, Fo={Fo}, blocks={blocks}")
    fo_pad = -(-Fo // 16) * 16
    bn = next(b for b in _proj_widths(esize) if fo_pad % b == 0)
    items = -(-M // _PROJ_BM) * (blocks * fo_pad // bn)
    return ProjPlan(bn, blocks * fo_pad, items, min(items, proj_blocks_per_sm(esize) * sms),
                    proj_smem(bn, blocks * fo_pad, False, esize))


# the group conv's launches (csrc/fused_cheby.cu `stages`): the two hops,
# then the projection
CONV_STAGES = {"hops": 1, "proj": 2}
_CONV_ALL_STAGES = 3


def conv_launcher(band_val, x, W, b, relu: bool, skip=None, skip_w=None):
    """`fused_cheby_conv` on CUDA inputs (checked here): (run, out), where
    run(stages) launches the stages named by the bit mask (CONV_STAGES) into
    out.  The wrapper runs all of them once; running them apart only times
    the split."""
    # hop.py imports this module's helpers, so its plan is imported here
    from .hop import band_span, hop_plan, sm_count
    k, nt, T, B, Fin, Fout = _check_shapes(band_val, x, W, b)
    Fs = _check_skip(x, Fout, skip, skip_w)
    extra = {} if skip is None else {"skip": skip}
    if skip_w is not None:
        extra["skip_w"] = skip_w
    _check_cuda(x, T, Fin, band_val=band_val, W=W, b=b, **extra)
    if skip_w is not None and Fs % 16:
        raise ValueError(f"the skip projection takes Fs % 16 == 0, got Fs={Fs}")
    sms, es = sm_count(x.device), x.element_size()
    hp = hop_plan(nt, band_span(k), B * Fin, sms, es)
    pp = proj_plan(x.shape[0] * B, Fin, Fout, sms, esize=es)
    Wp = _pad_cols(W, pp.np)
    swp = None if skip_w is None else _pad_cols(skip_w, pp.np)
    skip_mode = 0 if skip is None else (1 if skip_w is None else 2)
    z1, z2 = torch.empty_like(x), torch.empty_like(x)
    out = torch.empty((x.shape[0], B, Fout), dtype=x.dtype, device=x.device)
    lib = _fused_lib()

    def run(stages: int):
        with torch.cuda.device(x.device):
            err = lib.p2m_fused_cheby_conv(
                _ptr(band_val), _ptr(x), _ptr(Wp), _ptr(b), _ptr(skip), _ptr(swp),
                _ptr(z1), _ptr(z2), _ptr(out), nt, k, B, Fin, Fout, pp.np, Fs, int(relu),
                skip_mode, hp.cc, hp.grid, hp.per_block, pp.bn, pp.grid, stages, int(es == 4),
                _stream(x))
        _raise_on(err, lib, "p2m_fused_cheby_error_string")

    return run, out


def fused_cheby_conv(band_val, x, W, b, *, relu: bool,
                     skip: Optional[torch.Tensor] = None,
                     skip_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act([x, Lx, 2L(Lx) - x] @ W + b), then + skip (skip_w None) or
    + skip @ skip_w.  band_val (2k+1, nt, T, T); x (nt*T, B, F); W (3F, Fout)
    basis-major; b (Fout,); skip (nt*T, B, Fs); skip_w (Fs, Fout).
    Returns (nt*T, B, Fout) in x's dtype."""
    _check_shapes(band_val, x, W, b)
    _check_skip(x, W.shape[1], skip, skip_w)
    if x.device.type == "cpu":
        return fused_cheby_conv_plain(band_val, x, W, b, relu=relu,
                                      skip=skip, skip_w=skip_w)
    run, out = conv_launcher(band_val, x, W, b, relu, skip, skip_w)
    run(_CONV_ALL_STAGES)
    launches["fused_cheby_conv"] += 1
    return out


# the commuted conv's launches (csrc/fused_cheby_commuted.cu `stages`): the
# projection, the hop t = bf16(2 L p2 + p1), the hop y = bf16(act(L t + a))
COMMUTED_STAGES = {"proj": 1, "hop1": 2, "hop2": 4}
_COMMUTED_ALL_STAGES = 7


def commuted_launcher(band_val, x, Wc, b, relu: bool):
    """`fused_cheby_conv_commuted` on CUDA inputs (checked here): (run, out),
    where run(stages) launches the stages named by the bit mask
    (COMMUTED_STAGES) into out, (nt*T, B, fo_pad) with fo_pad = Fo rounded
    up to 16.  The wrapper runs all of them once and narrows out to Fo; running
    them apart only times the split."""
    from .hop import band_span, hop_plan, sm_count
    k, nt, T, B, Fin, Fo = _check_shapes(band_val, x, Wc, b)
    _check_cuda(x, T, Fin, band_val=band_val, Wc=Wc, b=b)
    sms, es = sm_count(x.device), x.element_size()
    rows = x.shape[0]
    pp = commuted_plan(rows * B, Fin, Fo, sms, esize=es)
    fo_pad = pp.np // 3
    hp = hop_plan(nt, band_span(k), B * fo_pad, sms, es)
    Wp = _pad_cols(Wc, fo_pad)
    ap1 = torch.empty((2, rows, B, fo_pad), dtype=torch.float32, device=x.device)
    p2, t = (torch.empty((rows, B, fo_pad), dtype=x.dtype, device=x.device) for _ in range(2))
    out = torch.empty((rows, B, fo_pad), dtype=x.dtype, device=x.device)
    lib = _commuted_lib()

    def run(stages: int):
        with torch.cuda.device(x.device):
            err = lib.p2m_fused_cheby_conv_commuted(
                _ptr(band_val), _ptr(x), _ptr(Wp), _ptr(b), _ptr(ap1), _ptr(p2), _ptr(t),
                _ptr(out), nt, k, B, Fin, Fo, fo_pad, int(relu), hp.cc, hp.grid,
                hp.per_block, pp.bn, pp.grid, stages, int(es == 4), _stream(x))
        _raise_on(err, lib, "p2m_fused_cheby_commuted_error_string")

    return run, out


def fused_cheby_conv_commuted(band_val, x, Wc, b, *, relu: bool) -> torch.Tensor:
    """y = act(x (W0 - W2) + L (x W1 + 2 L (x W2)) + b) with
    Wc = [W0 - W2; W1; W2] (3F, Fo).  Returns (nt*T, B, Fo)."""
    _check_shapes(band_val, x, Wc, b)
    if x.device.type == "cpu":
        return fused_cheby_conv_commuted_plain(band_val, x, Wc, b, relu=relu)
    run, out = commuted_launcher(band_val, x, Wc, b, relu)
    run(_COMMUTED_ALL_STAGES)
    launches["fused_cheby_conv_commuted"] += 1
    Fo = Wc.shape[1]
    return out if out.shape[-1] == Fo else out[..., :Fo].contiguous()
