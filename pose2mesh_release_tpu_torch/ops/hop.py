"""One banded Laplacian hop, z = L x: the hop of the unfused Chebyshev conv.

Counterpart of the JAX package's `banded_hop` (ops/pallas_cheby.py; Pallas
`_hop_call`, CUDA csrc/banded_hop.cu).  x is vertex-major (V, ...) with
V <= nt*T rows: the training layout at the real row count (missing rows
read as zero) or the deploy layout at the padded count.  The product
accumulates in float32 and rounds once to x's dtype.

`hop` is the kernel wrapper: the plain PyTorch version for a tensor on the
CPU, the CUDA kernel (the banded hop engine, csrc/band_hop.cuh, one launch
per hop as `hop_plan` lays it out) for a tensor on the card (counted in
`launches`), and no fallback.  `banded_hop` is differentiable: L is
symmetric, so its backward is the same hop on the cotangent, and the band
gets no gradient.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..graphs.artifact import LevelOperator
from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _T, _check_cuda, _ptr, _raise_on, _stream
from .spmm import band_hop

__all__ = ["HopLayout", "HopPlan", "banded_hop", "hop", "hop_layout", "hop_plain", "hop_plan",
           "launches"]

# kernel launches since the last reset, by wrapper name
launches = {"banded_hop": 0}


def hop_plain(band_val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hop`."""
    nbd, nt, T, _ = band_val.shape
    V, dt = x.shape[0], x.dtype
    x2 = F.pad(x.reshape(V, -1), (0, 0, 0, nt * T - V))
    return band_hop(band_val.to(dt), x2).to(dt)[:V].reshape(x.shape)


# the engine's constants (csrc/band_hop.cuh): pipeline stages of x chunks,
# blocks per SM its registers allow, and the shared memory of one SM
_HOP_STAGES = 2
_HOP_BLOCKS_PER_SM = 2  # kHopBlocksPerSm
HOP_CAP = 12  # nonzero band sub-tiles a warp keeps in registers (kHopCap)
_SM_SMEM = 233472
_BLOCK_SMEM_RESERVED = 1024 + 64  # the runtime's per-block reserve + static masks


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """A launch of the banded hop engine: `cc`-column chunks, `grid` blocks
    of `per_block` (row tile, chunk) items each, `smem` bytes of dynamic
    shared memory per block."""
    cc: int
    grid: int
    per_block: int
    smem: int
    items: int


def hop_smem(cc: int, k: int) -> int:
    """Dynamic shared memory of the engine's x ring (band_hop_smem)."""
    return _HOP_STAGES * (2 * k + 1) * _T * (cc + 8) * 2


def hop_plan(nt: int, k: int, C: int, sms: int) -> HopPlan:
    """The engine's launch for C columns over nt row tiles at band_k k on a
    card of `sms` SMs: the widest chunk dividing C that keeps
    `_HOP_BLOCKS_PER_SM` blocks on an SM, else the widest that fits one; a
    persistent grid of that many blocks per SM walking contiguous runs of
    items."""
    if C % 16 or k not in (1, 2):
        raise ValueError(f"the hop engine takes C % 16 == 0 and band_k in {{1, 2}}, "
                         f"got C={C}, k={k}")
    fits = [cc for cc in (64, 32, 16) if C % cc == 0]
    full = [cc for cc in fits
            if _HOP_BLOCKS_PER_SM * (hop_smem(cc, k) + _BLOCK_SMEM_RESERVED) <= _SM_SMEM]
    cc = (full or fits)[0]
    items = nt * (C // cc)
    per_block = -(-items // min(items, sms * _HOP_BLOCKS_PER_SM))
    return HopPlan(cc, -(-items // per_block), per_block, hop_smem(cc, k), items)


@dataclasses.dataclass(frozen=True)
class HopLayout:
    """How the engine addresses L (csrc/band_hop.cuh): `ld` elements between
    the operator's rows, `dstride` between the 2k+1 blocks of one row, `src0`
    the x row of each row tile's first band column; `window` for the window
    form, whose blocks are all in range (the block band's out-of-range
    neighbour blocks are skipped)."""
    ld: int
    dstride: int
    src0: tuple
    k: int
    window: bool

    def blocks(self, t: int) -> list:
        """The blocks d of row tile t that the engine reads."""
        nt = len(self.src0)
        return [d for d in range(2 * self.k + 1)
                if self.window or 0 <= t + d - self.k < nt]

    def subtile(self, t: int, w: int, j: int) -> tuple:
        """Sub-tile j = 8 d + cg of warp w in row tile t: (element offset of
        its first row in the operator, the x row its first column takes)."""
        return ((t * _T + 16 * w) * self.ld + (j // 8) * self.dstride + (j % 8) * 16,
                self.src0[t] + 16 * j)


def hop_layout(nt: int, k: int, woff=None) -> HopLayout:
    """The engine's addressing of the block band (2k+1, nt, T, T), or of the
    window form (nt*T, (2k+1)*T) with offsets `woff` (window_cheby.window_cat)."""
    if woff is None:
        return HopLayout(_T, nt * _T * _T, tuple((t - k) * _T for t in range(nt)), k, False)
    return HopLayout((2 * k + 1) * _T, _T, tuple(int(v) for v in woff), k, True)


@functools.cache
def _hop_lib():
    lib = load_library("banded_hop")
    lib.p2m_banded_hop.argtypes = [_C_PTR] * 3 + [_C_INT] * 7 + [_C_PTR]
    lib.p2m_banded_hop.restype = _C_INT
    lib.p2m_banded_hop_error_string.argtypes = [_C_INT]
    lib.p2m_banded_hop_error_string.restype = ctypes.c_char_p
    return lib


def sm_count(dev) -> int:
    """Streaming multiprocessors of the card `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def hop(band_val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """L @ x for band_val (2k+1, nt, T, T) and x (V, ...), V <= nt*T; the
    result has x's shape and dtype."""
    if band_val.dim() != 4 or band_val.shape[0] not in (3, 5) \
            or band_val.shape[2] != band_val.shape[3]:
        raise ValueError(f"band_val must be (2k+1, nt, T, T) with k in {{1, 2}}, "
                         f"got {tuple(band_val.shape)}")
    nbd, nt, T, _ = band_val.shape
    if x.dim() < 2 or not 0 < x.shape[0] <= nt * T:
        raise ValueError(f"x must be (V, ...) with V <= {nt * T}, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return hop_plain(band_val, x)
    V, C = x.shape[0], x[0].numel()
    _check_cuda(x, T, C, band_val=band_val)
    plan = hop_plan(nt, nbd // 2, C, sm_count(x.device))
    out = torch.empty_like(x)
    lib = _hop_lib()
    with torch.cuda.device(x.device):
        err = lib.p2m_banded_hop(_ptr(band_val), _ptr(x), _ptr(out), V, nt, nbd // 2, C,
                                 plan.cc, plan.grid, plan.per_block, _stream(x))
    _raise_on(err, lib, "p2m_banded_hop_error_string")
    launches["banded_hop"] += 1
    return out


class _BandedHop(torch.autograd.Function):
    """z = L x with the backward g -> L g (L symmetric); the JAX custom VJP
    `_hop`."""

    @staticmethod
    def forward(ctx, band_val, x):
        ctx.save_for_backward(band_val)
        return hop(band_val, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        (band_val,) = ctx.saved_tensors
        return None, hop(band_val, g.contiguous())


def banded_hop(band, x: torch.Tensor) -> torch.Tensor:
    """Differentiable z = L x.  band: a band-kind LevelOperator (band_k in
    {1, 2}) or its band_val."""
    if isinstance(band, LevelOperator):
        if band.kind != "band" or not 1 <= band.band_k <= 2:
            raise ValueError(f"banded_hop needs a band level with band_k in {{1, 2}}, "
                             f"got kind {band.kind!r}, band_k {band.band_k}")
        band = band.band_val
    return _BandedHop.apply(band, x)
