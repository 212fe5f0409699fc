"""One banded Laplacian hop, z = L x: the hop of the unfused Chebyshev conv.

Counterpart of the JAX package's `banded_hop` (ops/pallas_cheby.py; Pallas
`_hop_call`, CUDA csrc/banded_hop.cu).  x is vertex-major (V, ...) with
V <= nt*T rows: the training layout at the real row count (missing rows
read as zero) or the deploy layout at the padded count.  The product
accumulates in float32 and rounds once to x's dtype (bf16, or float32: the
float32 instance, no rounding; `fused_cheby.KERNEL_DTYPES`).

`hop` is the kernel wrapper: the plain PyTorch version for a tensor on the
CPU, the CUDA kernel (the banded hop engine, csrc/band_hop.cuh for bf16 and
csrc/band_hop_f32.cuh for float32, as `hop_plan` lays it out: one launch
per hop, two CUDA kernels at float32, its list pass and the stream) for a
tensor on the card (counted in `launches`), and no fallback.
`hop_nonzeros` mirrors the float32 engine's list of a warp's nonzeros (its
order and its batches) for the tests; nothing on the card's path calls it.
`banded_hop` is differentiable: L is symmetric, so its backward is the same
hop on the cotangent, and the band gets no gradient.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..graphs.artifact import LevelOperator
from ..utils.profiling import dtype_name, span
from ._build import load_library
from .fused_cheby import _C_INT, _C_PTR, _T, _check_cuda, _ptr, _raise_on, _stream
from .spmm import band_hop

__all__ = ["F32HopPlan", "HopLayout", "HopNonzeros", "HopPlan", "banded_hop", "band_span", "hop",
           "hop_f32_smem", "hop_layout", "hop_nonzeros", "hop_plain", "hop_plan", "hop_smem",
           "launches"]

# kernel launches since the last reset, by wrapper name
launches = {"banded_hop": 0}


def hop_plain(band_val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `hop`."""
    nbd, nt, T, _ = band_val.shape
    V, dt = x.shape[0], x.dtype
    x2 = F.pad(x.reshape(V, -1), (0, 0, 0, nt * T - V))
    return band_hop(band_val.to(dt), x2).to(dt)[:V].reshape(x.shape)


# the bf16 engine's constants (csrc/band_hop.cuh): pipeline stages of x
# chunks, blocks per SM its registers allow, and the shared memory of one SM
_HOP_STAGES = 2
_HOP_BLOCKS_PER_SM = 2  # kHopBlocksPerSm
HOP_CAP = 12  # nonzero band sub-tiles a warp keeps in registers (kHopCap)
MAX_SPAN = 64  # staged 16-row groups of a row tile: the bits of the engine's mask
_SM_SMEM = 233472
_MAX_BLOCK_SMEM = 232448  # kMaxSmem: the dynamic shared memory one block may use
_BLOCK_SMEM_RESERVED = 1024 + 128  # the runtime's per-block reserve + static masks
_HOP_CHUNKS = (64, 32, 16)  # the bf16 engine's chunk widths
# the float32 engine's (csrc/band_hop_f32.cuh): entries of a warp's nonzero
# list, columns of a chunk
F32_LIST_CAP = 256  # kF32ListCap
F32_CHUNK = 128  # kF32Chunk
_WARPS = 8


@dataclasses.dataclass(frozen=True)
class HopPlan:
    """A launch of the banded hop engine: `cc`-column chunks, `grid` blocks
    of `per_block` (row tile, chunk) items each, `smem` bytes of shared
    memory per block (the bf16 engine's dynamic x ring, the float32
    engine's static lists)."""
    cc: int
    grid: int
    per_block: int
    smem: int
    items: int


@dataclasses.dataclass(frozen=True)
class F32HopPlan(HopPlan):
    """A launch of the float32 engine: also `cap` entries of a warp's
    nonzero list and `band_bytes`, the band rows its list pass reads, each
    row tile's once (T rows of `span` x 16 float32 columns)."""
    cap: int
    band_bytes: int


def band_span(k: int) -> int:
    """The 16-row x groups the engine stages per row tile of the block band
    at band_k k: the (2k+1) T source rows."""
    if k not in (1, 2):
        raise ValueError(f"the hop engine takes band_k in {{1, 2}}, got {k}")
    return (2 * k + 1) * _T // 16


def hop_smem(cc: int, span: int) -> int:
    """Dynamic shared memory of the bf16 engine's x ring for `span` staged
    16-row groups (band_hop_smem)."""
    return _HOP_STAGES * span * 16 * (cc + 8) * 2


def hop_f32_smem() -> int:
    """Static shared memory of a float32 engine block: each warp's list of
    (source row, value) pairs and its 17 row offsets (band_hop_f32_smem)."""
    return _WARPS * (F32_LIST_CAP * 8 + 17 * 4)


def hop_plan(nt: int, span: int, C: int, sms: int, esize: int = 2) -> HopPlan:
    """The engine's launch for C columns of `esize`-byte elements (bf16 2,
    float32 4) over nt row tiles of `span` 16-row source groups each
    (`band_span(k)` for the block band, `HopLayout.span` for the strip form)
    on a card of `sms` SMs.  bf16: the widest chunk dividing C that keeps
    `_HOP_BLOCKS_PER_SM` blocks on an SM, else the widest that fits one; a
    persistent grid of that many blocks per SM walking contiguous runs of
    items.  float32: `_f32_plan`.  A span over MAX_SPAN groups, or one no
    chunk fits, is refused."""
    if C % 16 or not 0 < span <= MAX_SPAN or esize not in (2, 4):
        raise ValueError(f"the hop engine takes C % 16 == 0, at most {MAX_SPAN} staged "
                         f"16-row groups and 2- or 4-byte elements, got C={C}, span={span}, "
                         f"esize={esize}")
    if esize == 4:
        return _f32_plan(nt, span, C)
    fits = [cc for cc in _HOP_CHUNKS if C % cc == 0 and hop_smem(cc, span) <= _MAX_BLOCK_SMEM]
    full = [cc for cc in fits
            if _HOP_BLOCKS_PER_SM * (hop_smem(cc, span) + _BLOCK_SMEM_RESERVED) <= _SM_SMEM]
    if not fits:
        raise ValueError(f"no chunk of the hop engine fits {span} staged groups in one "
                         f"block's shared memory")
    cc = (full or fits)[0]
    items = nt * (C // cc)
    per_block = -(-items // min(items, sms * (_HOP_BLOCKS_PER_SM if full else 1)))
    return HopPlan(cc, -(-items // per_block), per_block, hop_smem(cc, span), items)


@functools.lru_cache(maxsize=None)
def _f32_plan(nt: int, span: int, C: int) -> F32HopPlan:
    """The float32 engine's launch: F32_CHUNK-column chunks (the last masked
    where they do not divide C), one a block.  With the lists built once a
    hop by the list pass, a block's copy of its warps' lists costs little,
    and one chunk a block measured faster than runs of 2, 4 or 8 at every
    SMPL hop shape (tools/hop_sweep.py): many short blocks balance the rows'
    unequal lengths."""
    items = nt * -(-C // F32_CHUNK)
    return F32HopPlan(F32_CHUNK, items, 1, hop_f32_smem(), items, F32_LIST_CAP,
                      nt * _T * span * 16 * 4)


@dataclasses.dataclass(frozen=True)
class HopLayout:
    """How the engine addresses L (csrc/band_hop.cuh): `ld` elements between
    the operator's rows; `src[t][w]` the x row of the first band column of
    warp w in row tile t; `nsub` 16 x 16 sub-tiles per warp row; `strip` for
    the strip form (every sub-tile in range; the block band's out-of-range
    neighbour blocks are skipped)."""
    ld: int
    src: tuple
    nsub: int
    k: int
    strip: bool

    @property
    def nt(self) -> int:
        return len(self.src)

    def subtiles(self, t: int) -> list:
        """The sub-tiles j of row tile t that the engine reads."""
        return [j for j in range(self.nsub)
                if self.strip or 0 <= t + j // 8 - self.k < self.nt]

    def subtile(self, t: int, w: int, j: int) -> tuple:
        """Sub-tile j of warp w in row tile t: (element offset of its first
        row in the operator, the x row its first column takes)."""
        row = (t * _T + 16 * w) * self.ld
        if self.strip:
            return row + 16 * j, self.src[t][w] + 16 * j
        return row + (j // 8) * self.nt * _T * _T + (j % 8) * 16, self.src[t][w] + 16 * j

    def staged(self, t: int) -> tuple:
        """(vmin, groups): the block stages x rows vmin .. + 16 groups for row
        tile t, the union of its warps' source groups (vmin = src[t][0], the
        offsets being non-decreasing); warp w's sub-tile j is staged group
        (src[t][w] - vmin) / 16 + j."""
        lo, hi = self.src[t][0], self.src[t][-1]
        return lo, (hi - lo) // 16 + self.nsub

    @property
    def span(self) -> int:
        """The staged 16-row groups of the widest row tile: hop_plan's span."""
        return max(self.staged(t)[1] for t in range(self.nt))


def hop_layout(nt: int, k: int = 1, off=None, h: int = _T, wd: Optional[int] = None
               ) -> HopLayout:
    """The engine's addressing of the block band (2k+1, nt, T, T), or, given
    the offsets `off` (nt*T / h,), of the strip form (nt*T, wd) of h-row
    strip tiles; the defaults h = T and wd = (2k+1) T give the window form
    (window_cheby.window_cat).  The strip form's offsets must be
    non-decreasing and differ by multiples of 16 within a row tile, as
    graphs.artifact.strip_offset places them."""
    if off is None:
        return HopLayout(_T, tuple((t * _T - k * _T,) * 8 for t in range(nt)),
                         band_span(k), k, False)
    wd = (2 * k + 1) * _T if wd is None else wd
    off = [int(v) for v in off]
    if h <= 0 or h % 16 or nt * _T % h or len(off) != nt * _T // h or wd % 16:
        raise ValueError(f"the strip form takes h and wd multiples of 16 and nt*T / h "
                         f"offsets, got h={h}, wd={wd}, {len(off)} offsets for nt={nt}")
    src = tuple(tuple(off[(t * _T + 16 * w) // h] for w in range(8)) for t in range(nt))
    if any(list(s) != sorted(s) or (s[-1] - s[0]) % 16 or any((v - s[0]) % 16 for v in s)
           for s in src):
        raise ValueError("the offsets of one row tile must be non-decreasing and differ "
                         "by multiples of 16")
    return HopLayout(wd, src, wd // 16, k, True)


@dataclasses.dataclass(frozen=True)
class HopNonzeros:
    """A warp's nonzero list as the float32 engine builds it: entry i takes
    source row `src[i]` and value `val[i]`; row r of the warp's 16 holds
    entries roff[r] .. roff[r + 1]; `batches` lists of F32_LIST_CAP
    entries (one where they fit)."""
    src: np.ndarray
    val: np.ndarray
    roff: tuple
    batches: int


def hop_nonzeros(layout: HopLayout, band_val, t: int, w: int, V: int) -> HopNonzeros:
    """The list of warp w in row tile t (csrc/band_hop_f32.cuh hop_list):
    its operator rows below V in order, each row's band columns in order
    (the in-range sub-tiles j of `layout` ascending, then their 16 columns),
    kept where the value is nonzero and the source row lies in [0, V).
    band_val: the block band (2k+1, nt, T, T) or the strip form (nt*T, Wd),
    as `layout` addresses it."""
    flat = np.asarray(band_val.detach().cpu() if torch.is_tensor(band_val) else band_val,
                      dtype=np.float32).reshape(-1)
    rows = max(0, min(16, V - (t * _T + 16 * w)))
    subs = [layout.subtile(t, w, j) for j in layout.subtiles(t)]
    col = np.arange(16)
    idx = np.array([[off + r * layout.ld + col for off, _ in subs] for r in range(rows)],
                   dtype=np.int64).reshape(rows, 16 * len(subs))
    src = np.broadcast_to(np.concatenate([x0 + col for _, x0 in subs]), idx.shape)
    val = flat[idx]
    keep = (val != 0) & (src >= 0) & (src < V)
    counts = keep.sum(1)
    roff = tuple(int(v) for v in np.concatenate([[0], np.cumsum(counts)]))
    roff += (roff[-1],) * (17 - len(roff))
    return HopNonzeros(src[keep].astype(np.int64), val[keep], roff,
                       max(1, -(-roff[-1] // F32_LIST_CAP)))


@functools.cache
def _hop_lib():
    lib = load_library("banded_hop")
    lib.p2m_banded_hop.argtypes = [_C_PTR] * 3 + [_C_INT] * 8 + [_C_PTR]
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
    V, C, es = x.shape[0], x[0].numel(), x.element_size()
    _check_cuda(x, T, C, band_val=band_val)
    plan = hop_plan(nt, band_span(nbd // 2), C, sm_count(x.device), es)
    out = torch.empty_like(x)
    lib = _hop_lib()
    with torch.cuda.device(x.device):
        err = lib.p2m_banded_hop(_ptr(band_val), _ptr(x), _ptr(out), V, nt, nbd // 2, C,
                                 plan.cc, plan.grid, plan.per_block, int(es == 4),
                                 _stream(x))
    _raise_on(err, lib, "p2m_banded_hop_error_string")
    launches["banded_hop"] += 1
    return out


class _BandedHop(torch.autograd.Function):
    """z = L x with the backward g -> L g (L symmetric); the JAX custom VJP
    `_hop`."""

    @staticmethod
    def forward(ctx, band_val, x):
        ctx.save_for_backward(band_val)
        ctx.dtype_name = dtype_name(x.dtype)
        return hop(band_val, x.contiguous())

    @staticmethod
    def backward(ctx, g):
        with span("p2m.band_conv.bwd", dtype=ctx.dtype_name):
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
