"""The dense levels' K=3 Chebyshev basis [x, L x, 2 L (L x) - x] over L's
nonzeros, forward and backward (csrc/dense_cheby.cu).

The joint graph and the mesh levels stored dense (V <= dense_threshold) hold
about 7 nonzeros a row.  `dense_cheby_stack(op, x)` reads L from the level's
row table (`op.csr_ptr`, `csr_col`, `csr_val`: `graphs.artifact.dense_rows`,
built with the artifact, in the compute dtype) and writes the fin-major stack
(V, ..., Fin*3) that `models.posenet.linear` reads, in one launch.  It rounds
where `ops.cheby.chebyshev_stack` rounds: z1 = R(L x), z2 = R(2 R(L z1) - x),
sums in float32.  Its backward is the same kernel on the cotangent (L is
symmetric, `dense_rows` checks it): u = R(g1 + 2 R(L g2)), dx = R(R(g0 -
g2) + R(L u)), autograd's rounding points through `chebyshev_stack`, with no
saved activation; L gets no gradient.

The wrapper rule of the port: a CPU tensor takes the plain version,
`chebyshev_stack` itself (differentiable by autograd); a CUDA tensor
launches the kernel (counted in `launches`: each forward and each backward
call) or raises.  There is no fallback.  `dense_cheby_plain` /
`dense_cheby_bwd_plain` repeat the kernel's arithmetic over the ELL form
(`ops.spmm.spmm_ell`) in plain PyTorch for the tests; `dense_plan` lays out
its launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..graphs.artifact import LevelOperator
from ..utils.profiling import dtype_name, span
from ._build import load_library
from .cheby import chebyshev_stack
from .fused_cheby import _C_INT, _C_PTR, _ptr, _raise_on, _stream, check_dtypes
from .hop import sm_count
from .spmm import spmm_ell

__all__ = ["DensePlan", "DENSE_WIDTHS", "dense_cheby_bwd_plain", "dense_cheby_plain",
           "dense_cheby_stack", "dense_plan", "dense_smem", "launches"]

# kernel launches since the last reset: the forward, the backward
launches = {"dense_cheby_stack": 0, "dense_cheby_stack_bwd": 0}

# slice widths in columns, widest first; a warp reads at most 128 bytes of a
# source row (64 bf16, 32 float32 columns)
DENSE_WIDTHS = (64, 32, 16, 8, 4, 2)
_ROW_BYTES = 128
# the shared memory a block may take: a slice's two buffers and L's rows
# within ~200 KB, under the 227 KB one block may use
_SMEM_BUDGET = 200 * 1024


# threads a block: one a (row, column pair) of the slice, 128 to 1024
_MIN_THREADS, _MAX_THREADS = 128, 1024


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """A launch of the kernel: `w`-column slices (log2 `lw`), `grid` blocks
    of `threads` threads, `smem` bytes of dynamic shared memory each."""
    w: int
    lw: int
    grid: int
    smem: int
    threads: int


def dense_smem(V: int, nnz: int, w: int, esize: int) -> int:
    """Dynamic shared memory of a block (csrc/dense_cheby.cu): L's rows as
    8-byte (column, value) pairs and V+1 offsets, 16-byte aligned, then two
    V x w buffers of `esize`-byte elements."""
    return -(-(8 * nnz + 4 * (V + 1)) // 16) * 16 + 2 * V * w * esize


@functools.lru_cache(maxsize=None)
def dense_plan(V: int, nnz: int, C: int, esize: int, sms: int) -> DensePlan:
    """The slice width for V rows of L (nnz entries) over C columns of
    `esize`-byte elements on a card of `sms` SMs: the widest of DENSE_WIDTHS
    within a 128-byte row run and the shared-memory budget whose grid still
    covers the SMs, else the narrowest that fits; a thread a (row, column
    pair), a multiple of 32 from 128 to 1024.  Raises where none fits."""
    fits = [w for w in DENSE_WIDTHS
            if w * esize <= _ROW_BYTES and dense_smem(V, nnz, w, esize) <= _SMEM_BUDGET]
    if not fits:
        raise ValueError(f"a dense level of {V} vertices and {nnz} nonzeros does not fit "
                         f"the kernel's shared memory")
    w = next((w for w in fits if -(-C // w) >= sms), fits[-1])
    threads = min(_MAX_THREADS, max(_MIN_THREADS, -(-V * w // 2 // 32) * 32))
    return DensePlan(w, w.bit_length() - 1, -(-C // w), dense_smem(V, nnz, w, esize), threads)


def dense_cheby_plain(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    """The kernel's forward in plain PyTorch: (V, ..., Fin) -> (V, ..., 3 Fin)."""
    dt = x.dtype
    x2 = x.reshape(x.shape[0], -1)
    z1 = spmm_ell(op, x2)
    z2 = (2.0 * spmm_ell(op, z1).float() - x2.float()).to(dt)
    return torch.stack([x2, z1, z2], -1).reshape(x.shape[:-1] + (3 * x.shape[-1],))


def dense_cheby_bwd_plain(op: LevelOperator, g: torch.Tensor) -> torch.Tensor:
    """The kernel's backward in plain PyTorch: the cotangent of the stack
    (V, ..., 3 Fin) -> that of x (V, ..., Fin)."""
    dt = g.dtype
    g3 = g.reshape(g.shape[0], -1, 3)
    g0, g1, g2 = (g3[..., k].float() for k in range(3))
    u = (g1 + 2.0 * spmm_ell(op, g3[..., 2]).float()).to(dt)
    dx = ((g0 - g2).to(dt).float() + spmm_ell(op, u).float()).to(dt)
    return dx.reshape(g.shape[:-1] + (g.shape[-1] // 3,))


@functools.cache
def _lib():
    lib = load_library("dense_cheby")
    lib.p2m_dense_cheby.argtypes = [_C_PTR] * 5 + [_C_INT] * 7 + [_C_PTR]
    lib.p2m_dense_cheby.restype = _C_INT
    lib.p2m_dense_cheby_error_string.argtypes = [_C_INT]
    lib.p2m_dense_cheby_error_string.restype = ctypes.c_char_p
    return lib


def _launch(ptr, col, val, inp: torch.Tensor, bwd: bool) -> torch.Tensor:
    """One launch: the stack of x (V, ..., Fin), or dx of g (V, ..., 3 Fin)."""
    V, es = inp.shape[0], inp.element_size()
    C = inp[0].numel() // (3 if bwd else 1)
    out = inp.new_empty(inp.shape[:-1] + ((inp.shape[-1] // 3) if bwd else 3 * inp.shape[-1],))
    plan = dense_plan(V, col.numel(), C, es, sm_count(inp.device))
    lib = _lib()
    with torch.cuda.device(inp.device):
        err = lib.p2m_dense_cheby(_ptr(ptr), _ptr(col), _ptr(val), _ptr(inp), _ptr(out), V, C,
                                  col.numel(), plan.lw, plan.threads, int(bwd), int(es == 4),
                                  _stream(inp))
    _raise_on(err, lib, "p2m_dense_cheby_error_string")
    launches["dense_cheby_stack_bwd" if bwd else "dense_cheby_stack"] += 1
    return out


class _DenseCheby(torch.autograd.Function):
    """The stack with the backward g -> dx of the same kernel (L symmetric)."""

    @staticmethod
    def forward(ctx, x, ptr, col, val):
        ctx.save_for_backward(ptr, col, val)
        ctx.attrs = dict(dtype=dtype_name(x.dtype), vertices=x.shape[0])
        return _launch(ptr, col, val, x, bwd=False)

    @staticmethod
    def backward(ctx, g):
        with span("p2m.dense_conv.bwd", **ctx.attrs):
            ptr, col, val = ctx.saved_tensors
            return _launch(ptr, col, val, g.contiguous(), bwd=True), None, None, None


def dense_cheby_stack(op: LevelOperator, x: torch.Tensor) -> torch.Tensor:
    """The fin-major basis [x, L x, 2 L (L x) - x] of a dense level `op`:
    x (V, ..., Fin) -> (V, ..., 3 Fin), differentiable in x."""
    if op.kind != "dense" or x.dim() < 2 or x.shape[0] != op.num_vertices:
        raise ValueError(f"dense_cheby_stack takes a dense level and x (V, ..., F) with V = "
                         f"its vertices, got kind {op.kind!r}, {op.num_vertices} vertices, "
                         f"x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return chebyshev_stack(op, x, 3)
    check_dtypes(x=x, csr_val=op.csr_val)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if op.csr_ptr.numel() != op.num_vertices + 1:
        raise ValueError("the dense level carries no row table (graphs.artifact.dense_rows)")
    for name, t in dict(csr_ptr=op.csr_ptr, csr_col=op.csr_col, csr_val=op.csr_val).items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return _DenseCheby.apply(x.contiguous(), op.csr_ptr, op.csr_col, op.csr_val)
