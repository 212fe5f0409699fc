"""Plain mirrors of csrc/gemm_f32.cuh, the float32 GEMMs on wgmma (3xTF32).

The CUDA k-loop cannot run on the CPU; its arithmetic and its shared-memory
layout can, in numpy:

  tf32_rna, tf32_split   each float32 x as big = rna(x) and small =
                         rna(x - big), TF32 values (the low 13 mantissa bits
                         zero): cvt.rna.tf32.f32, once per element and block;
  tf32x3_matmul          a @ b in the kernels' order of sums: per 32-deep
                         k-tile a float32 partial of the three products of
                         each k8 step (small x big, big x small, big x big,
                         each a float32 update by the step's 8 products),
                         then one IEEE float32 add into the running sum;
  plane_offset           the byte of row r's 16-byte chunk c in a TF32 plane
                         (the 128-byte swizzle of the wgmma descriptors);
  gemm_f32_smem, proj_f32_stages, dx_f32_stages, DW_F32_STAGES
                         a GEMM block's shared memory and its raw ring's
                         depth (csrc);
  ring_schedule          the producers' cp.async groups over a block's
                         k-tiles (f32_produce): what each wait leaves
                         pending, and which stage each copy lands in.

tests/test_torch_f32_gemm.py holds the error budget of the sum order against
float64 products and the layout's bank behaviour; the kernels themselves are
held against the plain versions on the card.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DW_F32_STAGES", "F32_ALIGN", "F32_BK", "dx_f32_stages", "gemm_f32_smem",
           "plane_offset", "proj_f32_stages", "ring_schedule", "tf32_rna", "tf32_split",
           "tf32x3_matmul"]

# the k-tile depth (one 128-byte swizzle row of TF32), the planes'
# alignment and dW's raw ring depth (kF32BK, kF32Align, kDwF32Stages)
F32_BK, F32_ALIGN, DW_F32_STAGES = 32, 1024, 3


def proj_f32_stages(bn: int, stats: bool) -> int:
    """The float32 projection's raw ring depth (proj_f32_stages): 3, and 2
    where 128-column planes and the statistics' slots would pass 227 KB."""
    return 2 if bn == 128 and stats else 3


def dx_f32_stages(dn: int) -> int:
    """dx's float32 raw ring depth (dx_f32_stages): 2 at 128 columns, else 3."""
    return 2 if dn == 128 else 3


def gemm_f32_smem(ra: int, rb: int, stages: int) -> int:
    """Shared memory of a float32 GEMM block of an `ra`-row A and `rb`-row B
    tile: the alignment slack, two buffers of four TF32 planes of one k-tile
    (A and B, big and small, 128 bytes a row) and the ring of `stages` raw
    float32 k-tiles."""
    return F32_ALIGN + (4 + stages) * (ra + rb) * F32_BK * 4


def tf32_rna(x) -> np.ndarray:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as float32 with the low 13 bits zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x):
    """(big, small): x = big + small to about 2^-22 of x, both TF32."""
    x = np.asarray(x, np.float32)
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def tf32x3_matmul(a, b, bk: int = F32_BK, terms: int = 3) -> np.ndarray:
    """a (M, K) @ b (K, N), float32, in the kernels' order: K zero-filled to
    a multiple of 8; per bk-deep k-tile a float32 partial, updated by each
    k8 step's small x big, big x small and big x big products (each step's 8
    products summed exactly, then rounded into the partial); then acc +=
    partial in float32.  terms=1 keeps big x big alone (one TF32 product)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    K = a.shape[1]
    pad = -K % 8
    a, b = np.pad(a, ((0, 0), (0, pad))), np.pad(b, ((0, pad), (0, 0)))
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    pairs = ((as_, bb), (ab, bs), (ab, bb))[3 - terms:]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, K + pad, bk):
        part = np.zeros_like(acc)
        for k8 in range(k0, min(k0 + bk, K + pad), 8):
            for x, y in pairs:
                step = x[:, k8:k8 + 8].astype(np.float64) @ y[k8:k8 + 8].astype(np.float64)
                part = (part.astype(np.float64) + step).astype(np.float32)
        acc = acc + part
    return acc


def plane_offset(r, c):
    """Byte offset of row r's chunk c (k = 4c .. 4c + 3) in a TF32 plane:
    rows 128 bytes apart, the chunk XOR-swizzled by r % 8 (1024-byte atoms
    of 8 rows, csrc put_split)."""
    r, c = np.asarray(r), np.asarray(c)
    return r * 128 + ((c ^ (r & 7)) << 4)


def ring_schedule(count: int, stages: int) -> list:
    """The producers' raw ring over `count` k-tiles of `stages` stages, as
    f32_produce runs it: the prologue commits one cp.async group a stage
    (k-tiles 0 .. stages - 1, empty past count); iteration q >= 1 commits
    one group, the refill of the stage k-tile q - 1 was split from with
    k-tile q - 1 + stages (empty past count).  Per iteration q: (the groups committed before
    its wait, the groups the wait may leave pending (stages - 1 at q = 0,
    else stages - 2), the group holding k-tile q, the stage it sits in)."""
    groups, stage_of, out = [], {}, []
    for st in range(stages):
        groups.append(st if st < count else None)
        if st < count:
            stage_of[st] = st
    for q in range(count):
        pending = stages - 1 if q == 0 else stages - 2
        out.append((len(groups), pending, groups.index(q), stage_of[q]))
        if q > 0:
            refill = q - 1 + stages < count
            if refill:
                stage_of[q - 1 + stages] = (q - 1) % stages
            groups.append(q - 1 + stages if refill else None)
    return out

