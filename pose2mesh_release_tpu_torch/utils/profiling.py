"""Profiling and roofline accounting on the NVIDIA H100 SXM.

`trace(log_dir)` records a `torch.profiler` trace (CPU and CUDA on the card,
the CPU alone elsewhere) and writes it to `log_dir` as a Chrome trace.  The
roofline functions count the operations and memory bytes of one pyramid
level's Laplacian hop or one Chebyshev conv as the JAX package's
`utils/profiling.py` counts them (the same `flops` and `hbm_bytes` for the
same level and arguments); `ideal_us` is the larger of the operations over
the card's peak rate and the bytes over its memory rate.

The rates, defined here once (chip_smoke.py's bounds read them too):
989 TFLOP/s dense bf16 (2-byte operands), 495 / 3 TFLOP/s for float32
(4-byte operands: the port's float32 products are 3xTF32, three dense TF32
products each) and 3.35 TB/s HBM3.

These counts are the JAX package's models of its kernels (whole band tiles,
padded rows).  chip_smoke's bound of each kernel counts the Laplacian's
nonzeros and the real rows instead; `sparse_conv_roofline` is the function
closest to it.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterator

import numpy as np

if TYPE_CHECKING:
    from ..graphs.artifact import LevelOperator, PyramidArtifact

__all__ = ["trace", "Roofline", "spmm_roofline", "pyramid_roofline",
           "fused_conv_roofline", "strip_conv_roofline", "sparse_conv_roofline",
           "PEAK_BF16_FLOPS", "PEAK_3XTF32_FLOPS", "PEAK_BYTES", "peak_rate"]

PEAK_BF16_FLOPS = 989e12       # H100 SXM, dense bf16 tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3  # H100 SXM, dense TF32 over 3xTF32's three products
PEAK_BYTES = 3.35e12           # H100 SXM HBM3, bytes/s


def peak_rate(dtype_bytes: int) -> float:
    """The card's operation rate for 2-byte (bf16) or 4-byte (float32) operands."""
    if dtype_bytes == 2:
        return PEAK_BF16_FLOPS
    if dtype_bytes == 4:
        return PEAK_3XTF32_FLOPS
    raise ValueError(f"dtype_bytes 2 (bf16) or 4 (float32), got {dtype_bytes}")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["object"]:
    """A torch.profiler trace of the block: CPU and CUDA activity where the
    card is there, the CPU's alone elsewhere.  Yields the profiler; on exit
    the Chrome trace is written to `log_dir` (its path set as the profiler's
    `trace_path`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


@dataclass
class Roofline:
    flops: float           # per call
    hbm_bytes: float       # per call
    intensity: float       # flops / byte
    bound: str             # "compute" | "memory"
    ideal_us: float        # the card's least time

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "intensity": self.intensity, "ideal_us": self.ideal_us}


def _roofline(flops: float, bytes_: float, dtype_bytes: int,
              peak: float | None = None) -> Roofline:
    t_compute = flops / (peak if peak is not None else peak_rate(dtype_bytes))
    t_memory = bytes_ / PEAK_BYTES
    return Roofline(flops=flops, hbm_bytes=float(bytes_),
                    intensity=float(flops / bytes_),
                    bound="compute" if t_compute > t_memory else "memory",
                    ideal_us=max(t_compute, t_memory) * 1e6)


def _nnz(op: "LevelOperator") -> int:
    """The Laplacian's nonzeros (the ELL view's nonzero weights)."""
    return int((np.asarray(op.ell_w.cpu()) != 0).sum())


def spmm_roofline(op: "LevelOperator", batch: int, feat: int,
                  dtype_bytes: int = 2) -> Roofline:
    """One z = L @ x hop of a packed level: dense levels as a dense product,
    band levels over every (2k+1) x nt T x T tile, BCSR over its blocks; x
    read and z written at the padded rows."""
    C = batch * feat
    if op.kind == "dense":
        V = op.num_vertices
        flops = 2.0 * V * V * C
        bytes_ = dtype_bytes * (V * V + 2 * V * C)
    elif op.kind == "band":
        nbd, nt, T, _ = (int(s) for s in op.band_val.shape)
        flops = 2.0 * nbd * nt * T * T * C
        bytes_ = dtype_bytes * (nbd * nt * T * T + (nt * T) * C * 2)
    else:  # bcsr
        nt, maxb = (int(s) for s in op.blk_col.shape)
        T = op.block_size
        flops = 2.0 * nt * maxb * T * T * C
        bytes_ = dtype_bytes * (nt * maxb * T * T + (nt * T) * C * 2)
    return _roofline(flops, bytes_, dtype_bytes)


def pyramid_roofline(art: "PyramidArtifact", batch: int,
                     feats: Dict[int, int] | int = 128) -> Dict[str, Dict]:
    """`spmm_roofline` per mesh level, bf16 (one feature width per level or
    one for all)."""
    out = {}
    for k, op in enumerate(art.mesh_ops):
        f = feats[k] if isinstance(feats, dict) else feats
        out[f"level{k}_V{op.num_vertices}"] = spmm_roofline(op, batch, f).as_dict()
    return out


def fused_conv_roofline(op: "LevelOperator", batch: int, fin_lanes: int,
                        fout_lanes: int, m: int = 4, dtype_bytes: int = 2,
                        peak_flops: float | None = None) -> Roofline:
    """One fused Chebyshev conv as the JAX package's Pallas kernel tiles it:
    programs of m row tiles, z1 on m + 2k tiles and z2 on m, the three basis
    projections; x re-read (m + 4k) / m times, the band rows (m + 2k) / m,
    one output write.  peak_flops: the operation rate (default the card's
    for dtype_bytes)."""
    if op.kind != "band":
        return spmm_roofline(op, batch, fin_lanes, dtype_bytes)
    nbd, nt, T, _ = (int(s) for s in op.band_val.shape)
    k = nbd // 2
    C = batch * fin_lanes
    Co = batch * fout_lanes
    Vp = nt * T
    hop_mm = (m + 2 * k) * nbd + m * nbd          # z1 tiles + z2 tiles
    flops = 2.0 * (hop_mm / m) * nt * T * T * C   # hop products
    flops += 2.0 * 3 * Vp * fin_lanes * Co        # basis projections
    bytes_ = dtype_bytes * (
        Vp * C * (m + 4 * k) / m                  # x window re-reads
        + nbd * nt * T * T * (m + 2 * k) / m      # band rows
        + Vp * Co                                 # output write
    )
    return _roofline(flops, bytes_, dtype_bytes, peak_flops)


def strip_conv_roofline(op: "LevelOperator", batch: int, fin_lanes: int,
                        fout_lanes: int, dtype_bytes: int = 2) -> Roofline:
    """One strip-layout Chebyshev conv: two hops over the (Vp, W) strip
    (on fout lanes in commuted order, fout < fin), three basis projections;
    x in, y out and the strip once.  A level without a strip form counts as
    `fused_conv_roofline`."""
    if op.kind != "band" or op.strip_h == 0:
        return fused_conv_roofline(op, batch, fin_lanes, fout_lanes,
                                   dtype_bytes=dtype_bytes)
    Vp, W = (int(s) for s in op.strip_val.shape)
    C = batch * fin_lanes
    Co = batch * fout_lanes
    hop_lanes = Co if fout_lanes < fin_lanes else C
    flops = 2.0 * 2 * Vp * W * hop_lanes + 2.0 * 3 * Vp * fin_lanes * Co
    bytes_ = dtype_bytes * (Vp * C + Vp * Co + Vp * W)
    return _roofline(flops, bytes_, dtype_bytes)


def sparse_conv_roofline(op: "LevelOperator", batch: int, fin_lanes: int,
                         fout_lanes: int, dtype_bytes: int = 2) -> Roofline:
    """The least work of one Chebyshev conv: the hops at 2 * nnz * C (the
    ELL view: no layout does less), the projections densely, one x read,
    one y write and the operator's nonzeros (value and index, as
    dtype_bytes each)."""
    C = batch * fin_lanes
    Co = batch * fout_lanes
    V = op.num_vertices
    nnz = _nnz(op)
    flops = 2.0 * 2 * nnz * max(C, Co) + 2.0 * 3 * V * fin_lanes * Co
    bytes_ = dtype_bytes * (V * C + V * Co + 2 * nnz)
    return _roofline(flops, bytes_, dtype_bytes)
