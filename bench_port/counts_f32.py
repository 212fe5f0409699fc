"""The float32 band convs' least time (the `band_roofline_f32.*` metrics):
chip_smoke's `bound(..., f32=True)` recipe, which is `counts.band_bound_s`'s
count of operations and bytes at 4-byte operands, the operations at the
3xTF32 rate of the port's float32 products (three dense TF32 products each,
495 / 3 TFLOP/s) and the bytes at HBM3's.

A metric's reader sees only the run, whose `band_bound_s_per_step` the
harness fills with the bf16 bound.  So `metric_bound_s` finds the shapes
from files the harness already loads by name: the metric's own entry in
`BENCHMARK.json`, the cells its `workloads` list, each cell's
configuration and traffic (`harness.load_cell`), the reference pyramid of
its mesh and `counts.conv_table`; of those cells it takes the one whose
bf16 bound is the run's.
"""
from __future__ import annotations

import functools
import json
import math
from typing import List, Optional, Sequence, Tuple

from . import counts
from .counts import Conv, conv_table
from .peaks import PEAK_BYTES

__all__ = ["PEAK_3XTF32_FLOPS", "conv_costs", "band_bound_s", "cell_bounds", "metric_bound_s"]

PEAK_3XTF32_FLOPS = 495e12 / 3   # H100 SXM dense TF32, over 3xTF32's three products


def conv_costs(c: Conv, B: int, train: bool, es: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each kernel of one band conv: its deploy conv,
    or K1 and K2; as `counts.band_bound_s` counts them, `es` bytes an
    element of the compute type."""
    V, z, fin, fout = c.V, c.nnz, c.fin, c.fout
    W, b = 3 * fin * fout, fout
    if not train:
        commuted = fout < fin and not c.skip_fin and not c.final
        fs = c.skip_fin
        skip_w = fs and fs != fout
        flops = (2 * 2 * z * B * (fout if commuted else fin) + 2 * V * B * 3 * fin * fout
                 + (2 * V * B * fs * fout if skip_w else 0))
        bytes_ = es * (V * B * fin + V * B * fs + W + b + (fs * fout if skip_w else 0)
                       + V * B * fout + z)
        return [(flops, bytes_)]
    stats = not c.final
    fold_bytes = es * 2 * fin if c.fold else 0
    k1_flops = 2 * 2 * z * B * fin + 2 * V * B * 3 * fin * fout
    k1_bytes = (es * (V * B * fin + W + b + V * B * fout + z) + fold_bytes
                + (2 * fout * 4 if stats else 0))
    k2_flops = 2 * 2 * z * B * fout + 2 * 2 * V * B * 3 * fout * fin
    k2_bytes = (es * (V * B * fout + V * B * fin + W) + es * V * B * fin + W * 4 + fout * 4
                + es * z + (fold_bytes + 2 * fin * 4 if c.fold else 0))
    return [(k1_flops, k1_bytes), (k2_flops, k2_bytes)]


def band_bound_s(convs: Sequence[Conv], B: int, train: bool) -> float:
    """The float32 band convs' least time, seconds, over one forward (deploy)
    or one training step (K1 and K2 of each)."""
    return sum(max(bytes_ / PEAK_BYTES, flops / PEAK_3XTF32_FLOPS)
               for c in convs if c.band for flops, bytes_ in conv_costs(c, B, train, 4))


@functools.cache
def cell_bounds(metric: str) -> Tuple[Tuple[float, float], ...]:
    """(bf16 bound, float32 bound) a step of each cell that the per-layer
    metric `metric` lists in BENCHMARK.json, the bf16 one as the harness
    computes `band_bound_s_per_step`."""
    from . import harness
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in manifest["per_layer"] if m["name"] == metric)
    out = []
    for name in entry["workloads"]:
        cell = harness.load_cell(name, manifest)
        pyr = harness._ref_pyramid(cell)
        convs = conv_table(cell.cfg, pyr.sizes, pyr.nnz, int(pyr.joint_laplacian.nnz))
        B, train = int(cell.traffic["batch"]), cell.traffic["kind"] == "train"
        out.append((counts.band_bound_s(convs, B, train), band_bound_s(convs, B, train)))
    return tuple(out)


def metric_bound_s(metric: str, bf16_bound_s: float) -> Optional[float]:
    """The float32 band bound a step of the run whose bf16 bound is
    `bf16_bound_s`, among the cells that `metric` lists; None if none is."""
    return next((f32 for bf16, f32 in cell_bounds(metric)
                 if math.isclose(bf16, bf16_bound_s, rel_tol=1e-9)), None)
