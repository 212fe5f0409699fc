"""The benchmark's float32 SMPL configuration (`bench_port/configs/
smpl_h36m17_f32.json`) on the CPU: it is the bf16 configuration at float32;
the port at float32, built as the benchmark builds it (`bench_port/system.py`),
agrees with the plain float32 reference (`bench_port/reference/`) at a tiny
size on seeded random weights, and the port at bf16 does not; the float32
band bound (`bench_port/counts_f32.py`) at SMPL shapes is chip_smoke's.

Readings when written (seeds 1-8, the tiny cell at batch 8; the port runs
its kernels' plain versions here): the eval step's outputs within 1.8e-7 at
float32, 3.5e-3 or more apart at bf16; each of three train steps, the
reference stepping from the port's parameters, within 3e-7 on the loss,
2.2e-5 on the median leaf's gradient norm and 2.9e-5 on the whole
gradient's norm at float32, 3.5e-6, 3.6e-3 and 9.2e-4 or more at bf16.
"""
import json
import statistics

import numpy as np
import pytest
import torch

from bench_port import counts
from bench_port.control import RefServe, RefTrain
from bench_port.control_tf32 import bf16_serve, bf16_train
from bench_port.counts_f32 import band_bound_s, conv_costs
from bench_port.generator import serve_pool, train_pool
from bench_port.harness import BENCH, ROOT, load_cell, moving_leaves
from bench_port.peaks import PEAK_BF16_FLOPS, PEAK_BYTES
from bench_port.reference.pyramid import build_ref_pyramid
from bench_port.system import ServeSystem, TrainSystem
from bench_port.tests.tiny import tiny_cell
from bench_port.weights import make_state_dict

CPU = torch.device("cpu")
# float32 against float32 in another order (the port's packed RCM pyramid
# and fused kernels, the reference's CSR hops and unfused products): relative
# L2 of each eval output; read 1.8e-7, a bf16 rounding is 4e-3
SERVE_TOL = 1e-5
# one train step from the same parameters: the total loss read 3e-7; the
# median moving leaf's gradient norm 2.2e-5 and the whole gradient's 2.9e-5
# (BatchNorm's statistics over 8 rows amplify the order of the sums)
LOSS_TOL = 1e-5
GRAD_MEDIAN_TOL = 2e-4
GRAD_TOTAL_TOL = 2e-4
TRAIN_STEPS = 3


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_configuration_is_the_bf16_one_at_float32():
    f32, bf16 = _cfg("smpl_h36m17_f32"), _cfg("smpl_h36m17")
    differ = {k for k in set(f32) | set(bf16) if f32.get(k) != bf16.get(k)}
    assert differ == {"name", "source", "why", "assumed", "compute_dtype", "reduced"}
    assert f32["compute_dtype"] == "float32" and f32["reduced"] == []
    assert f32["mesh"] == bf16["mesh"] == "smpl_h36m17.mesh.npz"
    assert not any("bf16" in a for a in f32["assumed"])
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == "smpl_h36m17_f32")
    assert entry["file"] == "bench_port/configs/smpl_h36m17_f32.json"
    assert entry["source"] == f32["source"] and entry["reduced"] == []
    for mix in ("serve_b64", "train_b64"):
        cell = load_cell(f"smpl_h36m17_f32.{mix}", manifest)
        assert cell.cfg == f32 and cell.traffic["batch"] == 64
        assert set(cell.limits) == set(load_cell(f"smpl_h36m17.{mix}", manifest).limits)


def _serve_gaps(seed, factory):
    c = tiny_cell("serve", batch=8)
    c.cfg["compute_dtype"] = "float32"
    sd = make_state_dict(c.cfg, c.cfg["coarse_vertices"], seed, CPU)
    ref = RefServe(c.cfg, c.mesh, sd, CPU, precision="f32")
    x = serve_pool(c.mesh, c.traffic, seed, CPU)[0]
    return [float((a.float() - b).norm() / b.norm())
            for a, b in zip(factory(c.cfg, c.mesh, sd, CPU).step(x), ref.step(x))
            if b.norm() > 0]


def _train_gaps(seed, factory):
    """Each step's (loss gap, median leaf's gradient gap, whole gradient's
    gap), the reference stepping from the port's parameters: RMSprop's first
    update, about 10 lr sign(g) an element, moves the elements whose gradient
    is round-off either way, so two runs drift apart after it whatever
    their precision."""
    c = tiny_cell("train", batch=8)
    c.cfg["compute_dtype"] = "float32"
    sd = make_state_dict(c.cfg, c.cfg["coarse_vertices"], seed, CPU)
    pool = train_pool(c.mesh, c.traffic, seed, CPU)
    prog = factory(c.cfg, c.mesh, sd, CPU, 5)
    ref = RefTrain(c.cfg, c.mesh, sd, CPU, 5, precision="f32")
    out = []
    for s in range(TRAIN_STEPS):
        with torch.no_grad():
            for k, p in prog.named_parameters().items():
                ref.ref.p[k].copy_(p.float())
        r_loss = float(ref.step(pool[s])["total"])
        p_loss = float(prog.step(pool[s])["total"])
        rg = {k: float(g.norm()) for k, g in ref.ref.grads.items()}
        pg = {k: float(p.grad.float().norm()) for k, p in prog.named_parameters().items()}
        moving = moving_leaves(rg)
        med = statistics.median(rg[k] for k in moving)
        total = lambda g: float(np.sqrt(sum(g[k] ** 2 for k in moving)))  # noqa: E731
        out.append((abs(p_loss - r_loss) / abs(r_loss),
                    statistics.median(abs(pg[k] - rg[k]) / max(rg[k], med) for k in moving),
                    abs(total(pg) - total(rg)) / total(rg)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_float32_port_serves_as_the_reference_and_bf16_does_not(seed):
    assert max(_serve_gaps(seed, ServeSystem)) < SERVE_TOL
    assert max(_serve_gaps(seed, bf16_serve)) > SERVE_TOL


@pytest.mark.parametrize("seed", [1, 2])
def test_float32_port_trains_as_the_reference_and_bf16_does_not(seed):
    tols = (LOSS_TOL, GRAD_MEDIAN_TOL, GRAD_TOTAL_TOL)
    for step in _train_gaps(seed, TrainSystem):
        assert all(g < t for g, t in zip(step, tols)), step
    for step in _train_gaps(seed, bf16_train):
        assert any(g > t for g, t in zip(step, tols)), step


def test_float32_band_bound_is_chip_smokes():
    """PERF.md's float32 kernel rows at SMPL shapes: 1.559 ms a forward
    (group 1.279 + commuted 0.280), 4.497 ms a step (K1 1.519 + K2 2.978);
    at 2-byte operands and the bf16 peak its counts give `counts.band_bound_s`."""
    cfg = _cfg("smpl_h36m17_f32")
    with np.load(BENCH / "configs" / cfg["mesh"]) as z:
        faces = z["faces"]
    js = cfg["joint_set"]
    pyr = build_ref_pyramid(faces, js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    convs = counts.conv_table(cfg, pyr.sizes, pyr.nnz, int(pyr.joint_laplacian.nnz))
    assert band_bound_s(convs, 64, train=False) * 1e3 == pytest.approx(1.559, rel=1e-2)
    assert band_bound_s(convs, 64, train=True) * 1e3 == pytest.approx(4.497, rel=1e-2)
    for train in (False, True):
        bf16 = sum(max(b / PEAK_BYTES, f / PEAK_BF16_FLOPS) for c in convs if c.band
                   for f, b in conv_costs(c, 64, train, 2))
        assert bf16 == pytest.approx(counts.band_bound_s(convs, 64, train), rel=1e-12)
