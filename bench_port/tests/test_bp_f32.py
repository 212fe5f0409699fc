"""The float32 configuration's parts of the benchmark: the `band_roofline_f32`
readers, the float32 bound they read, the TF32 control and the bf16 fault
of `control_tf32.py`, and, on the card, the float32 train cell's window
replaying its CUDA graph.  The tests marked cuda skip without a card; run
them there with `python3 -m pytest --noconftest -m cuda bench_port/tests/test_bp_f32.py`."""
import time

import pytest
import torch

from bench_port import harness
from bench_port.control_tf32 import Tf32Serve, bf16_serve, bf16_train, tf32
from bench_port.counts_f32 import cell_bounds
from bench_port.generator import WindowRecord
from bench_port.harness import BENCH, Run, load_cell, load_metric
from bench_port.tests.tiny import tiny_cell
from bench_port.trace import TraceSummary

CPU = torch.device("cpu")
READERS = {"serve": "band_roofline_f32.serve", "train": "band_roofline_f32.train"}


def _run(kind, trace=None, bf16_bound_s=1e-3):
    w = WindowRecord(requests=10, items=640, t_start=0.0, t_end=0.5,
                     latencies=[0.05] * 10, dispatch=[0.01] * 10)
    return Run(kind=kind, window=w, setup_s=3.0, flops_per_step=1e12,
               band_bound_s_per_step=bf16_bound_s, trace=trace)


def _trace(kernels):
    return TraceSummary(window_s=1.0, busy_s=0.5, steps=4, kernels=kernels)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_readers_return_nothing_off_their_kind_or_without_a_trace(kind):
    other = "train" if kind == "serve" else "serve"
    read = load_metric(READERS[kind]).read
    f32 = _trace({"void band_hop_f32_kernel<false>(HopArgsT<float>, float const*)": 4e-3})
    assert read(_run(kind)) is None
    assert read(_run(other, f32)) is None
    # a bf16 cell's kernels are not the float32 convs'
    assert read(_run(kind, _trace({"void band_hop_kernel<128, false>(HopArgsT<bf16>)": 4e-3,
                                   "void cheby_proj_kernel<1>(P)": 4e-3}))) is None


def test_readers_put_the_float32_bound_over_the_float32_kernels():
    """Each reader's bound is the float32 one of its own cell (counts_f32),
    the listed cell whose bf16 bound is the run's `band_bound_s_per_step`;
    times are per traced step.  A run of no listed cell reads nothing."""
    (serve_bf16, serve_f32), = cell_bounds(READERS["serve"])
    (train_bf16, train_f32), = cell_bounds(READERS["train"])
    assert train_f32 > serve_f32 > serve_bf16 > 0 and train_f32 > train_bf16 > 0
    serve = _trace({"void band_hop_f32_lists<false>(HopArgsT<float>, int2*, int*)": 1e-3,
                    "void band_hop_f32_kernel<false>(HopArgsT<float>, float const*)": 3e-3,
                    "void cheby_proj_f32_kernel(ProjArgsT<float>)": 4e-3,
                    "void fold_kernel<float>(float const*)": 5.0})
    read = load_metric(READERS["serve"]).read
    assert read(_run("serve", serve, serve_bf16)) == pytest.approx(100 * serve_f32 / 2e-3)
    assert read(_run("serve", serve, train_bf16)) is None
    train = _trace({"void fold_kernel<float>(float const*)": 1e-3,
                    "void bwd_dx_f32_kernel(Cot<float>)": 3e-3,
                    "void bwd_dw_f32_kernel(Cot<float>)": 4e-3,
                    "void bwd_dx_kernel<bf16>(Cot<bf16>)": 5.0})
    read = load_metric(READERS["train"]).read
    assert read(_run("train", train, train_bf16)) == pytest.approx(100 * train_f32 / 2e-3)
    assert read(_run("train", train, serve_bf16)) is None


def test_tf32_context_restores_the_flags():
    m = torch.backends.cuda.matmul
    old = m.allow_tf32
    m.allow_tf32 = False
    try:
        with tf32():
            assert m.allow_tf32 and torch.backends.cudnn.allow_tf32
        assert not m.allow_tf32
    finally:
        m.allow_tf32 = old


def _tiny(kind):
    cell = tiny_cell(kind, batch=8)
    cell.cfg["compute_dtype"] = "float32"
    cell.limits = harness._json(BENCH / "limits" / f"smpl_h36m17_f32.{kind}_b64.json")
    return cell


def _correct(res):
    return all(c["ok"] for c in res["checks"].values()) and res["failed"] == 0


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_float32_limits_pass_the_port_and_catch_it_at_bf16(kind):
    """The float32 cells' limits at a tiny size on the CPU: the port at
    float32 passes them, the port at bf16 in its place does not."""
    factory = "serve_factory" if kind == "serve" else "train_factory"
    for seed in (1, 2):
        sound = harness.run_cell(_tiny(kind), seed, 0.2, False, CPU, t0=time.perf_counter(),
                                 log=lambda *a: None)
        assert _correct(sound), (seed, sound["checks"])
        bf16 = harness.run_cell(_tiny(kind), seed, 0.2, False, CPU, t0=time.perf_counter(),
                                log=lambda *a: None,
                                **{factory: bf16_serve if kind == "serve" else bf16_train})
        assert not _correct(bf16), (seed, bf16["checks"])


@pytest.mark.cuda
def test_tf32_control_differs_from_the_reference_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    dev = torch.device("cuda", 0)
    c = tiny_cell("serve", batch=64)
    c.cfg["compute_dtype"] = "float32"
    from bench_port.control import RefServe
    from bench_port.generator import serve_pool
    from bench_port.weights import make_state_dict
    sd = make_state_dict(c.cfg, c.cfg["coarse_vertices"], 7, dev)
    x = serve_pool(c.mesh, c.traffic, 7, dev)[0]
    ref = RefServe(c.cfg, c.mesh, sd, dev, precision="f32").step(x)[0]
    ctl = Tf32Serve(c.cfg, c.mesh, sd, dev).step(x)[0]
    again = RefServe(c.cfg, c.mesh, sd, dev, precision="f32").step(x)[0]
    assert torch.equal(ref, again)   # the control left TF32 off behind it
    gap = float((ctl - ref).norm() / ref.norm())
    assert gap > 1e-5, gap


@pytest.mark.cuda
def test_float32_train_cell_window_replays_its_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    from pose2mesh_release_tpu_torch.core.train import graph_counters
    dev = torch.device("cuda", 0)
    before = dict(graph_counters)
    res = harness.run_cell(load_cell("smpl_h36m17_f32.train_b64"), 3, 2.0, False, dev,
                           t0=time.perf_counter(), log=lambda *a: None)
    ran = {k: graph_counters[k] - before.get(k, 0) for k in graph_counters}
    print("graph_counters", ran, "steps in the window", res["attempted"])
    assert ran["captures"] == 1 and ran["replays"] >= res["attempted"]
    assert _correct(res), res["checks"]
