"""The trace reduction on hand-made chrome-trace events: the busy union
inside the window, kernel times by name, and idle gaps put down to the
host's spans and operators."""
import pytest
import torch

from bench_port.trace import WINDOW, kernel_seconds, profile_segment, short_name, summarize


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_busy_gaps_and_kernels():
    ev = [
        _x(WINDOW, "user_annotation", 100.0, 100.0),
        _x("bench.step", "user_annotation", 100.0, 60.0),
        _x("aten::mm", "cpu_op", 105.0, 20.0),
        _x("aten::copy_", "cpu_op", 130.0, 25.0),
        _x("bench.d2h", "user_annotation", 160.0, 40.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 165.0, 30.0),
        _x("void band_hop_kernel<128, false>(HopArgsT<bf16>)", "kernel", 90.0, 20.0, tid=7),
        _x("void band_hop_kernel<64, true>(HopArgsT<bf16>)", "kernel", 112.0, 2.0, tid=7),
        _x("void cheby_proj_kernel_x<1>(P)", "kernel", 150.0, 30.0, tid=7),
        _x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 175.0, 10.0, tid=7),
        _x("ampere_gemm", "kernel", 250.0, 10.0, tid=7),       # outside the window
        _x("gpu annotation", "gpu_user_annotation", 100.0, 100.0, tid=7),
    ]
    s = summarize(ev, steps=2)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [100, 110] + [112, 114] + [150, 185] = 10 + 2 + 35
    assert s.busy_s == pytest.approx(47e-6)
    assert kernel_seconds(s, ["band_hop_kernel"]) == pytest.approx(12e-6)
    assert kernel_seconds(s, ["cheby_proj_kernel"]) == 0.0  # whole identifiers only
    assert s.device_ops["band_hop_kernel<128, false>"] == pytest.approx(10e-6)
    assert short_name("void at::native::(anonymous namespace)::k<1>(int)") == "at::native::k<1>"
    # gaps: [110, 112] short; [114, 150] mid 132 in bench.step at aten::copy_;
    # [185, 200] mid 192.5 in bench.d2h, no operator
    assert s.gaps["short gaps"] == pytest.approx(2e-6)
    assert s.gaps["bench.step: aten::copy_"] == pytest.approx(36e-6)
    assert s.gaps["bench.d2h"] == pytest.approx(15e-6)
    assert s.top(s.gaps, 1) == [["bench.step: aten::copy_", pytest.approx(36e-6)]]


def test_profile_segment_on_the_host():
    x = torch.randn(64, 64)
    s = profile_segment(lambda: [x @ x for _ in range(3)], 3, torch.device("cpu"), host=True)
    assert s.steps == 3 and s.window_s > 0 and s.busy_s == 0.0


def test_device_segment_window_is_the_host_clocks():
    ev = [_x("k", "kernel", 1000.0, 30.0, tid=7), _x("m", "gpu_memcpy", 1040.0, 10.0, tid=7)]
    s = summarize(ev, steps=1, window_s=100e-6)
    assert s.window_s == pytest.approx(100e-6) and s.busy_s == pytest.approx(40e-6)
    assert s.gaps == {"outside bench spans": pytest.approx(60e-6)}
    x = torch.randn(8, 8)
    c = profile_segment(lambda: x @ x, 1, torch.device("cpu"), host=False)
    assert c.window_s > 0 and c.busy_s == 0.0 and c.gaps == {}
