"""PyTorch port: the program's spans (`utils/profiling.py`) on the CPU.

Spans off record nothing and leave a step's outputs as they were; spans on
give the expected tree for an eval step on every deploy path, a train step
and the PoseNet steps of a small cascade (a band and a dense mesh level);
step ids stay whole across threads; a span lands on a CPU profiler trace's
clock; `span_breakdown` on hand-made Chrome events puts kernels down to
spans by their launch's correlation (a thread known by its trace id or its
thread named as the spans name it, or otherwise) and idle gaps by the
innermost span open.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
from pose2mesh_release_tpu_torch.core.train import (
    TrainState, make_eval_step, make_posenet_steps, make_train_step,
)
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.meshnet import flat_route
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.models.posenet import PoseNet
from pose2mesh_release_tpu_torch.train_setup import synthetic_batch
from pose2mesh_release_tpu_torch.utils import profiling
from pose2mesh_release_tpu_torch.utils.profiling import (
    OUTSIDE, STEP, UNATTRIBUTED, record_spans, span, span_breakdown, spans_enabled,
)

J = 7
SKEL = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]
V = 770
# joint graph, the dense level (444), the band level (770) twice: block 2's
# 16 -> 8 conv carries the skip, block 3's 8 -> 4 narrows without one (the
# commuted conv on the group path), its 4 -> 3 is the network's last
BLOCKS = ((5, 8, 8), (8, 8, 8), (8, 16, 8), (8, 4, 3))
BAND_CONVS = 4


@pytest.fixture(scope="module")
def tiny():
    template, faces = uv_sphere(V)
    pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=3)
    art = pack_pyramid(pyr, faces, dense_threshold=500, device="cpu")
    assert [op.kind for op in art.mesh_ops] == ["band", "dense"]
    rng = np.random.default_rng(0)
    jreg = rng.random((J, V)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(template.astype(np.float32), 2, jreg, rng).items()}
    return art, jreg, batch


def _model(art, **kw):
    return Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=16, blocks=BLOCKS,
                     device="cpu", **kw)


def _train(tiny, steps: int):
    art, jreg, batch = tiny
    model = _model(art, inference_fused=False)
    opt = make_preconditioner("rmsprop", model.parameters())
    step = make_train_step(model, opt, jreg, device="cpu")
    state, gen = TrainState(model, opt), torch.Generator().manual_seed(0)
    losses = []
    for _ in range(steps):
        state, out = step(state, art, batch, 1e-3, True, gen)
        losses.append(out)
    return losses, model.state_dict()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_off_record_nothing_and_leave_outputs_as_they_were(tiny):
    """Off: the shared no-op context; a train and an eval step give the same
    bits with spans on and off; nothing reaches a log once its block ends."""
    assert not spans_enabled()
    assert span(STEP, kind="train") is span("p2m.band_conv", route="group")
    off_losses, off_state = _train(tiny, 2)
    with record_spans() as log:
        assert spans_enabled()
        on_losses, on_state = _train(tiny, 2)
    assert not spans_enabled()
    for a, b in zip(off_losses, on_losses):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert off_state.keys() == on_state.keys()
    assert all(torch.equal(off_state[k], on_state[k]) for k in off_state)

    art, jreg, batch = tiny
    eval_step = make_eval_step(_model(art), jreg, device="cpu")
    off = eval_step(art, batch["pose2d"])
    with record_spans() as log2:
        on = eval_step(art, batch["pose2d"])
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    n = len(log.spans)
    _train(tiny, 1)
    assert len(log.spans) == n and len(log2.spans) > 0
    with record_spans():
        with pytest.raises(RuntimeError):
            with record_spans():
                pass


def _check_tree(spans, n_steps: int, kind: str):
    """The cascade's spans of n_steps steps: names and counts a step, each
    span's parent, the blocks' attributes, the step ids."""
    steps = _named(spans, STEP)
    assert len(steps) == n_steps and [s.step for s in steps] == list(range(1, n_steps + 1))
    # a train step that runs its Python says how: eagerly here (spans on)
    attrs = {"kind": kind, "graph": "eager"} if kind == "train" else {"kind": kind}
    assert all(s.attrs == attrs and s.parent == -1 for s in steps)
    step_of = {i: s.step for i, s in enumerate(spans) if s.name == STEP}
    for name in ("p2m.posenet", "p2m.meshnet", "p2m.extract_mesh", "p2m.regressor"):
        got = _named(spans, name)
        assert len(got) == n_steps, name
        assert all(step_of[s.parent] == s.step for s in got), name
    blocks = _named(spans, "p2m.meshnet.block")
    assert len(blocks) == len(BLOCKS) * n_steps
    assert all(spans[b.parent].name == "p2m.meshnet" for b in blocks)
    assert [b.attrs for b in blocks[:len(BLOCKS)]] == [
        {"i": 0, "kind": "dense", "vertices": J}, {"i": 1, "kind": "dense", "vertices": 444},
        {"i": 2, "kind": "band", "vertices": V}, {"i": 3, "kind": "band", "vertices": V}]
    convs = _named(spans, "p2m.band_conv")
    assert len(convs) == BAND_CONVS * n_steps
    assert all(spans[c.parent].name == "p2m.meshnet.block"
               and spans[c.parent].attrs["kind"] == "band" for c in convs)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns and p.tid == s.tid
    return convs


@pytest.mark.parametrize("path", ["group", "strip", "window", "unfused"])
def test_eval_step_span_tree(tiny, path):
    """One deploy eval step on each path: one `p2m.band_conv` a band conv,
    with the route its kernel family takes."""
    art, jreg, batch = tiny
    kw = {"fused": False} if path == "unfused" else {"flat_impl": path}
    eval_step = make_eval_step(_model(art, **kw), jreg, device="cpu")
    with record_spans() as log:
        eval_step(art, batch["pose2d"])
    spans = log.spans
    convs = _check_tree(spans, 1, "eval")
    route = "unfused" if path == "unfused" else flat_route(art.mesh_ops[0], path)
    want = [route] * BAND_CONVS
    if route == "group":
        want[2] = "commuted"
    assert [c.attrs["route"] for c in convs] == want
    assert {c.attrs["dtype"] for c in convs} == {"float32"}
    assert not _named(spans, "p2m.losses") and not _named(spans, "p2m.band_conv.bwd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_band_conv_spans_carry_the_compute_dtype(tiny, dtype):
    """`p2m.band_conv` and `p2m.band_conv.bwd` name the compute dtype, so a
    trace tells the float32 kernel instances from the bf16 ones."""
    art, jreg, batch = tiny
    art = art.to("cpu", dtype)
    eval_step = make_eval_step(_model(art, dtype=dtype), jreg, device="cpu")
    model = _model(art, dtype=dtype, inference_fused=False)
    opt = make_preconditioner("rmsprop", model.parameters())
    step = make_train_step(model, opt, jreg, device="cpu")
    with record_spans() as log:
        eval_step(art, batch["pose2d"])
        step(TrainState(model, opt), art, batch, 1e-3, True, torch.Generator().manual_seed(0))
    name = str(dtype).removeprefix("torch.")
    convs, bwd = _named(log.spans, "p2m.band_conv"), _named(log.spans, "p2m.band_conv.bwd")
    assert len(convs) == 2 * BAND_CONVS and len(bwd) == BAND_CONVS
    assert all(s.attrs["dtype"] == name for s in convs + bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hop_backward_span_carries_the_compute_dtype(tiny, dtype):
    """The unfused conv's two differentiable hops (`ops.hop`): each backward
    is a `p2m.band_conv.bwd` that names the dtype its forward ran in."""
    from pose2mesh_release_tpu_torch.ops.fused_cheby_train import cheby_project_unfused
    art = tiny[0].to("cpu", dtype)
    op = art.mesh_ops[0]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(op.num_vertices, 2, 4, generator=g).to(dtype).requires_grad_()
    W, b = torch.randn(12, 3, generator=g).to(dtype), torch.zeros(3, dtype=dtype)
    y = cheby_project_unfused(op.band_val.to(dtype), x, W, b)
    with record_spans() as log:
        y.float().sum().backward()
    bwd = _named(log.spans, "p2m.band_conv.bwd")
    assert len(bwd) == 2 and x.grad is not None
    assert all(s.attrs["dtype"] == str(dtype).removeprefix("torch.") for s in bwd)


def test_train_step_span_tree(tiny):
    """Two train steps: the tree of each, a `p2m.band_conv.bwd` a band conv
    under its step's `p2m.backward` (by parent on the caller's thread, by
    time and step id on autograd's)."""
    with record_spans() as log:
        _train(tiny, 2)
    spans = log.spans
    convs = _check_tree(spans, 2, "train")
    assert {c.attrs["route"] for c in convs} == {"train"}
    step_of = {i: s.step for i, s in enumerate(spans) if s.name == STEP}
    for name in ("p2m.losses", "p2m.backward", "p2m.optimizer"):
        got = _named(spans, name)
        assert [s.step for s in got] == [1, 2]
        assert all(step_of[s.parent] == s.step for s in got), name
    assert not _named(spans, "p2m.grad_sync")
    backward = {s.step: s for s in _named(spans, "p2m.backward")}
    bwd = _named(spans, "p2m.band_conv.bwd")
    assert [s.step for s in bwd] == [1] * BAND_CONVS + [2] * BAND_CONVS
    for s in bwd:
        b = backward[s.step]
        assert b.start_ns <= s.start_ns and s.end_ns <= b.end_ns
        if s.tid == threading.get_native_id():   # the CPU runs backward on the caller's thread
            assert spans[s.parent] == b
        else:
            assert s.parent == -1


def test_posenet_step_span_tree():
    """make_posenet_steps: the train step's posenet, losses, backward and
    optimizer spans, the eval step's posenet span."""
    model = PoseNet(J, hidden=16)
    opt = make_preconditioner("rmsprop", model.parameters())
    train_step, eval_step = make_posenet_steps(model, opt)
    g = torch.Generator().manual_seed(0)
    batch = {"pose2d": torch.randn(4, J * 2, generator=g),
             "pose3d": torch.randn(4, J, 3, generator=g),
             "pose3d_valid": torch.ones(4, J, 3)}
    state = TrainState(model, opt)
    with record_spans() as log:
        state, _ = train_step(state, batch, 1e-3, g)
        eval_step(state, batch["pose2d"])
    got = [(s.name, s.attrs, s.step, s.parent) for s in log.spans]
    assert got == [(STEP, {"kind": "train"}, 1, -1), ("p2m.posenet", {}, 1, 0),
                   ("p2m.losses", {}, 1, 0), ("p2m.backward", {}, 1, 0),
                   ("p2m.optimizer", {}, 1, 0), (STEP, {"kind": "eval"}, 2, -1),
                   ("p2m.posenet", {}, 2, 5)]


def test_step_ids_stay_whole_across_threads():
    """Threads entering steps and spans at once, switching often: every span
    kept, each step id given once, each span's parent on its own thread."""
    workers, reps = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with record_spans() as log:
            def work():
                for _ in range(reps):
                    with span(STEP, kind="train"):
                        with span("p2m.losses"):
                            pass
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = log.spans
    assert len(spans) == 2 * workers * reps
    assert sorted(s.step for s in _named(spans, STEP)) == list(range(1, workers * reps + 1))
    for s in _named(spans, "p2m.losses"):
        assert spans[s.parent].name == STEP and spans[s.parent].tid == s.tid
    assert len({s.tid for s in spans}) == workers


def test_span_lands_on_the_profiler_clock(tmp_path):
    """A span around a record_function block, inside trace(): the Chrome
    trace holds it as a p2m_span event within 1 ms of that block."""
    with profiling.trace(str(tmp_path)) as prof:
        with record_function("warm_up"):   # the profiler's first event costs most
            torch.ones(8) + 1
        with span("p2m.clock", i=3):
            with record_function("clock_block"):
                for _ in range(20):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(prof.trace_path))["traceEvents"]
    (s,) = [e for e in events if e.get("cat") == "p2m_span"]
    (blk,) = [e for e in events if e.get("name") == "clock_block" and e.get("ph") == "X"]
    assert s["name"] == "p2m.clock" and s["ph"] == "X"
    assert s["args"] == {"i": 3, "step": 0}
    assert s["tid"] == blk["tid"] == threading.get_native_id()
    assert abs(s["ts"] - blk["ts"]) < 1000.0
    assert abs(s["ts"] + s["dur"] - (blk["ts"] + blk["dur"])) < 1000.0
    assert s["ts"] <= blk["ts"] + 1000.0 and blk["dur"] <= s["dur"] + 1000.0


# ---- span_breakdown on hand-made Chrome events ------------------------------

# the threads' ids as the spans and a trace with host activity give them, and
# as a trace of the card's activity alone gives a launching thread (CUPTI's ids)
MAIN, AUTOGRAD = 11, 12
CUPTI = {MAIN: 336219392, AUTOGRAD: 1716410688}


def _span(name, tid, ts, dur):
    return {"ph": "X", "cat": "p2m_span", "name": name, "tid": tid, "ts": ts, "dur": dur}


def _launch(corr, tid, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
            "ts": ts, "dur": 0.5, "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel", name=None):
    args = {} if corr is None else {"correlation": corr}
    return {"ph": "X", "cat": cat, "name": name or f"k{corr}", "tid": 7, "ts": ts,
            "dur": dur, "args": args}


def _events(shift=0.0):
    """One step (µs from `shift`): the forward's meshnet with a band conv,
    backward with a K2 span on autograd's thread; launches inside the conv,
    in meshnet's own time, in the K2 span (named as the spans name the
    thread, and by CUPTI's id), on autograd's thread outside any span of its
    own, in the step's own time (by CUPTI's id of the main thread), after
    the step, and an operation with no launch event."""
    s = shift
    return [
        _span(STEP, MAIN, s + 0, 100), _span("p2m.meshnet", MAIN, s + 10, 30),
        _span("p2m.band_conv", MAIN, s + 20, 10), _span("p2m.backward", MAIN, s + 50, 40),
        _span("p2m.band_conv.bwd", AUTOGRAD, s + 60, 10),
        _launch(s + 1, MAIN, s + 25), _launch(s + 2, MAIN, s + 35),
        _launch(s + 8, CUPTI[AUTOGRAD], s + 62), _launch(s + 3, CUPTI[AUTOGRAD], s + 65),
        _launch(s + 9, AUTOGRAD, s + 68),
        _launch(s + 4, CUPTI[AUTOGRAD], s + 75), _launch(s + 5, CUPTI[MAIN], s + 95),
        _launch(s + 6, MAIN, s + 120),
        _op(s + 1, s + 26, 4), _op(s + 2, s + 36, 10), _op(s + 8, s + 63, 1),
        _op(s + 3, s + 66, 6), _op(s + 9, s + 72, 0), _op(s + 4, s + 80, 5),
        _op(s + 5, s + 96, 3),
        _op(s + 6, s + 121, 1, "gpu_memcpy", "Memcpy HtoD"),
        _op(None, s + 123, 1, "gpu_memset", "Memset"),
    ]


def test_kernels_go_to_the_span_that_launched_them():
    b = span_breakdown(_events())
    assert b.steps == 1
    assert b.device_us == {"p2m.band_conv": 4, "p2m.meshnet": 10, "p2m.band_conv.bwd": 7,
                           "p2m.backward": 5, STEP: 3, OUTSIDE: 1, UNATTRIBUTED: 1}
    # autograd's span and its launches fall under the main thread's backward
    assert b.device_us_inclusive == {
        STEP: 29, "p2m.meshnet": 14, "p2m.band_conv": 4, "p2m.backward": 12,
        "p2m.band_conv.bwd": 7, OUTSIDE: 1, UNATTRIBUTED: 1}
    assert b.launches_inclusive == {
        STEP: 7, "p2m.meshnet": 2, "p2m.band_conv": 1, "p2m.backward": 4,
        "p2m.band_conv.bwd": 3, OUTSIDE: 1, UNATTRIBUTED: 1}
    assert b.ops_us["Memcpy HtoD"] == 1 and b.ops_calls["Memset"] == 1
    # every operation goes to exactly one span, OUTSIDE or UNATTRIBUTED
    assert sum(b.device_us.values()) == sum(b.ops_us.values()) == b.busy_us == 31


def test_idle_gaps_go_to_the_innermost_open_span():
    """A gap goes to the main thread's innermost span at its middle, or to
    autograd's span where one is open there; OUTSIDE after the step."""
    b = span_breakdown(_events())
    assert b.window_us == 124
    assert b.idle_us == {"p2m.meshnet": 32, "p2m.backward": 25, "p2m.band_conv.bwd": 2,
                         STEP: 11, OUTSIDE: 23}
    assert b.idle_us_inclusive == {"p2m.meshnet": 32, "p2m.backward": 27,
                                   "p2m.band_conv.bwd": 2, STEP: 70, OUTSIDE: 23}
    assert sum(b.idle_us.values()) == b.window_us - b.busy_us


def test_breakdown_per_step_and_summary():
    """Two steps 1000 µs apart: the sums double, a step's numbers stay."""
    b = span_breakdown(_events() + _events(1000.0))
    assert b.steps == 2
    assert b.per_step(b.launches_inclusive, STEP) == 7
    assert b.per_step(b.device_us_inclusive, "p2m.backward") == 12
    summary = b.summary(top=3)
    assert summary["steps"] == 2 and summary["launches"] == 7
    assert summary["device_ms"][0] == ["p2m.meshnet", pytest.approx(0.010)]
    assert len(summary["device_ms"]) == 3
    assert summary["unattributed_ms"] == pytest.approx(0.001)
    assert summary["idle_ms"][0][0] == OUTSIDE   # 23 + 900 + 23 between the steps
    assert summary["busy_ms"] == pytest.approx(0.031)
    # the second step's first gap opens at the first step's last operation:
    # its middle lies outside both steps
    assert summary["step_idle_ms"] == pytest.approx((0.070 + 0.044) / 2)


def test_breakdown_without_spans():
    """A trace without spans: every launched operation is OUTSIDE, every gap
    too; an empty trace gives an empty breakdown."""
    ev = [e for e in _events() if e["cat"] != "p2m_span"]
    b = span_breakdown(ev)
    assert b.steps == 0 and b.device_us == {OUTSIDE: 30, UNATTRIBUTED: 1}
    assert set(b.idle_us) == {OUTSIDE}
    assert span_breakdown([]).busy_us == 0.0
