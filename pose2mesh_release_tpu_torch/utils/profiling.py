"""Profiling and roofline accounting on the NVIDIA H100 SXM.

Spans: `span(name, **attrs)` marks a layer of the program (the step,
PoseNet, each MeshNet block and band conv, the losses, backward, the
optimizer; README.md lists them).  Off, the default, a span is one test of
a module-level value and a shared no-op context.  Inside `record_spans()`
each span keeps (name, start, end, thread, step, parent, attrs) in memory,
on the clock of `torch.profiler`'s Chrome trace (`time.time_ns()`, which is
the trace's `baseTimeNanoseconds + ts`).  `span_breakdown` puts each
kernel, copy and set of such a trace down to the innermost span open on the
thread that launched it (the launch event shares the operation's
`correlation`) and each idle gap of the device to the innermost span open
on the main thread at its middle.

`trace(log_dir)` records a `torch.profiler` trace (CPU and CUDA on the card,
the CPU alone elsewhere; `host=False`: the card's activity alone, which
costs the host little) with the spans on, and writes it to `log_dir` as a
Chrome trace that holds the spans as `p2m_span` events.  The
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

import bisect
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, Iterator, List, NamedTuple, Optional, \
    Sequence

import numpy as np

if TYPE_CHECKING:
    from ..graphs.artifact import LevelOperator, PyramidArtifact

__all__ = ["span", "record_spans", "spans_enabled", "dtype_name", "Span", "SpanLog", "span_events",
           "span_breakdown", "SpanBreakdown", "profile_spans", "STEP", "OUTSIDE", "UNATTRIBUTED",
           "trace", "Roofline", "spmm_roofline", "pyramid_roofline",
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


# ---- spans ------------------------------------------------------------------

STEP = "p2m.step"                    # the span whose entries count the steps
SPAN_CAT = "p2m_span"                # the spans' category in a Chrome trace
OUTSIDE = "outside the program"      # device work or idle time under no span
UNATTRIBUTED = "unattributed"        # device work whose launch the trace lacks
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Span(NamedTuple):
    name: str
    start_ns: int       # time.time_ns(), the Chrome trace's clock
    end_ns: int
    tid: int            # threading.get_native_id(), the trace's id of a host thread
    step: int           # the steps entered so far (the STEP spans), this one included
    parent: int         # index of the enclosing span on the same thread, -1 at its top
    attrs: Dict


class SpanLog:
    """The spans recorded inside one `record_spans()` block, in the order
    they were entered."""

    def __init__(self):
        self.step = 0
        self._steps = itertools.count(1)   # next() is atomic: no step id is lost
        self._open = threading.local()
        self._records: List[list] = []

    @property
    def spans(self) -> List[Span]:
        """The spans closed so far, as tuples with their parents' indices."""
        index = {id(r): i for i, r in enumerate(self._records)}
        return [Span(n, a, b, t, st, -1 if p is None else index[id(p)], at)
                for n, a, b, t, st, p, at in self._records if b]


class _Open:
    """One span of a SpanLog from entry to exit."""

    __slots__ = ("log", "rec")

    def __init__(self, log: SpanLog, name: str, attrs: Dict):
        self.log, self.rec = log, [name, 0, 0, 0, 0, None, attrs]

    def __enter__(self):
        log, rec = self.log, self.rec
        local = log._open
        stack = getattr(local, "stack", None)
        if stack is None:   # the thread's first span: get_native_id is a system call
            stack = local.stack = []
            local.tid = threading.get_native_id()
        if rec[0] == STEP:
            log.step = rec[4] = next(log._steps)
        else:
            rec[4] = log.step
        rec[3] = local.tid
        rec[5] = stack[-1] if stack else None
        stack.append(rec)
        log._records.append(rec)   # list.append: the only state the threads share
        rec[1] = time.time_ns()

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        self.log._open.stack.pop()
        return False


_NO_SPAN = contextlib.nullcontext()
_log: Optional[SpanLog] = None


def span(name: str, **attrs):
    """A context marking one layer of the program.  Recording off: the shared
    no-op context.  Pass as attrs only constants or ints already at hand."""
    if _log is None:
        return _NO_SPAN
    return _Open(_log, name, attrs)


def dtype_name(dtype) -> str:
    """A torch dtype as a span attribute: "float32", "bfloat16"."""
    return str(dtype).removeprefix("torch.")


def spans_enabled() -> bool:
    return _log is not None


@contextlib.contextmanager
def record_spans() -> Iterator[SpanLog]:
    """Record the program's spans (from every thread) for the block; yields
    the SpanLog, whose `spans` hold them.  Not nested."""
    global _log
    if _log is not None:
        raise RuntimeError("spans are already being recorded")
    _log = log = SpanLog()
    try:
        yield log
    finally:
        _log = None


def span_events(spans: Sequence[Span], base_ns: int, pid: int) -> List[Dict]:
    """The spans as Chrome trace events (`ph` "X", `cat` p2m_span) on a
    trace whose timestamps are microseconds after `base_ns`; each event's
    args hold its attrs and its step."""
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": dict(s.attrs, step=s.step)}
            for s in spans]


@contextlib.contextmanager
def trace(log_dir: str, host: bool = True) -> Iterator["object"]:
    """A torch.profiler trace of the block with the spans recorded: CPU and
    CUDA activity where the card is there (`host=False`: CUDA alone), the
    CPU's alone elsewhere.  Yields the profiler; on exit the Chrome trace,
    the spans added as `p2m_span` events, is written to `log_dir` (its path
    set as the profiler's `trace_path`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with record_spans() as log, profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += span_events(log.spans, int(doc.get("baseTimeNanoseconds", 0)),
                                      os.getpid())
    with open(path, "w") as f:
        json.dump(doc, f)
    prof.trace_path = path


@dataclass
class SpanBreakdown:
    """A Chrome trace's device work and idle time by span name.  `device_us`
    and `idle_us` are each span's own (work launched, or idle time, while it
    was the innermost span open); the `_inclusive` forms add its
    descendants' (`span_breakdown` says which those are).  OUTSIDE holds
    what no span covers, UNATTRIBUTED the device work without a launch
    event.  All totals over the trace; `steps` counts its STEP spans."""
    steps: int = 0
    device_us: Dict[str, float] = field(default_factory=dict)
    device_us_inclusive: Dict[str, float] = field(default_factory=dict)
    launches_inclusive: Dict[str, int] = field(default_factory=dict)
    idle_us: Dict[str, float] = field(default_factory=dict)
    idle_us_inclusive: Dict[str, float] = field(default_factory=dict)
    ops_us: Dict[str, float] = field(default_factory=dict)     # device work by op name
    ops_calls: Dict[str, int] = field(default_factory=dict)
    busy_us: float = 0.0
    window_us: float = 0.0

    def per_step(self, d: Dict[str, float], name: str) -> float:
        """d[name] (0 where absent) over the steps."""
        return d.get(name, 0) / max(self.steps, 1)

    def summary(self, top: int = 12) -> Dict:
        """A step's numbers: the `top` spans by their own device ms and by
        their own idle ms, the device ms without a launch event, the idle
        ms and the kernels, copies and sets launched inside STEP, device
        busy ms."""
        def ranked(d):
            return [[k, self.per_step(d, k) / 1e3]
                    for k in sorted(d, key=lambda k: -d[k])[:top]]
        return {"steps": self.steps, "device_ms": ranked(self.device_us),
                "idle_ms": ranked(self.idle_us),
                "unattributed_ms": self.per_step(self.device_us, UNATTRIBUTED) / 1e3,
                "step_idle_ms": self.per_step(self.idle_us_inclusive, STEP) / 1e3,
                "launches": self.per_step(self.launches_inclusive, STEP),
                "busy_ms": self.busy_us / 1e3 / max(self.steps, 1)}


class _Threads:
    """The spans of each thread, sorted by start (each dict's "i"), with
    their parents found from the nesting of their intervals;
    `innermost(tid, t)` is the span entered last of those open on that
    thread at time t."""

    def __init__(self, spans: List[Dict]):
        self.by_tid: Dict[int, tuple] = {}
        for tid in {s["tid"] for s in spans}:
            own = sorted((s for s in spans if s["tid"] == tid),
                         key=lambda s: (s["a"], -s["b"]))
            parent, stack = [], []
            for i, s in enumerate(own):
                s["i"] = i
                while stack and own[stack[-1]]["b"] <= s["a"]:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.by_tid[tid] = (own, [s["a"] for s in own], parent)

    def innermost(self, tid, t: float) -> Optional[Dict]:
        own, starts, parent = self.by_tid.get(tid, ((), (), ()))
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and own[i]["b"] <= t:
            i = parent[i]
        return own[i] if i >= 0 else None

    def deepest(self, t: float) -> Optional[Dict]:
        """Of the threads' innermost spans open at t, the one entered last."""
        open_ = [s for s in (self.innermost(tid, t) for tid in self.by_tid) if s is not None]
        return max(open_, key=lambda s: s["a"], default=None)

    def parent(self, s: Dict) -> Optional[Dict]:
        own, _, parent = self.by_tid[s["tid"]]
        p = parent[s["i"]]
        return own[p] if p >= 0 else None


def span_breakdown(events: Sequence[Dict]) -> SpanBreakdown:
    """Put the device work and idle time of a Chrome trace that holds the
    program's spans (`trace`) down to those spans.  A span on another thread
    than the main one (the thread of the earliest span), entered outside any
    span of its own thread, descends from the main thread's span open when
    it began: autograd's thread works for the main thread's backward.  A
    kernel, copy or set goes to the innermost span open, at its launch
    event's time, on the launching thread; launched by another thread than
    the main one with no span open on its own, or by a thread the trace
    names otherwise than the spans do (a trace of the card's activity alone
    names launching threads by CUPTI's ids), to the innermost span open at
    that time (of the spans open on every thread, the one entered last: the
    main thread launches nothing while it waits inside `p2m.backward`, and
    autograd's thread nothing outside it).  An idle gap of the device,
    inside the window from the first span or operation to the last, goes to
    the innermost span open at its middle."""
    spans = [{"name": e["name"], "tid": e.get("tid"), "a": float(e["ts"]),
              "b": float(e["ts"]) + float(e.get("dur", 0.0))}
             for e in events if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]
    threads = _Threads(spans)
    main = min(spans, key=lambda s: s["a"])["tid"] if spans else None
    out = SpanBreakdown(steps=sum(1 for s in spans if s["name"] == STEP))

    def owner(tid, t: float) -> Optional[Dict]:
        s = threads.innermost(tid, t)
        return s if s is not None or tid == main else threads.deepest(t)

    lineage: Dict[int, tuple] = {}

    def names(s: Optional[Dict]) -> tuple:
        """The span's name and its ancestors', each once."""
        if s is None:
            return (OUTSIDE,)
        if id(s) not in lineage:
            up = threads.parent(s)
            if up is None and s["tid"] != main:
                up = threads.innermost(main, s["a"])
            chain = names(up) if up is not None else ()
            lineage[id(s)] = (s["name"],) + tuple(n for n in chain if n != s["name"])
        return lineage[id(s)]

    def add(d: Dict, k: str, v) -> None:
        d[k] = d.get(k, 0) + v

    launch = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
              for e in events if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    busy, t_lo, t_hi = [], [s["a"] for s in spans], [s["b"] for s in spans]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, dur = float(e["ts"]), float(e.get("dur", 0.0))
        busy.append((a, a + dur))
        t_lo.append(a)
        t_hi.append(a + dur)
        add(out.ops_us, e["name"], dur)
        add(out.ops_calls, e["name"], 1)
        at = launch.get(e.get("args", {}).get("correlation"))
        chain = (UNATTRIBUTED,) if at is None else names(owner(at[1], at[0]))
        add(out.device_us, chain[0], dur)
        for n in chain:
            add(out.device_us_inclusive, n, dur)
            add(out.launches_inclusive, n, 1)
    if not t_lo:
        return out
    w0, w1 = min(t_lo), max(t_hi)
    out.window_us = w1 - w0
    merged: List[List[float]] = []
    for a, b in sorted(busy):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_us = sum(b - a for a, b in merged)
    for a, b in zip([w0] + [b for _, b in merged], [a for a, _ in merged] + [w1]):
        if b <= a:
            continue
        chain = names(threads.deepest((a + b) / 2))
        add(out.idle_us, chain[0], b - a)
        for n in chain:
            add(out.idle_us_inclusive, n, b - a)
    return out


def profile_spans(run: Callable[[], None]) -> SpanBreakdown:
    """`span_breakdown` of a `trace` of the card's activity alone over
    `run`, which should end synchronized."""
    with tempfile.TemporaryDirectory() as d:
        with trace(d, host=False) as prof:
            run()
        with open(prof.trace_path) as f:
            return span_breakdown(json.load(f)["traceEvents"])


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
