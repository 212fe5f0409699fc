"""The traced segments: torch.profiler over a few steps of the cell's loop,
reduced to what the per-layer metrics and the `breakdown` read.

The profiler's chrome trace is written to a temporary directory and read
back.  Two segments follow the window.  The device segment traces the card
alone (CUDA activity: kernels, copies, sets), which costs the host little:
the device's busy time is the union of those operations, its window the
host clock's length of the segment (which ends synchronized), and kernel
times by name come from it.  The host segment, shorter, also records the
host's operators (which slows a host-bound step about twice) inside a
`bench.trace_window` annotation, only to put each idle gap of the device
down to what the host was doing at its middle: the outermost `bench.*` span
and the innermost operator there (gaps under GAP_LABEL_US are pooled as
"short gaps").
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["TraceSummary", "profile_segment", "summarize", "kernel_seconds"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
GAP_LABEL_US = 5.0
WINDOW = "bench.trace_window"


@dataclass
class TraceSummary:
    window_s: float = 0.0
    busy_s: float = 0.0
    steps: int = 0
    kernels: Dict[str, float] = field(default_factory=dict)   # full name -> seconds
    device_ops: Dict[str, float] = field(default_factory=dict)  # short name -> seconds
    gaps: Dict[str, float] = field(default_factory=dict)      # host label -> seconds

    def top(self, d: Dict[str, float], n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0][:96] or "unnamed"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: Sequence[Dict], steps: int, window_s: float = 0.0) -> TraceSummary:
    """With window_s (a device segment): the window is that long from the
    first device operation; else the `bench.trace_window` span's."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"
           and e.get("cat") == "user_annotation"]
    if window_s:
        starts = [float(e["ts"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        w0 = min(starts, default=0.0)
        w1 = w0 + window_s * 1e6
        tid = None
    elif win:
        w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
        tid = win[0].get("tid")
    else:
        raise ValueError(f"no {WINDOW} span in the trace")
    s = TraceSummary(window_s=(w1 - w0) * 1e-6, steps=steps)
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        sec = (b - a) * 1e-6
        if e["cat"] == "kernel":
            s.kernels[e["name"]] = s.kernels.get(e["name"], 0.0) + sec
        k = short_name(e["name"])
        s.device_ops[k] = s.device_ops.get(k, 0.0) + sec
    busy = _union(dev)
    s.busy_s = sum(b - a for a, b in busy) * 1e-6
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and tid is not None and e.get("tid") == tid and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("bench.")]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < GAP_LABEL_US:
            label = "short gaps"
        else:
            label = _label(host, starts, spans, (a + b) / 2)
        s.gaps[label] = s.gaps.get(label, 0.0) + (b - a) * 1e-6
    return s


def _label(host, starts, spans, mid: float) -> str:
    outer = next((n for a, b, n in spans if a <= mid <= b), "outside bench spans")
    i = bisect.bisect_right(starts, mid) - 1
    inner = None
    while i >= 0:
        a, b, n = host[i]
        if b >= mid and not n.startswith("bench."):
            inner = n
            break
        if n.startswith("bench.") and b >= mid:
            break
        i -= 1
    return outer if inner is None else f"{outer}: {inner}"


def profile_segment(run: Callable[[], None], steps: int, device: torch.device,
                    host: bool) -> TraceSummary:
    """Profile `run` (the segment's steps, ending synchronized): with `host`
    the host's operators and, on the card, the device; else the card alone,
    the window timed on the host clock."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] if host else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    if not acts:  # no card: the window alone
        t0 = time.perf_counter()
        run()
        return TraceSummary(window_s=time.perf_counter() - t0, steps=steps)
    with tempfile.TemporaryDirectory() as d:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if host:
                with record_function(WINDOW):
                    run()
            else:
                run()
            window_s = time.perf_counter() - t0
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, steps, 0.0 if host else window_s)


def kernel_seconds(summary: TraceSummary, names: Sequence[str]) -> float:
    """Device seconds of the kernels whose name holds one of `names` as a
    whole identifier."""
    pats = [re.compile(rf"(?<![A-Za-z0-9_]){re.escape(n)}(?![A-Za-z0-9_])") for n in names]
    return sum(sec for k, sec in summary.kernels.items() if any(p.search(k) for p in pats))
