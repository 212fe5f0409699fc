"""One run of one cell: set-up, the measured window, the optional traced
segment, the comparison with the reference, and the result.

Everything a cell needs is found by name: `BENCHMARK.json` names the cell's
configuration (`configs/<config>.json` and the mesh file it names) and
traffic mix (`traffic/<mix>.json`); the cell's limits are
`limits/<cell>.json`; each metric is `metrics/<metric>.py`, whose
`read(run)` returns its number or None.  The kinds "serve" and "train" run
here; any other traffic kind k is `kinds/<k>.py`, whose `run(cell, seed,
seconds, trace, device, *, t0, log, **factories)` returns what `run_cell`
returns.  Adding a cell adds files and entries, a new kind included; no
code here names a cell, a configuration, a metric or a kind of `kinds/`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import counts
from .generator import (ServeLoop, WindowRecord, serve_pool, statistics_poses, sync,
                        train_pool, train_window)
from .reference.model import RefModel
from .reference.pyramid import RefPyramid, build_ref_pyramid
from .system import ServeSystem, TrainSystem, launch_counters
from .trace import TraceSummary, profile_segment
from .weights import make_state_dict, sub_seed

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

__all__ = ["BENCH", "ROOT", "Cell", "Run", "load_cell", "load_metric", "load_kind",
           "cell_metrics", "run_cell", "check_numbers"]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    cfg: Dict
    mesh: Dict[str, np.ndarray]
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, manifest: Optional[Dict] = None, bench: Path = BENCH) -> Cell:
    manifest = manifest if manifest is not None else _json(bench.parent / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = _json(bench / "configs" / f"{entry['config']}.json")
    with np.load(bench / "configs" / cfg["mesh"]) as z:
        mesh = {k: z[k] for k in z.files}
    limits_path = bench / "limits" / f"{name}.json"
    return Cell(name=name, cfg=cfg, mesh=mesh,
                traffic=_json(bench / "traffic" / f"{entry['traffic']}.json"),
                limits=_json(limits_path) if limits_path.exists() else {},
                end_to_end=cell_metrics(manifest["end_to_end"], name),
                per_layer=cell_metrics(manifest["per_layer"], name))


def cell_metrics(entries: List[Dict], cell: str) -> List[Dict]:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def _load_file(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, bench: Optional[Path] = None) -> ModuleType:
    return _load_file((bench or BENCH) / "metrics" / f"{name}.py", "bench_port_metric_", name)


def load_kind(name: str, bench: Optional[Path] = None) -> ModuleType:
    """The module of traffic kind `name` (`kinds/<name>.py`)."""
    path = (bench or BENCH) / "kinds" / f"{name}.py"
    if not path.exists():
        raise ValueError(f"traffic kind {name!r}: no {path}")
    return _load_file(path, "bench_port_kind_", name)


@dataclass
class Run:
    """What a metric reads: the untraced window, set-up, the traced segment
    (trace runs) and the shape-based counts of one step."""
    kind: str
    window: WindowRecord
    setup_s: float
    flops_per_step: float = 0.0
    band_bound_s_per_step: float = 0.0
    trace: Optional[TraceSummary] = None
    launches_per_step: Dict[str, float] = field(default_factory=dict)
    loader_wait: Optional[List[float]] = None   # each window step's wait for its batch, s


# ---- the comparison -------------------------------------------------------

def check_numbers(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {"value", "limit", "ok"}}; a number without a limit, or not
    finite, fails."""
    out = {}
    for k, v in numbers.items():
        lim = limits.get(k)
        ok = lim is not None and math.isfinite(v) and v <= lim
        out[k] = {"value": v, "limit": lim, "ok": ok}
    return out


def compare_serve(kept, pool: torch.Tensor, ref: RefModel) -> Dict[str, float]:
    """The kept answers against the reference on their own inputs.  The mesh's
    and the lifted pose's L2 gap over every kept row are measured against
    the reference's spread over those rows (its deviation from their mean:
    the part of an answer that depends on the input; with random weights
    most of a mesh does not), the worst row's mesh gap against the rows' RMS
    spread, and the regressed joints' gap against their own norm (the
    regressor averages the spread away)."""
    prog, refs = ([], [], []), ([], [], [])
    for bufs, i in kept:
        for k, (a, r) in enumerate(zip(bufs, ref.eval_step(pool[i % pool.shape[0]]))):
            prog[k].append(a.double())
            refs[k].append(r.double().cpu())
    nums = {}
    for k, name in enumerate(("mesh", "joints", "pose3d")):
        P, R = torch.cat(prog[k]), torch.cat(refs[k])
        spread2 = float(((R - R.mean(0)) ** 2).sum())
        gap2 = float(((P - R) ** 2).sum())
        if name == "joints":
            spread2 = float((R ** 2).sum())
        nums[f"{name}_gap"] = math.sqrt(gap2 / spread2) if spread2 > 0 else math.inf
        if k == 0:
            rms = math.sqrt(spread2 / R.shape[0])
            nums["mesh_row_gap"] = float((P - R).flatten(1).norm(dim=1).max()) / rms
    return {k: (v if math.isfinite(v) else math.inf) for k, v in nums.items()}


def _gap(p: float, r: float) -> float:
    g = abs(p - r) / abs(r)
    return g if math.isfinite(g) else math.inf


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]
               ) -> List[float]:
    """Each leaf's gap of norms, against the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in names)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in names]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _total_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> float:
    """The gap of the norms taken over the leaves together."""
    return _gap(*(math.sqrt(sum(d[k] ** 2 for k in names)) for d in (prog, ref)))


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's; the others (the biases that feed a BatchNorm) have a
    gradient of nought to rounding and move by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k in ref_grad if ref_grad[k] >= 1e-3 * med]


def compare_train(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The first check step's total loss and its lift-joint part (the later
    steps carry RMSprop's first, sign-like update of elements whose gradient
    is round-off: see PERF.md); the first gradient's norms by the worst and
    by the median of the moving leaves; the parameters' change after the
    check steps by the worst moving leaf and over all of them together.  The
    worst leaf swings with the round-off of one small leaf; the median
    leaf's gradient and the whole change are steady from seed to seed, and
    they are what the fp8 control and the half-batch fault move."""
    moving = moving_leaves(ref["grad"])
    grad = _leaf_gaps(prog["grad"], ref["grad"], moving)
    return {"loss_gap": _gap(prog["losses"][0], ref["losses"][0]),
            "lift_loss_gap": _gap(prog["parts"]["lift_joint"], ref["parts"]["lift_joint"]),
            "grad_gap": max(grad),
            "grad_median_gap": statistics.median(grad),
            "change_gap": max(_leaf_gaps(prog["change"], ref["change"], moving)),
            "change_total_gap": _total_gap(prog["change"], ref["change"], moving)}


# ---- one run ------------------------------------------------------------

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, *,
             t0: float, log: Callable = print, **factories: Callable) -> Dict:
    """Run `cell` once; returns the result's fields (and "checks") without
    `device` readings of the card, which the caller adds.  The factories
    build the system under test (the port's; calibration and tests put
    the reference or a planted fault in its place): `serve_factory` and
    `train_factory` for the kinds run here, and whatever a kind's module
    takes for its own."""
    kind = cell.traffic["kind"]
    if kind == "serve":
        return _run_serve(cell, seed, seconds, trace, device, t0,
                          factories.get("serve_factory", ServeSystem), log)
    if kind == "train":
        return _run_train(cell, seed, seconds, trace, device, t0,
                          factories.get("train_factory", TrainSystem), log)
    return load_kind(kind).run(cell, seed, seconds, trace, device, t0=t0, log=log, **factories)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _ref_pyramid(cell: Cell) -> RefPyramid:
    js = cell.cfg["joint_set"]
    return build_ref_pyramid(cell.mesh["faces"], js["joint_num"], js["skeleton"],
                             js["flip_pairs"], js["extra_edges"], cell.cfg["levels"])


def _traced(segment: Callable[[int], Callable[[], None]], n: int,
            device: torch.device) -> TraceSummary:
    """The device segment of n steps, then a host segment of n / 4 (at
    least 2) whose idle gaps, labelled by the host's spans and operators,
    stand in the summary's `gaps`."""
    s = profile_segment(segment(n), n, device, host=False)
    h = max(2, n // 4)
    s.gaps = profile_segment(segment(h), h, device, host=True).gaps
    return s


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _launches(before: Dict[str, int], after: Dict[str, int], steps: int) -> Dict[str, float]:
    return {k: (after[k] - before.get(k, 0)) / max(steps, 1) for k in after
            if after[k] != before.get(k, 0)}


class _Marks:
    """Set-up's phases on the host clock, logged when set-up ends."""

    def __init__(self, t0: float, log: Callable):
        self.t, self.log, self.parts = t0, log, []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f}")
        self.t = now

    def done(self) -> None:
        self.log("set-up s: " + ", ".join(self.parts))


def _run_serve(cell, seed, seconds, trace, device, t0, factory, log) -> Dict:
    cfg, tr = cell.cfg, cell.traffic
    mark = _Marks(t0, log)
    mark("process start to the cell")
    B, J, V = int(tr["batch"]), cfg["joint_set"]["joint_num"], cfg["num_vertices"]

    def weights():
        return make_state_dict(cfg, cfg["coarse_vertices"], seed, device)
    state = weights()
    mark("weights")
    # the reference's work, left out of setup_s: its pyramid, and the
    # BatchNorm statistics that its forward takes on the traffic's poses
    t_ref = time.perf_counter()
    pyr = _ref_pyramid(cell)
    stats = RefModel(cfg, pyr, cell.mesh["j_regressor"], state, device
                     ).batch_norm_statistics(statistics_poses(cell.mesh, tr, seed, device))
    state.update(stats)
    _free()
    if device.type == "cuda":   # the peak is the program's, not this pass's
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
    ref_s = time.perf_counter() - t_ref
    mark("reference pyramid and BatchNorm statistics (not set-up)")
    system = factory(cfg, cell.mesh, state, device)
    del state
    mark("system")
    pool = serve_pool(cell.mesh, tr, seed, device)
    loop = ServeLoop(system, pool, tr, seed, device, [(B, V, 3), (B, J, 3), (B, J, 3)])
    mark("requests")
    for _ in range(int(tr["warmup"])):
        loop.request(keep=False)
    loop.i = 0
    mark("warm-up")
    mark.done()
    setup_s = time.perf_counter() - t0 - ref_s
    before = launch_counters()
    rec = loop.window(seconds, B)
    launches = _launches(before, launch_counters(), rec.requests)
    summary = None
    if trace:
        def segment(n):
            return lambda: [loop.request(keep=False, label=True) for _ in range(n)]
        summary = _traced(segment, int(tr["trace_steps"]), device)
    peak = _peak(device)
    kept = loop.reservoir.items()
    del system, loop
    _free()

    ref = RefModel(cfg, pyr, cell.mesh["j_regressor"], dict(weights(), **stats), device)
    t_ref = time.perf_counter()
    numbers = compare_serve(kept, pool, ref)
    log(f"reference: {len(kept)} answers of {B} rows in {time.perf_counter() - t_ref:.3f} s")
    del ref
    failed = sum(1 for bufs, _ in kept if not all(torch.isfinite(b).all() for b in bufs))
    return _result(cell, rec, setup_s, numbers, failed, pyr, summary, launches, peak, B,
                   train=False)


def _run_train(cell, seed, seconds, trace, device, t0, factory, log) -> Dict:
    cfg, tr = cell.cfg, cell.traffic
    mark = _Marks(t0, log)
    mark("process start to the cell")
    B, n_check = int(tr["batch"]), int(tr["check_steps"])
    state = make_state_dict(cfg, cfg["coarse_vertices"], seed, device)
    mark("weights")
    system = factory(cfg, cell.mesh, state, device, sub_seed(seed, 4))
    mark("system")
    pool = train_pool(cell.mesh, tr, seed, device)
    mark("batches")

    def step(i: int):
        return system.step(pool[i % len(pool)])

    prog = {"losses": []}
    for s in range(n_check):
        losses = step(s)
        prog["losses"].append(float(losses["total"]))
        if s == 0:
            prog["parts"] = {k: float(v) for k, v in losses.items()}
            prog["grad"] = system.grad_norms_from_state()
        mark(f"check step {s}")
    prog["change"] = {k: float((p.detach().double() - state[k].double()).norm())
                      for k, p in system.named_parameters().items()}
    del state
    mark("change")
    first = n_check + int(tr["warmup"])
    for s in range(n_check, first):
        step(s)
    sync(device)
    mark("warm-up")
    mark.done()
    setup_s = time.perf_counter() - t0
    before = launch_counters()
    rec = train_window(step, first, seconds, B, device)
    launches = _launches(before, launch_counters(), rec.requests)
    summary = None
    if trace:
        at = [first + rec.requests]

        def segment(n):
            def run():
                for _ in range(n):
                    with torch.profiler.record_function("bench.step"):
                        step(at[0])
                    at[0] += 1
                sync(device)
            return run
        summary = _traced(segment, int(tr["trace_steps"]), device)
    peak = _peak(device)
    del system, pool, step
    _free()

    pyr = _ref_pyramid(cell)
    init = make_state_dict(cfg, cfg["coarse_vertices"], seed, device)
    ref = RefModel(cfg, pyr, cell.mesh["j_regressor"], init, device)
    pool = train_pool(cell.mesh, tr, seed, device)
    faces = torch.as_tensor(cell.mesh["faces"], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    t_ref = time.perf_counter()
    r = {"losses": []}
    for s in range(n_check):
        losses = ref.train_step(pool[s % len(pool)], faces, gen)
        r["losses"].append(losses["total"])
        if s == 0:
            r["parts"] = losses
            r["grad"] = {k: float(g.double().norm()) for k, g in ref.grads.items()}
    r["change"] = {k: float((ref.p[k].double() - init[k].double()).norm()) for k in r["grad"]}
    log(f"reference: {n_check} steps in {time.perf_counter() - t_ref:.3f} s; program losses "
        f"{prog['losses']}, reference {r['losses']}")
    numbers = compare_train(prog, r)
    del ref, init, pool
    return _result(cell, rec, setup_s, numbers, rec.failed, pyr, summary, launches, peak, B,
                   train=True)


def _result(cell, rec, setup_s, numbers, failed, pyr, summary, launches, peak, B,
            train: bool, **run_fields) -> Dict:
    """The result's fields; `run_fields` set the Run's other fields (a kind
    of `kinds/` gives the kind whose metric readers read its Run)."""
    convs = counts.conv_table(cell.cfg, pyr.sizes, pyr.nnz, int(pyr.joint_laplacian.nnz))
    run_fields.setdefault("kind", cell.traffic["kind"])
    run = Run(window=rec, setup_s=setup_s,
              flops_per_step=counts.step_flops(cell.cfg, convs, cell.cfg["coarse_vertices"],
                                               B, train),
              band_bound_s_per_step=counts.band_bound_s(convs, B, train),
              trace=summary, launches_per_step=launches, **run_fields)
    checks = check_numbers(numbers, cell.limits)
    return {"run": run, "attempted": rec.requests, "failed": int(failed),
            "checks": checks, "memory_peak_bytes": peak}


def read_metrics(run: Run, entries: List[Dict], bench: Optional[Path] = None
                 ) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        v = load_metric(m["name"], bench).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
