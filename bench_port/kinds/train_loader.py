"""Traffic kind "train_loader": training steps fed by the port's own data
layer, as `core/engine.py::Trainer.train_epoch` runs them.

Set-up writes the stand-in annotation files of the configuration's
`train_list` from the seed (`annotations.py`) into a temporary directory,
builds the port's datasets, mix and loader over them (`system.LoaderData`:
GT synthesis on the card, the datasets' pyramid) and deletes the files,
which the datasets have read.  The train step is `system.TrainSystem` on
the datasets' pyramid and regressor, with the benchmark's seeded weights.
Every step draws its batch from one epoch of the loader, which prefetches
in its threads as in training: `check_steps` steps compared with the
reference, `warmup` more, the window's steps back to back (each step's wait
for its batch in `Run.loader_wait`, its call in `dispatch`), and with a
trace the traced segment's.  A step fails on a non-finite loss; the
window ends at a loader that gives no batch, counted as a failed step.

The check: the loader's batches cannot be drawn again (its threads share
one generator), so the check steps' batches are kept as the loader
delivered them, and the plain reference trains from the same weights on
them with the same dropout generator (`harness.compare_train`).  The data
layer that made them is checked by itself on the same batches
(`compare_targets`).  Factories: `train_factory` replaces the train step
(the reference as control or fault), `data_factory` the data layer.
"""
from __future__ import annotations

import functools
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_port import harness
from bench_port.annotations import write_annotations
from bench_port.generator import WindowRecord, sync
from bench_port.reference.model import RefModel
from bench_port.system import LoaderData, TrainSystem, launch_counters, smpl_joints
from bench_port.weights import make_state_dict, sub_seed

__all__ = ["run", "compare_targets"]


def _swap(x: torch.Tensor, pairs) -> torch.Tensor:
    idx = list(range(x.shape[1]))
    for a, b in pairs:
        idx[a], idx[b] = idx[b], idx[a]
    return x[:, idx]


def compare_targets(batches: List[Dict[str, torch.Tensor]], cfg: Dict,
                    mesh: Dict[str, np.ndarray]) -> float:
    """The data layer's targets against their own mesh, mm: each row's
    regressed-joint target against the frozen target regressor over its
    mesh target, and its lifted-pose target against the frozen input
    regressor's joints over it (with the input set's Pelvis and Neck the
    midpoints of its hips and shoulders, relative to Pelvis), both as
    augmented, unflipped or flipped (a flipped row's joints swap their
    pairs), whichever is nearer; the worst joint of the worst row.  Reads
    about the round-off of the annotations and of float32; a row whose
    targets are another sample's reads as far as two bodies' poses lie."""
    js, ts = cfg["joint_set"], cfg["target_joint_set"]
    names = js["joints_name"]
    hips = [names.index("L_Hip"), names.index("R_Hip")]
    shoulders = [names.index("L_Shoulder"), names.index("R_Shoulder")]
    dev = batches[0]["mesh"].device
    reg = torch.as_tensor(mesh["j_regressor"], dtype=torch.float64, device=dev)
    inp = torch.as_tensor(mesh["coco_regressor"], dtype=torch.float64, device=dev)
    worst = 0.0
    for b in batches:
        m = b["mesh"].double() * 1000.0
        J = torch.einsum("jv,bvc->bjc", reg, m)
        L = torch.einsum("jv,bvc->bjc", inp, m)
        L = torch.cat([L, L[:, hips].mean(1, keepdim=True), L[:, shoulders].mean(1, keepdim=True)],
                      dim=1)
        L = L - L[:, names.index("Pelvis")][:, None]
        reg_t, lift_t = b["reg_pose3d"].double(), b["lift_pose3d"].double()
        gaps = []
        for flip in (False, True):
            Jf = _swap(J, ts["flip_pairs"]) if flip else J
            Lf = _swap(L, js["flip_pairs"]) if flip else L
            gaps.append(torch.maximum((reg_t - Jf).norm(dim=-1).amax(1),
                                      (lift_t - Lf).norm(dim=-1).amax(1)))
        worst = max(worst, float(torch.minimum(*gaps).max()))
    return worst


def _window(batches, system, seconds: float, B: int, device: torch.device, log: Callable
            ) -> Tuple[WindowRecord, List[float]]:
    """Closed-loop steps until `seconds` have passed on the host, then one
    synchronize; each step's wait for its batch and its call."""
    rec, waits, totals = WindowRecord(), [], []
    rec.t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(batches)
        except (StopIteration, RuntimeError) as e:
            log(f"the loader gave no batch after {len(totals)} window steps: {e!r}")
            rec.failed += 1
            break
        t1 = time.perf_counter()
        losses = system.step(batch)
        t2 = time.perf_counter()
        waits.append(t1 - t0)
        rec.dispatch.append(t2 - t1)
        totals.append(losses["total"])
        if t2 - rec.t_start >= seconds:
            break
    sync(device)
    rec.t_end = time.perf_counter()
    rec.requests = len(totals)
    rec.items = rec.requests * B
    if totals:
        rec.failed += int((~torch.isfinite(torch.stack(totals).float())).sum())
    return rec, waits


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, *, t0: float,
        log: Callable, train_factory: Optional[Callable] = None,
        data_factory: Callable = LoaderData) -> Dict:
    cfg, tr = cell.cfg, cell.traffic
    mark = harness._Marks(t0, log)
    mark("process start to the cell")
    B, n_check = int(tr["batch"]), int(tr["check_steps"])
    # the augmentation's rotations draw from numpy's global generator
    np.random.seed(sub_seed(seed, 9) % 2 ** 32)
    with tempfile.TemporaryDirectory(prefix="bench_port_annotations_") as root:
        write_annotations(root, cfg["annotations"], tr, cell.mesh, seed,
                          lambda *a: smpl_joints(*a, device=device))
        mark("annotation files")
        data = data_factory(cfg, tr, root, device)
        mark("datasets and loader")
    state = make_state_dict(cfg, cfg["coarse_vertices"], seed, device)
    mark("weights")
    factory = train_factory or functools.partial(TrainSystem, art=data.graph,
                                                  j_regressor=data.target_regressor)
    system = factory(cfg, cell.mesh, state, device, sub_seed(seed, 4))
    mark("system")
    batches = data.batches()

    kept, prog = [], {"losses": []}
    for s in range(n_check):
        batch = next(batches)
        kept.append({k: v.clone() for k, v in batch.items()})
        losses = system.step(batch)
        prog["losses"].append(float(losses["total"]))
        if s == 0:
            prog["parts"] = {k: float(v) for k, v in losses.items()}
            prog["grad"] = system.grad_norms_from_state()
        mark(f"check step {s}")
    prog["change"] = {k: float((p.detach().double() - state[k].double()).norm())
                      for k, p in system.named_parameters().items()}
    del state
    mark("change")
    for _ in range(int(tr["warmup"])):
        system.step(next(batches))
    sync(device)
    mark("warm-up")
    mark.done()
    setup_s = time.perf_counter() - t0

    before = launch_counters()
    rec, waits = _window(batches, system, seconds, B, device, log)
    launches = harness._launches(before, launch_counters(), rec.requests)
    summary = None
    if trace and not rec.failed:
        def segment(n):
            def go():
                for _ in range(n):
                    with torch.profiler.record_function("bench.loader"):
                        batch = next(batches)
                    with torch.profiler.record_function("bench.step"):
                        system.step(batch)
                sync(device)
            return go
        summary = harness._traced(segment, int(tr["trace_steps"]), device)
    peak = harness._peak(device)
    batches.close()
    del system, data, batches, factory
    harness._free()

    pyr = harness._ref_pyramid(cell)
    init = make_state_dict(cfg, cfg["coarse_vertices"], seed, device)
    ref = RefModel(cfg, pyr, cell.mesh["j_regressor"], init, device)
    faces = torch.as_tensor(cell.mesh["faces"], dtype=torch.int64, device=device)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 4))
    t_ref = time.perf_counter()
    r = {"losses": []}
    for s, batch in enumerate(kept):
        losses = ref.train_step(batch, faces, gen)
        r["losses"].append(losses["total"])
        if s == 0:
            r["parts"] = losses
            r["grad"] = {k: float(g.double().norm()) for k, g in ref.grads.items()}
    r["change"] = {k: float((ref.p[k].double() - init[k].double()).norm()) for k in r["grad"]}
    log(f"reference: {n_check} steps in {time.perf_counter() - t_ref:.3f} s; program losses "
        f"{prog['losses']}, reference {r['losses']}")
    numbers = harness.compare_train(prog, r)
    numbers["target_gap_mm"] = compare_targets(kept, cfg, cell.mesh)
    del ref, init, kept
    return harness._result(cell, rec, setup_s, numbers, rec.failed, pyr, summary, launches,
                           peak, B, train=True, kind="train", loader_wait=waits)
