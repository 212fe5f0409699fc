"""The comparison that decides `correct`, driven through the rest of a run
with the timed path broken underneath (on the CPU at a small size; the
harness's look for a chip is skipped), once for each fault the cells can
have, and the control (the reference in fp8 put in the program's place).
The cells' own limits (`limits/<cell>.json`) judge.  The program runs in
float32 here, where it agrees with the reference to about 1e-7
(test_bp_reference.py), so a sound run passes and only the fault fails; a
cell has no exchange between chips to leave out (one chip each)."""
import json
import time

import torch

from bench_port import harness
from bench_port.control import RefServe, RefTrain
from bench_port.harness import BENCH
from bench_port.system import ServeSystem, TrainSystem
from bench_port.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def _limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def _run(kind, factory=None, f32=True, seed=3, limits_of=None):
    cell = tiny_cell(kind, batch=8)
    cell.limits = _limits(limits_of or cell.name)
    if f32:
        cell.cfg["compute_dtype"] = "float32"
    kw = {}
    if factory is not None:
        kw["serve_factory" if kind == "serve" else "train_factory"] = factory
    res = harness.run_cell(cell, seed, 0.2, False, CPU, t0=time.perf_counter(),
                           log=lambda *a: None, **kw)
    return res, {k: c["ok"] for k, c in res["checks"].items()}


def _correct(res):
    return all(c["ok"] for c in res["checks"].values()) and res["failed"] == 0


class _Wrap:
    def __init__(self, inner, step):
        self.inner, self._step = inner, step

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def step(self, x):
        return self._step(self.inner, x)


def _serve(step):
    return lambda *a: _Wrap(ServeSystem(*a), step)


def _train(step):
    return lambda *a: _Wrap(TrainSystem(*a), step)


def test_sound_runs_are_correct():
    assert _correct(_run("serve")[0])
    assert _correct(_run("train")[0])


def test_serve_answer_altered_where_produced():
    def rotate(inner, x):   # each row answered with the next row's mesh
        mesh, reg, pose = inner.step(x)
        return mesh.roll(1, 0), reg, pose
    res, ok = _run("serve", _serve(rotate))
    assert not _correct(res) and not ok["mesh_gap"] and not ok["mesh_row_gap"]


def test_serve_half_the_batch_left_out():
    def half(inner, x):     # the second half answered with the first half's rows
        h = x.shape[0] // 2
        outs = inner.step(x[:h])
        return tuple(torch.cat([o, o]) for o in outs)
    res, ok = _run("serve", _serve(half))
    assert not _correct(res) and not ok["mesh_gap"] and not ok["pose3d_gap"]


def test_train_state_left_unchanged():
    def frozen(inner, batch):
        saved = {k: p.detach().clone() for k, p in inner.model.named_parameters()}
        losses = inner.step(batch)
        with torch.no_grad():
            for k, p in inner.model.named_parameters():
                p.copy_(saved[k])
        return losses
    res, ok = _run("train", _train(frozen))
    assert not _correct(res) and not ok["change_gap"]


def test_train_half_the_batch_left_out():
    def half(inner, batch):  # the mean taken over the first half only
        h = batch["pose2d"].shape[0] // 2
        return inner.step({k: v[:h] for k, v in batch.items()})
    res, ok = _run("train", _train(half))
    assert not _correct(res) and not ok["lift_loss_gap"]


def test_train_loss_altered_where_produced():
    def off(inner, batch):
        losses = inner.step(batch)
        return dict(losses, total=losses["total"] * 1.2)
    res, ok = _run("train", _train(off))
    assert not _correct(res) and not ok["loss_gap"]


def test_fp8_serve_control_is_not_correct():
    res, ok = _run("serve", RefServe)
    assert not _correct(res)


def test_fp8_train_control_is_not_correct():
    """The training control at the MANO configuration's published widths,
    batch 32 (a CPU test run's size), is caught on every seed: its median
    leaf's first-gradient gap reads 0.042, 0.024 and 0.022 on seeds 1-3
    against the cell's limit of 0.015 (its first step's loss gap 0.054,
    0.0072 and 0.018 against 0.04)."""
    cell = harness.load_cell("mano_freihand21.train_b64")
    cell.traffic.update(batch=32, pool=3)
    for seed in (1, 2, 3):
        res = harness.run_cell(cell, seed, 0.1, False, CPU, t0=time.perf_counter(),
                               log=lambda *a: None, train_factory=RefTrain)
        assert not _correct(res), seed
