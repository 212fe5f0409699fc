"""The loader-fed training kind (`kinds/train_loader.py`) on the CPU at a
size a test holds: the stand-in annotation files read back whole by the
port's datasets, the frozen mesh and pyramid of smpl_coco19, a run end to
end, and `correct` coming out false for each fault the cell can have and
for the fp8 control.  The program runs in float32 here, where it agrees
with the reference to about 1e-7, so a sound run passes the cell's own
limits and only a fault fails them."""
import json
import tempfile
import time

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bench_port import harness
from bench_port.annotations import H36M_CAMERAS, write_annotations
from bench_port.control import RefTrain, RolledTargets
from bench_port.harness import BENCH, load_metric
from bench_port.kinds.train_loader import compare_targets
from bench_port.reference.pyramid import build_ref_pyramid
from bench_port.system import LoaderData, TrainSystem, smpl_joints
from bench_port.tests.tiny import TINY_ANNOTATIONS, tiny_loader_cell

CPU = torch.device("cpu")
SEED = 2 ** 33 + 5


def _limits():
    """smpl_h36m17.train_b64's limits for the training numbers, and 1 mm for
    the data layer's own check (a sound run reads about 0.01 mm here, a
    row's targets another sample's tens to hundreds of mm)."""
    lim = json.loads((BENCH / "limits" / "smpl_h36m17.train_b64.json").read_text())
    return dict(lim, target_gap_mm=1.0)


def _correct(res):
    return all(c["ok"] for c in res["checks"].values()) and res["failed"] == 0


def _run(trace=False, seed=SEED, **factories):
    cell = tiny_loader_cell(_limits())
    cell.cfg["compute_dtype"] = "float32"
    res = harness.run_cell(cell, seed, 0.2, trace, CPU, t0=time.perf_counter(),
                           log=lambda *a: None, **factories)
    return cell, res, {k: c["ok"] for k, c in res["checks"].items()}


@pytest.fixture(scope="module")
def loader_data():
    cell = tiny_loader_cell(_limits())
    with tempfile.TemporaryDirectory() as root:
        write_annotations(root, cell.cfg["annotations"], cell.traffic, cell.mesh, SEED,
                          lambda *a: smpl_joints(*a, device=CPU))
        return cell, LoaderData(cell.cfg, cell.traffic, root, CPU)


def _away_from_the_half_turn(d) -> np.ndarray:
    """The samples whose GT the port's synthesis poses right: for Human3.6M
    those whose camera-frame root rotation lies 0.05 rad or more from a
    half turn (nearer, the float32 log map that folds the camera into the
    root is wrong by up to a whole rotation: PERF.md), for the others
    all."""
    if d.name != "Human36M":
        return np.ones(len(d), bool)
    R = np.stack([x["cam_param"]["R"] for x in d.datalist]).astype(np.float64)
    root = Rotation.from_rotvec(np.stack([x["smpl_pose"][:3] for x in d.datalist]))
    return np.pi - Rotation.from_matrix(R @ root.as_matrix()).magnitude() >= 0.05


def test_datasets_read_back_every_sample(loader_data):
    """Every stand-in sample written is read, and each fit agrees with its
    joints: no fit-error filter invalidates a sample that the datasets'
    GT synthesis poses right."""
    cell, data = loader_data
    assert [d.name for d in data.datasets] == cell.cfg["train_list"]
    for d in data.datasets:
        assert len(d) == TINY_ANNOTATIONS[d.name], d.name
        right = _away_from_the_half_turn(d)
        assert float(d.fit_error[right].max()) < 0.01 * d.fitting_thr, d.name
        for i in np.flatnonzero(right):
            meta = d[i][2]
            assert all(float(v.min()) == 1.0 for v in meta.values()), (d.name, i)
    assert len(data.loader) == 3 * max(TINY_ANNOTATIONS.values()) // cell.traffic["batch"]


def test_the_data_layers_targets_agree_with_their_mesh(loader_data):
    cell, data = loader_data
    it = data.batches()
    batches = [next(it) for _ in range(3)]
    it.close()
    assert compare_targets(batches, cell.cfg, cell.mesh) < 0.05
    rolled = [dict(b, mesh=b["mesh"].roll(-1, 0)) for b in batches]
    assert compare_targets(rolled, cell.cfg, cell.mesh) > 50.0


def test_the_human36m_count_is_whole_frames():
    with tempfile.TemporaryDirectory() as root, pytest.raises(ValueError):
        cell = tiny_loader_cell(_limits())
        write_annotations(root, {"Human36M": H36M_CAMERAS + 1}, cell.traffic, cell.mesh, 1,
                          lambda *a: smpl_joints(*a, device=CPU))


def test_frozen_mesh_is_the_stand_in_and_the_pyramid_the_datasets():
    """smpl_coco19's faces are the datasets' SMPL body's, its regressors
    rows of 8 vertices each; the reference's pyramid has the datasets'
    pyramid's levels and nonzeros (dense_threshold 1024: three band
    levels)."""
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.base import pyramid_for
    from pose2mesh_release_tpu_torch.data.joint_sets import COCO, HUMAN36
    cfg = json.loads((BENCH / "configs" / "smpl_coco19.json").read_text())
    with np.load(BENCH / "configs" / cfg["mesh"]) as z:
        mesh = {k: z[k] for k in z.files}
    assert np.array_equal(mesh["faces"], SMPL().face)
    for key in ("j_regressor", "coco_regressor"):
        reg = mesh[key]
        assert reg.shape == (17, cfg["num_vertices"])
        assert np.allclose(reg.sum(1), 1.0) and ((reg > 0).sum(1) == 8).all()
    js, ts = cfg["joint_set"], cfg["target_joint_set"]
    assert js["joints_name"] == list(COCO.joints_name) and js["joint_num"] == COCO.joint_num
    assert [tuple(e) for e in js["skeleton"]] == list(COCO.skeleton)
    assert [tuple(e) for e in js["flip_pairs"]] == list(COCO.flip_pairs)
    assert ts["joints_name"] == list(HUMAN36.joints_name)
    assert [tuple(e) for e in ts["flip_pairs"]] == list(HUMAN36.flip_pairs)
    art = pyramid_for(mesh["faces"].astype(np.int64), COCO, cfg["levels"])
    ref = build_ref_pyramid(mesh["faces"], js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    assert ref.sizes == [op.num_vertices for op in art.mesh_ops]
    assert [op.kind for op in art.mesh_ops] == [
        "band" if v > cfg["dense_threshold"] else "dense" for v in ref.sizes]
    assert cfg["coarse_vertices"] == ref.sizes[-1]
    for op, nnz in zip(art.mesh_ops, ref.nnz):
        t = op.band_val if op.kind == "band" else op.dense
        assert int(torch.count_nonzero(t)) == nnz


def test_train_loader_runs_end_to_end():
    cell, res, ok = _run(trace=True)
    assert _correct(res), res["checks"]
    run = res["run"]
    assert run.kind == "train" and res["attempted"] == len(run.loader_wait) >= 1
    assert len(run.window.dispatch) == res["attempted"]
    assert run.trace is not None and run.trace.steps == cell.traffic["trace_steps"]
    assert load_metric("loader_wait_ms.train").read(run) > 0
    got = harness.read_metrics(run, cell.end_to_end)
    assert set(got) == {"setup_s", "train_samples_per_s"}
    assert {"loader_wait_ms.train", "dispatch_ms.train", "mfu.train"} <= set(
        harness.read_metrics(run, cell.per_layer))


class _Wrap:
    def __init__(self, inner, step):
        self.inner, self._step = inner, step

    def __getattr__(self, k):
        return getattr(self.inner, k)

    def step(self, batch):
        return self._step(self.inner, batch)


def _broken(step):
    """Factories of the port's data layer and of its train step on the
    datasets' pyramid, broken by `step`."""
    held = {}

    def data_factory(*a):
        held["data"] = LoaderData(*a)
        return held["data"]

    def train_factory(*a):
        d = held["data"]
        return _Wrap(TrainSystem(*a, art=d.graph, j_regressor=d.target_regressor), step)
    return {"data_factory": data_factory, "train_factory": train_factory}


def test_train_loader_state_left_unchanged():
    def frozen(inner, batch):
        saved = {k: p.detach().clone() for k, p in inner.model.named_parameters()}
        losses = inner.step(batch)
        with torch.no_grad():
            for k, p in inner.model.named_parameters():
                p.copy_(saved[k])
        return losses
    _, res, ok = _run(**_broken(frozen))
    assert not _correct(res) and not ok["change_gap"]


def test_train_loader_half_the_batch_left_out():
    def half(inner, batch):
        h = batch["pose2d"].shape[0] // 2
        return inner.step({k: v[:h] for k, v in batch.items()})
    _, res, ok = _run(**_broken(half))
    assert not _correct(res) and not ok["lift_loss_gap"]


def test_train_loader_loss_altered_where_produced():
    def off(inner, batch):
        losses = inner.step(batch)
        return dict(losses, total=losses["total"] * 1.2)
    _, res, ok = _run(**_broken(off))
    assert not _correct(res) and not ok["loss_gap"]


def test_train_loader_targets_mixed_where_produced():
    _, res, ok = _run(data_factory=RolledTargets)
    assert not _correct(res) and not ok["target_gap_mm"]
    assert all(v for k, v in ok.items() if k != "target_gap_mm")


def test_train_loader_fp8_control_is_not_correct():
    _, res, ok = _run(train_factory=RefTrain)
    assert not _correct(res)
