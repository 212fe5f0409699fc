"""PyTorch port: the data slice as a whole against the JAX package (CPU).

`Trainer`'s default input path: Human36M (COCO 19-joint input), COCO and
MuCo -> `MultipleDatasets(make_same_len=True)` -> `BatchLoader(batch 2,
shuffle, drop_last, num_workers=1)` in both packages gives the same batch
(relative L2 <= 1e-5 per tensor), and one port train step (float32, SGD,
dropout off) on that batch, on the datasets' graph (`pyramid_for`,
dense_threshold 1024), against the JAX `make_train_step` with the
sensitivity-based tolerance of
test_torch_train.py::test_train_step_full_smpl_width_matches_jax.  The
annotation files are those of tests/test_data.py's layouts with joints
made consistent with the stand-in SMPL (joint_3d, COCO keypoints and MuCo
keypoints_cam regressed from the LBS mesh), so every sample keeps its
supervision.  Also the launch plan on the datasets' graph: 8 K1 + 8 K2 per
train step, 6 + 2 group convs per deploy forward.
"""
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.smpl import SMPL as JaxSMPL
from pose2mesh_release_tpu.data import base as jax_base
from pose2mesh_release_tpu.data import get_dataset_class as jax_dataset_class
from pose2mesh_release_tpu.data.loader import BatchLoader as JaxBatchLoader
from pose2mesh_release_tpu.data.mixer import MultipleDatasets as JaxMultipleDatasets
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data import base, get_dataset_class
from pose2mesh_release_tpu_torch.data.gt_synth import posed_mesh_world
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
from pose2mesh_release_tpu_torch.data.loader import BatchLoader
from pose2mesh_release_tpu_torch.data.mixer import MultipleDatasets
from pose2mesh_release_tpu_torch.data.muco import MUCO_JOINTS_NAME
from pose2mesh_release_tpu_torch.deploy import deploy_forward_on
from pose2mesh_release_tpu_torch.models import meshnet
from pose2mesh_release_tpu_torch.ops import fused_cheby_train
from pose2mesh_release_tpu_torch.train_setup import train_batch, train_setup_on

from test_torch_artifact import assert_ops_equal, fixed_eigsh_start
from test_torch_datasets import N_SAMPLES, _dump, write_regressors
from test_torch_pipeline import _assert_batches_close, _batch_dict
from test_torch_train import _run_steps, assert_step_within_sensitivity

MIX = ("Human36M", "COCO", "MuCo")


def _smpl_sample(rng, smpl, trans):
    """Seeded SMPL parameters and their neutral LBS mesh (world, mm)."""
    pose = (rng.standard_normal(72) * 0.1).astype(np.float32)
    shape = (rng.standard_normal(10) * 0.5).astype(np.float32)
    with torch.no_grad():
        mesh, _ = posed_mesh_world(smpl.layer().to("cpu"), torch.from_numpy(pose[None]),
                                   torch.from_numpy(shape[None]),
                                   torch.tensor([trans], dtype=torch.float32))
    return pose, shape, mesh[0].numpy()


def write_consistent(root, smpl, seed=0):
    """Human36M (subject 1), COCO and MuCo annotation files, N_SAMPLES
    records each, with joints regressed from each record's SMPL mesh."""
    rng = np.random.default_rng(seed)
    h36m = root / "Human36M"
    images, annotations = [], []
    joints, params = {"2": {"1": {}}}, {"2": {"1": {}}}
    for i in range(N_SAMPLES):
        frame = i * 5
        pose, shape, mesh = _smpl_sample(rng, smpl, [0.0, 0.0, 0.0])
        images.append({"id": i, "file_name": f"s_01_act_02_subact_01_ca_01_{frame:06d}.jpg",
                       "width": 1000, "height": 1000, "subject": 1, "action_idx": 2,
                       "subaction_idx": 1, "frame_idx": frame, "cam_idx": 1})
        annotations.append({"id": i, "image_id": i, "bbox": [300.0, 300.0, 400.0, 400.0]})
        joints["2"]["1"][str(frame)] = (smpl.joint_regressor_h36m @ mesh).tolist()
        params["2"]["1"][str(frame)] = {"pose": pose.tolist(), "shape": shape.tolist(),
                                        "trans": [0.0, 0.0, 0.0]}
    annot = h36m / "annotations"
    _dump(annot / "Human36M_subject1_data.json", {"images": images, "annotations": annotations})
    _dump(annot / "Human36M_subject1_camera.json", {"1": {
        "R": np.eye(3).tolist(), "t": [0.0, 0.0, 5000.0], "f": [1500.0, 1500.0],
        "c": [500.0, 500.0]}})
    _dump(annot / "Human36M_subject1_joint_3d.json", joints)
    _dump(annot / "Human36M_subject1_smpl_param.json", params)

    images, annotations, smplify = [], [], {}
    for i in range(N_SAMPLES):
        pose, shape, mesh = _smpl_sample(rng, smpl, [0.0, 0.0, 0.0])
        kp = np.full((17, 3), 2.0, np.float32)
        kp[:, :2] = (smpl.joint_regressor_coco @ mesh)[:, :2] / 1000.0 * 150.0 + 250.0
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 640, "height": 480})
        annotations.append({"id": i, "image_id": i, "iscrowd": 0, "num_keypoints": 17,
                            "bbox": [100.0, 100.0, 300.0, 300.0],
                            "keypoints": kp.flatten().tolist()})
        smplify[str(i)] = {"smpl_param": {"pose": pose.tolist(), "shape": shape.tolist()},
                           "cam_param": {"s": [150.0], "t": [250.0, 250.0]}}
    _dump(root / "COCO" / "annotations" / "person_keypoints_train2017.json",
          {"images": images, "annotations": annotations})
    _dump(root / "COCO" / "annotations" / "coco_smplify_train.json", smplify)

    images, annotations, params = [], [], {}
    for i in range(N_SAMPLES):
        pose, shape, mesh = _smpl_sample(rng, smpl, [0.0, 0.0, 3.0])
        h36m_joints = smpl.joint_regressor_h36m @ mesh
        kp_cam = rng.standard_normal((21, 3)) * 200 + [0.0, 0.0, 3000.0]
        for m, name in enumerate(MUCO_JOINTS_NAME):
            if name in HUMAN36.joints_name:
                kp_cam[m] = h36m_joints[HUMAN36.joints_name.index(name)]
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 2048, "height": 2048,
                       "f": [1500.0, 1500.0], "c": [1024.0, 1024.0]})
        annotations.append({"id": i, "image_id": i, "keypoints_cam": kp_cam.tolist(),
                            "keypoints_img": (rng.random((21, 2)) * 2000).tolist(),
                            "bbox": [500.0, 500.0, 800.0, 800.0]})
        params[str(i)] = {"pose": pose.tolist(), "shape": shape.tolist(),
                          "trans": [0.0, 0.0, 3.0]}
    _dump(root / "MuCo" / "data" / "MuCo-3DHP.json", {"images": images, "annotations": annotations})
    _dump(root / "MuCo" / "data" / "smpl_param.json", params)


@pytest.fixture(scope="module")
def mix(tmp_path_factory):
    """(JAX datasets, port datasets) of the mix, graphs built (seeded
    Fiedler start vectors, so both packers order the levels alike)."""
    root = tmp_path_factory.mktemp("slice")
    write_regressors(root / "regressors")
    jsmpl, smpl = (cls(data_dir=str(root / "regressors")) for cls in (JaxSMPL, SMPL))
    write_consistent(root, smpl)
    kw = {"Human36M": dict(debug=True, input_joint_name="coco")}
    jax_base.clear_pyramid_cache()
    base.clear_pyramid_cache()
    with fixed_eigsh_start():
        jdbs = [jax_dataset_class(n)("train", data_dir=str(root / n), mesh_model=jsmpl,
                                     **kw.get(n, {})) for n in MIX]
        tdbs = [get_dataset_class(n)("train", data_dir=str(root / n), mesh_model=smpl,
                                     device="cpu", **kw.get(n, {})) for n in MIX]
    yield jdbs, tdbs
    jax_base.clear_pyramid_cache()
    base.clear_pyramid_cache()


def _first_batches(mix):
    jdbs, tdbs = mix
    loaders = []
    for dbs, mixer, loader, kw in ((jdbs, JaxMultipleDatasets, JaxBatchLoader, {}),
                                   (tdbs, MultipleDatasets, BatchLoader, {"device": "cpu"})):
        for ds in dbs:
            ds.rng = np.random.default_rng(1)
        loaders.append(loader(mixer(dbs, make_same_len=True, seed=2), 2, shuffle=True,
                              drop_last=True, num_workers=1, seed=3, **kw))
    out = []
    for loader in loaders:
        # the whole epoch: no producer thread draws from numpy's global
        # generator (augm_params) after the reseed of the next loader
        np.random.seed(4)
        out.append(list(loader)[0])
    return out


def test_mixed_loader_batch_matches_jax(mix):
    jdbs, tdbs = mix
    for j, t in zip(jdbs, tdbs):
        assert len(t) == len(j) == N_SAMPLES
        assert t.graph is not None and t.graph is tdbs[0].graph  # one cached pyramid
        # joints consistent with the mesh: every sample keeps its supervision
        assert (t.fit_error <= t.fitting_thr).all(), (t.name, t.fit_error)
    want, got = _first_batches(mix)
    _assert_batches_close(got, want)
    batch = _batch_dict(got)
    assert batch["pose2d"].shape == (2, 19, 2) and batch["mesh"].shape == (2, 6890, 3)
    assert float(batch["mesh_valid"].min()) == 1.0


def test_train_step_on_datasets_graph_matches_jax(mix, monkeypatch):
    """One step on the mixed loader's batch, on the datasets' graph: losses
    within rtol 1e-4, each tensor's step within twice the step's measured
    sensitivity to a 1e-6 nudge of the input (see the full-width test)."""
    jdbs, tdbs = mix
    art_j, art_t = jdbs[0].graph, tdbs[0].graph
    assert [op.kind for op in art_t.mesh_ops[:4]] == ["band", "band", "band", "dense"]
    for op, ref in zip(art_t.mesh_ops + (art_t.joint_op,), art_j.mesh_ops + (art_j.joint_op,)):
        assert_ops_equal(op, ref)
    want, _ = _first_batches(mix)
    batch = {k: np.asarray(v) for k, v in train_batch(*want).items()}
    jreg = tdbs[0].target_regressor()
    np.testing.assert_array_equal(jreg, jdbs[0].target_regressor())
    losses, got, want_sd, init, _ = _run_steps(monkeypatch, art_j, art_t, None, 4096, batch,
                                               jreg, 1, lrs=(1.0,))
    t, j = losses[0]
    for k in j:
        np.testing.assert_allclose(np.asarray(t[k]), np.asarray(j[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert_step_within_sensitivity(art_t, batch, jreg, got, want_sd, init)


def test_datasets_graph_launch_plan(mix, monkeypatch):
    """On the datasets' graph (981 dense): 8 K1 + 8 K2 per train step and
    6 + 2 group convs per deploy forward (the kernels' wrappers counted on
    the CPU, where they run their plain versions)."""
    _, tdbs = mix
    art = tdbs[0].graph
    calls = {}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapper)

    for name in ("fused_cheby_conv_train", "fused_cheby_conv_bwd"):
        counted(fused_cheby_train, name)
    for name in ("fused_cheby_conv", "fused_cheby_conv_commuted"):
        counted(meshnet, name)
    want, _ = _first_batches(mix)
    setup = train_setup_on(art, tdbs[0].target_regressor(), train_batch(*want),
                           dtype=torch.float32, device="cpu")
    setup.train_step(setup.state, setup.art_compute, setup.batch, 1e-3, True, setup.generator)
    assert calls == {"fused_cheby_conv_train": 8, "fused_cheby_conv_bwd": 8}
    calls.clear()
    d = deploy_forward_on(art, tdbs[0].target_regressor(), dtype=torch.float32, device="cpu")
    mesh, reg, _ = d.eval_step(d.art_compute, setup.batch["pose2d"])
    assert calls == {"fused_cheby_conv": 6, "fused_cheby_conv_commuted": 2}
    assert mesh.shape == (2, 6890, 3) and reg.shape == (2, 17, 3)
    assert bool(torch.isfinite(mesh).all())
