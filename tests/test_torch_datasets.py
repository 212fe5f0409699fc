"""PyTorch port: the seven datasets against the JAX package (CPU).

Each dataset reads annotation files the fixtures write, in the JSON layouts
(and at the sizes) of tests/test_data.py's fixtures.  Both packages' SMPL
read their H36M and COCO regressors from `.npy` files written into a data
directory, so the JAX package's hash-seeded stand-ins play no part.  Per
dataset split:

  * the datalist, gt_mesh, gt_reg3d and fit_error within 1e-4 mm plus four
    float32 ulps of the camera-frame coordinate the value was rounded at
    (the meshes are synthesized 4-5 m from the camera, where one ulp is
    4.9e-4 mm, and the two LBS round differently); COCO's fit error, in
    pixels of a 64 x 64 crop, within 1e-4 relative;
  * `__getitem__` from the same seeds: relative L2 <= 1e-5 per tensor;
  * `compute_both_err`, `evaluate` and `evaluate_joint` on the same
    prediction arrays within 1e-6 relative (FreiHAND: the pred.json dumps).
"""
import json

import numpy as np
import pytest

from pose2mesh_release_tpu.body.mano import MANO as JaxMANO
from pose2mesh_release_tpu.body.smpl import SMPL as JaxSMPL
from pose2mesh_release_tpu.data import get_dataset_class as jax_dataset_class
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data import get_dataset_class

N_SAMPLES = 6  # tests/test_data.py's records per subject
REGRESSORS = {"Human36M/J_regressor_h36m_correct.npy": 21,
              "COCO/J_regressor_coco.npy": 22}


# ---- annotation writers (tests/test_data.py's layouts) ----------------------

def _dump(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj))


def local_regressor(template, num_joints, seed, k=8):
    """(num_joints, V) regressor whose rows average k neighbouring vertices
    of the template around random centres, so the joints spread over the
    body as the real regressors' do (the w ** 8 stand-ins put every joint
    within a few cm of the centroid)."""
    rng = np.random.default_rng(seed)
    centres = rng.choice(len(template), num_joints, replace=False)
    dist = ((template[None] - template[centres][:, None]) ** 2).sum(-1)
    near = np.argsort(dist, axis=1)[:, :k]
    w = rng.random((num_joints, k)) + 0.5
    reg = np.zeros((num_joints, len(template)), np.float32)
    reg[np.arange(num_joints)[:, None], near] = w / w.sum(1, keepdims=True)
    return reg


def write_regressors(data_dir):
    """The H36M and COCO regressors both packages' SMPL load (17, 6890)."""
    template = SMPL().v_template
    for rel, seed in REGRESSORS.items():
        (data_dir / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(data_dir / rel, local_regressor(template, 17, seed))


def write_h36m(root, n=N_SAMPLES, subjects=(1, 9, 11), seed=0):
    annot = root / "annotations"
    rng = np.random.default_rng(seed)
    det = {}
    for subject in subjects:
        images, annotations = [], []
        joints = {"2": {"1": {}}}
        smpl_params = {"2": {"1": {}}}
        for i in range(n):
            frame = i * 5  # every frame % 5 == 0 (train sampling ratio)
            name = f"s_{subject:02d}_act_02_subact_01_ca_01_{frame:06d}.jpg"
            images.append({
                "id": i, "file_name": name, "width": 1000, "height": 1000,
                "subject": subject, "action_idx": 2, "subaction_idx": 1,
                "frame_idx": frame, "cam_idx": 1,
            })
            annotations.append({"id": i, "image_id": i,
                                "bbox": [300.0, 300.0, 400.0, 400.0]})
            joints["2"]["1"][str(frame)] = (rng.standard_normal((17, 3)) * 200).tolist()
            smpl_params["2"]["1"][str(frame)] = {
                "pose": (rng.standard_normal(72) * 0.1).tolist(),
                "shape": (rng.standard_normal(10) * 0.5).tolist(),
                "trans": [0.0, 0.0, 0.0],
            }
            det[name] = (rng.random((17, 3)) * 300 + 350).tolist()
        base = f"Human36M_subject{subject}"
        _dump(annot / f"{base}_data.json", {"images": images, "annotations": annotations})
        _dump(annot / f"{base}_camera.json", {"1": {
            "R": np.eye(3).tolist(), "t": [0.0, 0.0, 5000.0],
            "f": [1500.0, 1500.0], "c": [500.0, 500.0]}})
        _dump(annot / f"{base}_joint_3d.json", joints)
        _dump(annot / f"{base}_smpl_param.json", smpl_params)
    # detector input of the test split (absnet_output_on_testset.json)
    _dump(root / "absnet_output_on_testset.json", det)


def write_pw3d(root, n=4, seed=2):
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        images.append({
            "id": i, "file_name": f"image_{i:05d}.jpg", "width": 1920,
            "height": 1080, "sequence": "courtyard_demo_00",
            "cam_param": {"focal": [1960.0, 1969.0], "princpt": [960.0, 540.0]},
        })
        annotations.append({
            "id": i, "image_id": i, "person_id": 0,
            "bbox": [700.0, 200.0, 400.0, 700.0],
            "smpl_param": {
                "pose": (rng.standard_normal(72) * 0.1).tolist(),
                "shape": (rng.standard_normal(10) * 0.3).tolist(),
                "trans": [0.0, 0.0, 4.0],
                "gender": "female" if i % 2 else "male",
            },
            "openpose_result": (rng.random((18, 3)) * 100).flatten().tolist(),
        })
    _dump(root / "3DPW_latest_test.json", {"images": images, "annotations": annotations})
    _dump(root / "darkpose_3dpw_testset_output.json",
          [{"annotation_id": i, "keypoints": (rng.random((17, 3)) * 500).tolist()}
           for i in range(n)])


def write_surreal(root, n=3, seed=4):
    rng = np.random.default_rng(seed)
    images, annotations = [], []
    for i in range(n):
        images.append({
            "id": i, "file_name": f"{i}.jpg", "width": 320, "height": 240,
            "cam_param": {"focal": [600.0, 600.0], "princpt": [160.0, 120.0]},
        })
        annotations.append({
            "id": i, "image_id": i, "bbox": [50.0, 30.0, 180.0, 180.0],
            "joint_cam": (rng.standard_normal((24, 3)) * 100).tolist(),
            "smpl_param": {
                "pose": (rng.standard_normal(72) * 0.1).tolist(),
                "shape": (rng.standard_normal(10) * 0.3).tolist(),
                "trans": [0.0, 0.0, 3.0], "gender": "male",
            },
        })
    _dump(root / "data" / "test.json", {"images": images, "annotations": annotations})


def write_coco(root, n=3, seed=5):
    rng = np.random.default_rng(seed)
    images, annotations, smplify = [], [], {}
    for i in range(n):
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 640, "height": 480})
        kp = np.zeros((17, 3), np.float32)
        kp[:, :2] = rng.random((17, 2)) * 300 + 100
        kp[:, 2] = 2
        annotations.append({
            "id": i, "image_id": i, "iscrowd": 0, "num_keypoints": 17,
            "bbox": [100.0, 100.0, 300.0, 300.0],
            "keypoints": kp.flatten().tolist(),
        })
        smplify[str(i)] = {
            "smpl_param": {"pose": (rng.standard_normal(72) * 0.1).tolist(),
                           "shape": (rng.standard_normal(10) * 0.3).tolist()},
            "cam_param": {"s": [150.0], "t": [250.0, 250.0]},
        }
    _dump(root / "annotations" / "person_keypoints_train2017.json",
          {"images": images, "annotations": annotations})
    _dump(root / "annotations" / "coco_smplify_train.json", smplify)


def write_muco(root, n=2, seed=6):
    rng = np.random.default_rng(seed)
    images, annotations, smpl_params = [], [], {}
    aid = 0
    for i in range(n):
        images.append({"id": i, "file_name": f"{i}.jpg", "width": 2048,
                       "height": 2048, "f": [1500.0, 1500.0], "c": [1024.0, 1024.0]})
        for p in range(2):  # two people; only the closest is kept
            kp_cam = rng.standard_normal((21, 3)) * 200
            kp_cam[:, 2] += 3000 + p * 1000
            annotations.append({
                "id": aid, "image_id": i, "keypoints_cam": kp_cam.tolist(),
                "keypoints_img": (rng.random((21, 2)) * 2000).tolist(),
                "bbox": [500.0, 500.0, 800.0, 800.0],
            })
            smpl_params[str(aid)] = {
                "pose": (rng.standard_normal(72) * 0.1).tolist(),
                "shape": (rng.standard_normal(10) * 0.3).tolist(),
                "trans": [0.0, 0.0, 3.0],
            }
            aid += 1
    _dump(root / "data" / "MuCo-3DHP.json", {"images": images, "annotations": annotations})
    _dump(root / "data" / "smpl_param.json", smpl_params)


def write_amass(root, frames=121, seed=7):
    rng = np.random.default_rng(seed)
    seq = root / "CMU" / "01"
    seq.mkdir(parents=True)
    np.savez(seq / "01_01_poses.npz",
             poses=rng.standard_normal((frames, 156)) * 0.1,
             betas=rng.standard_normal(16) * 0.3,
             trans=rng.standard_normal((frames, 3)),
             dmpls=np.zeros((frames, 8)), gender="male")


def write_freihand(root, n=3, seed=8):
    rng = np.random.default_rng(seed)
    for tag in ("train", "eval"):
        images, annotations, data = [], [], {}
        for i in range(n):
            images.append({"id": i, "file_name": f"rgb/{i:08d}.jpg",
                           "width": 224, "height": 224, "db_idx": i})
            annotations.append({"id": i, "image_id": i,
                                "bbox": [40.0, 40.0, 150.0, 150.0]})
            cam = {"focal": [500.0, 500.0], "princpt": [112.0, 112.0]}
            data[str(i)] = {"cam_param": cam}
            if tag == "train":
                cam.update({"R": np.eye(3).tolist(), "t": [0.0, 0.0, 0.5]})
                data[str(i)].update({
                    "mano_param": {"pose": (rng.standard_normal(48) * 0.1).tolist(),
                                   "shape": (rng.standard_normal(10) * 0.3).tolist()},
                    "joint_3d": (rng.standard_normal((21, 3)) * 50).tolist(),
                })
        _dump(root / f"freihand_{tag}_coco.json", {"images": images, "annotations": annotations})
        _dump(root / f"freihand_{tag}_data.json", data)


WRITERS = {"Human36M": write_h36m, "PW3D": write_pw3d, "SURREAL": write_surreal,
           "COCO": write_coco, "MuCo": write_muco, "AMASS": write_amass,
           "FreiHAND": write_freihand}

# case -> (dataset, split, constructor keywords)
CASES = {
    "h36m_train_human36": ("Human36M", "train", dict(debug=True, input_joint_name="human36")),
    "h36m_train_coco": ("Human36M", "train", dict(debug=True, input_joint_name="coco")),
    "h36m_train_noise_human36": ("Human36M", "train", dict(
        debug=True, input_joint_name="human36", use_gt_input=False)),
    "h36m_train_noise_coco": ("Human36M", "train", dict(
        debug=True, input_joint_name="coco", use_gt_input=False)),
    "h36m_train_posenet": ("Human36M", "train", dict(debug=True, model_name="posenet")),
    "h36m_test": ("Human36M", "test", dict(input_joint_name="human36", protocol=2)),
    "h36m_test_det_coco": ("Human36M", "test", dict(
        input_joint_name="coco", protocol=2, use_gt_input=False)),
    "pw3d_test": ("PW3D", "test", {}),
    "pw3d_test_det": ("PW3D", "test", dict(use_gt_input=False)),
    "surreal_test": ("SURREAL", "test", {}),
    "coco_train": ("COCO", "train", {}),
    "muco_train": ("MuCo", "train", {}),
    "amass_train": ("AMASS", "train", {}),
    "freihand_train": ("FreiHAND", "train", {}),
    "freihand_eval": ("FreiHAND", "test", {}),
}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{dataset name: annotation root}, plus the regressors' data dir."""
    out = {}
    for name, write in WRITERS.items():
        out[name] = tmp_path_factory.mktemp(name.lower())
        write(out[name])
    out["data_dir"] = tmp_path_factory.mktemp("regressors")
    write_regressors(out["data_dir"])
    return out


@pytest.fixture(scope="module")
def body_models(roots):
    """(JAX body model, port body model) per family."""
    d = str(roots["data_dir"])
    return {"smpl": (JaxSMPL(data_dir=d), SMPL(data_dir=d)),
            "mano": (JaxMANO(), MANO())}


@pytest.fixture(scope="module")
def built(roots, body_models, tmp_path_factory):
    """case -> (JAX dataset, port dataset), built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            name, split, kw = CASES[case]
            jm, tm = body_models["mano" if name == "FreiHAND" else "smpl"]
            kw = dict(kw, data_dir=str(roots[name]), build_graph=False)
            if name == "FreiHAND":
                out = tmp_path_factory.mktemp(f"{case}_out")
                kw["output_dir"] = str(out)
            cache[case] = (jax_dataset_class(name)(split, mesh_model=jm, **kw),
                           get_dataset_class(name)(split, mesh_model=tm, device="cpu", **kw))
        return cache[case]

    return get


def camera_atol(values) -> float:
    """1e-4 mm plus four float32 ulps of the largest camera-frame
    coordinate: the GT meshes are rounded at camera distance."""
    return 1e-4 + 4 * float(np.spacing(np.float32(np.abs(values).max() + 5000.0)))


def assert_tree_close(got, want, atol, path="", rtol=0.0):
    """Records equal: arrays within atol (+ rtol), everything else equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_close(got[k], want[k], atol, f"{path}.{k}", rtol)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, f"{path}[{i}]", rtol)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)
    else:
        assert got == want, path


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_matches_jax(case, built):
    jds, tds = built(case)
    assert len(tds) == len(jds) > 0
    atol = camera_atol(jds.gt_mesh)
    for k in ("gt_mesh", "gt_reg3d", "fit_error"):
        want, got = getattr(jds, k), getattr(tds, k)
        if want is None:
            assert got is None, k
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, k
        # COCO's fit error is in pixels of a 64 x 64 crop around the
        # projected joints, whose scale amplifies the rounding
        rtol = 1e-4 if k == "fit_error" and CASES[case][0] == "COCO" else 0.0
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=k)
    assert len(tds.datalist) == len(jds.datalist)
    # the FreiHAND eval split's dummy GT (pose all ones) sits at the camera
    # centre: its projection divides by depths clamped at 1e-6
    rtol = 1e-5 if case == "freihand_eval" else 0.0
    for i, (g, w) in enumerate(zip(tds.datalist, jds.datalist)):
        assert_tree_close(g, w, atol, f"datalist[{i}]", rtol)
    for attr in ("datalist_pose2d_det", "video_indices"):
        if hasattr(jds, attr):
            assert_tree_close(list(getattr(tds, attr)), list(getattr(jds, attr)), atol)


def _flat(sample):
    """(inputs, targets, meta) -> one dict; PoseNet's (joint_img,
    joint_cam, valid) likewise."""
    if not isinstance(sample[0], dict):
        return dict(zip(("joint_img", "joint_cam", "valid"), sample))
    inputs, targets, meta = sample
    return {**inputs, **targets, **meta}


@pytest.mark.parametrize("case", sorted(CASES))
def test_getitem_matches_jax(case, built):
    """Every sample from the same seeds: the datasets' Generator and numpy's
    global generator (augm_params' rotation) seeded alike on both sides."""
    jds, tds = built(case)
    samples = []
    for ds in (jds, tds):
        ds.rng = np.random.default_rng(11)
        np.random.seed(12)
        samples.append([ds[i] for i in range(len(ds))])
    for i, (g, w) in enumerate(zip(*samples[::-1])):
        g, w = _flat(g), _flat(w)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (i, k)
            assert rel_l2(g[k], w[k]) <= 1e-5, (i, k, rel_l2(g[k], w[k]))


def _predictions(jds, seed=3):
    rng = np.random.default_rng(seed)
    return (jds.gt_mesh + rng.standard_normal(jds.gt_mesh.shape) * 5.0).astype(np.float32)


def _close_results(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def _close_dumps(tds, jds):
    """FreiHAND's CodaLab pred.json of both sides: [joints, meshes]."""
    got, want = (json.loads(open(f"{ds.output_dir}/pred.json").read())
                 for ds in (tds, jds))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_matches_jax(case, built):
    jds, tds = built(case)
    pred = _predictions(jds)
    outs = {"mesh_coord": pred, "mesh_coord_target": jds.gt_mesh}
    kw = {"smooth": True} if CASES[case][0] == "PW3D" else {}
    want = jds.evaluate(dict(outs), **kw)
    got = tds.evaluate(dict(outs), **kw)
    _close_results(got, want)
    if CASES[case][0] == "FreiHAND":
        _close_dumps(tds, jds)
    if CASES[case][0] == "PW3D":
        assert "accel_error" in got
    if case == "h36m_test":
        assert any(k.startswith("mpjpe_") for k in got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_joint_and_errors_match_jax(case, built, monkeypatch):
    jds, tds = built(case)
    # evaluate_joint reads its ground truth from the datalist: the same
    # records on both sides
    monkeypatch.setattr(tds, "datalist", jds.datalist)
    pred = _predictions(jds, seed=4)
    reg = jds.target_regressor()
    np.testing.assert_array_equal(tds.target_regressor(), reg)
    pj, gj = (np.einsum("jv,nvc->njc", reg, m) for m in (pred, jds.gt_mesh))
    np.testing.assert_allclose(tds.compute_both_err(pred, jds.gt_mesh, pj, gj),
                               jds.compute_both_err(pred, jds.gt_mesh, pj, gj), rtol=1e-6)
    np.testing.assert_allclose(tds.compute_joint_err(pj, gj),
                               jds.compute_joint_err(pj, gj), rtol=1e-6)
    joints = np.stack([d["joint_cam"] for d in jds.datalist])
    joints = joints + np.random.default_rng(5).standard_normal(joints.shape) * 10.0
    _close_results(tds.evaluate_joint({"joint_coord": joints}),
                   jds.evaluate_joint({"joint_coord": joints}))
    if CASES[case][0] == "FreiHAND":
        _close_dumps(tds, jds)


def test_evaluate_vis_dumps_same_objs(built, tmp_path):
    """evaluate(vis_dir=...): every 500th predicted mesh as an .obj in
    meters, the same files as the JAX package's."""
    jds, tds = built("h36m_test")
    outs = {"mesh_coord": _predictions(jds), "mesh_coord_target": jds.gt_mesh}
    for side, ds in (("jax", jds), ("port", tds)):
        ds.evaluate(dict(outs), vis_dir=str(tmp_path / side))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["human36m_0.obj"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    assert (tmp_path / "port" / names[0]).read_text() == \
        (tmp_path / "jax" / names[0]).read_text()
