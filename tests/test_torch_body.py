"""PyTorch port: the body models and GT synthesis against the JAX package
(CPU, float32).

Bit-equal: the synthetic stand-ins at the SMPL and MANO shapes and the
SMPL and MANO wrappers' regressors (H36M and COCO loaded from a data
directory the test writes).  Within float32 rounding: rodrigues and LBS
(rtol 1e-5, atol 1e-6) with a rest-pose mean and a translation;
`mat2axisang`, the posed meshes, `project_perspective` and `batched_gt`
with a padded tail (1e-3 mm, or 1e-6 of the largest coordinate where
that is more).  The loader reads a .pkl the test writes
with a stub `chumpy` class, as the licensed files embed chumpy arrays.
"""
import dataclasses
import pickle
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pose2mesh_release_tpu.body import loader as jax_loader
from pose2mesh_release_tpu.body import model as jax_model
from pose2mesh_release_tpu.body import synthetic as jax_synthetic
from pose2mesh_release_tpu.body.mano import MANO as JaxMANO
from pose2mesh_release_tpu.body.smpl import SMPL as JaxSMPL
from pose2mesh_release_tpu.data import gt_synth as jax_gt
from pose2mesh_release_tpu_torch.body import loader, model, synthetic
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data import gt_synth

PARAM_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights",
                "faces", "pose_mean")


def assert_params_equal(got, want):
    assert got.parents == tuple(int(p) for p in want.parents)
    for f in PARAM_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("shape", [
    dict(num_vertices=6890, num_joints=24, seed=0),
    dict(num_vertices=6890, num_joints=24, seed=2),
    dict(num_vertices=778, num_joints=16, seed=7, scale=0.1),
])
def test_synthetic_body_params_bit_equal(shape):
    assert_params_equal(synthetic.synthetic_body_params(**shape),
                        jax_synthetic.synthetic_body_params(**shape))


def test_smpl_wrapper_regressors_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    for rel in ("Human36M/J_regressor_h36m_correct.npy", "COCO/J_regressor_coco.npy"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(tmp_path / rel, rng.random((17, 6890)))
    got, want = SMPL(data_dir=str(tmp_path)), JaxSMPL(data_dir=str(tmp_path))
    for name in ("joint_regressor", "joint_regressor_smpl", "joint_regressor_h36m",
                 "joint_regressor_human36", "joint_regressor_coco"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.joint_regressor.shape == (29, 6890)
    np.testing.assert_array_equal(got.face, want.face)
    for gender in ("neutral", "male", "female"):
        assert_params_equal(got.layer(gender), want.layer(gender))
    np.testing.assert_array_equal(got.v_template, want.layer().v_template)
    assert (got.joint_num, got.flip_pairs, got.skeleton) == \
        (want.joint_num, want.flip_pairs, want.skeleton)
    # without a data directory: the fixed-seed stand-ins, the same in every
    # process (the JAX package seeds its own with the salted hash(rel))
    plain = SMPL()
    for name in ("joint_regressor_h36m", "joint_regressor_coco"):
        reg = getattr(plain, name)
        assert reg.shape == (17, 6890) and reg.dtype == np.float32
        np.testing.assert_allclose(reg.sum(1), 1.0, rtol=1e-5)
    assert not np.array_equal(plain.joint_regressor_h36m, plain.joint_regressor_coco)


def test_mano_wrapper_bit_equal():
    got, want = MANO(), JaxMANO()
    assert_params_equal(got.params, want.params)
    assert got.params.parents == (0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
    for name in ("joint_regressor", "joint_regressor_mano"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == (21, 778) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.face, want.face)
    assert (got.hori_conn, got.skeleton, got.root_joint_idx) == \
        (want.hori_conn, want.skeleton, want.root_joint_idx)


def _small_params(pose_mean: bool):
    p = synthetic.synthetic_body_params(num_vertices=62, num_joints=6, seed=3, scale=0.5)
    if pose_mean:
        rng = np.random.default_rng(5)
        p = dataclasses.replace(
            p, pose_mean=(rng.standard_normal(15) * 0.3).astype(np.float32))
    return p


def test_rodrigues_matches_jax():
    rng = np.random.default_rng(1)
    aa = (rng.standard_normal((4, 5, 3)) * 1.5).astype(np.float32)
    aa[0, 0] = 0.0  # the zero-angle limit
    got = model.rodrigues(torch.from_numpy(aa))
    want = jax_model.rodrigues(jnp.asarray(aa))
    assert got.shape == (4, 5, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pose_mean", [False, True])
@pytest.mark.parametrize("trans", [False, True])
def test_lbs_forward_matches_jax(pose_mean, trans):
    params = _small_params(pose_mean)
    rng = np.random.default_rng(2)
    pose = (rng.standard_normal((3, 18)) * 0.5).astype(np.float32)
    betas = rng.standard_normal((3, 10)).astype(np.float32)
    t = rng.standard_normal((3, 3)).astype(np.float32) if trans else None
    got = model.lbs_forward(params, torch.from_numpy(pose), torch.from_numpy(betas),
                            None if t is None else torch.from_numpy(t))
    # the same with the parameters as tensors
    got_t = model.lbs_forward(params.to("cpu"), torch.from_numpy(pose),
                              torch.from_numpy(betas),
                              None if t is None else torch.from_numpy(t))
    want = jax_model.lbs_forward(params, jnp.asarray(pose), jnp.asarray(betas),
                                 None if t is None else jnp.asarray(t))
    for name, g, gt_, w in zip(("verts", "joints"), got, got_t, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        torch.testing.assert_close(gt_, g, rtol=0, atol=0)
    assert got[0].shape == (3, 62, 3) and got[1].shape == (3, 6, 3)


def _rotations(n, rng):
    """n random rotation matrices, with the identity and a rotation by pi."""
    aa = rng.standard_normal((n, 3))
    aa /= np.linalg.norm(aa, axis=1, keepdims=True)
    aa *= rng.uniform(0.1, 3.0, (n, 1))
    aa[0] = 0.0
    aa[1] = np.array([0.0, np.pi, 0.0])
    return np.array(jax_model.rodrigues(jnp.asarray(aa.astype(np.float32))))


def test_mat2axisang_matches_jax():
    R = _rotations(16, np.random.default_rng(3))
    got = gt_synth.mat2axisang(torch.from_numpy(R))
    want = jax_gt.mat2axisang(jnp.asarray(R))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _gt_inputs(B, J, rng):
    return dict(
        pose=(rng.standard_normal((B, J * 3)) * 0.3).astype(np.float32),
        shape=(rng.standard_normal((B, 10)) * 2.0).astype(np.float32),
        trans=rng.standard_normal((B, 3)).astype(np.float32),
        R=_rotations(B, rng),
        t=(rng.standard_normal((B, 3)) * 100 + np.array([0, 0, 3000])).astype(np.float32))


def _close_mm(got, want, name):
    """Every coordinate within 1e-3 mm, or within 1e-6 of the largest
    coordinate where that is more: float32's spacing at 3000 mm (the camera
    distance) is 2.4e-4 mm, and a 24-joint chain rotated near pi moves the
    two frameworks' results about ten spacings apart."""
    got, want = np.asarray(got), np.asarray(want)
    atol = max(1e-3, 1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=name)


def test_posed_meshes_match_jax():
    params = synthetic.synthetic_body_params(num_vertices=482, num_joints=24, seed=4)
    jparams = jax_synthetic.synthetic_body_params(num_vertices=482, num_joints=24, seed=4)
    a = _gt_inputs(5, 24, np.random.default_rng(4))
    a["shape"][1, 3] = 4.0  # |beta| > 3: the H36M path resets to the mean shape
    T = {k: torch.from_numpy(v) for k, v in a.items()}
    J = {k: jnp.asarray(v) for k, v in a.items()}
    cases = {
        "cam": (gt_synth.posed_mesh_cam(params, T["pose"], T["shape"], T["trans"], T["R"],
                                        T["t"]),
                jax_gt.posed_mesh_cam(jparams, J["pose"], J["shape"], J["trans"], J["R"],
                                      J["t"])),
        "rotated": (gt_synth.posed_mesh_rotated(params, T["pose"], T["shape"], T["R"],
                                                T["t"]),
                    jax_gt.posed_mesh_rotated(jparams, J["pose"], J["shape"], J["R"],
                                              J["t"])),
        "world": (gt_synth.posed_mesh_world(params, T["pose"], T["shape"], T["trans"]),
                  jax_gt.posed_mesh_world(jparams, J["pose"], J["shape"], J["trans"])),
    }
    for name, (got, want) in cases.items():
        for part, g, w in zip(("mesh", "joints"), got, want):
            _close_mm(g, w, f"{name} {part}")
    reg = np.random.default_rng(5).random((17, 482)).astype(np.float32)
    mesh_t, mesh_j = cases["cam"][0][0], cases["cam"][1][0]
    joints_t = gt_synth.regress_joints(torch.from_numpy(reg), mesh_t)
    joints_j = jax_gt.regress_joints(jnp.asarray(reg), mesh_j)
    _close_mm(joints_t, joints_j, "regress_joints")
    _close_mm(gt_synth.add_pelvis_and_neck(joints_t, 1, 4, 11, 14),
              jax_gt.add_pelvis_and_neck(joints_j, 1, 4, 11, 14), "pelvis and neck")
    focal = np.array([[1145.0, 1144.0]] * 5, np.float32)
    princpt = np.array([[512.0, 515.0]] * 5, np.float32)
    cam = joints_t.numpy().copy()
    cam[0, 0, 2] = 0.0  # a joint at z = 0
    _close_mm(gt_synth.project_perspective(torch.from_numpy(cam), torch.from_numpy(focal),
                                           torch.from_numpy(princpt)),
              jax_gt.project_perspective(jnp.asarray(cam), jnp.asarray(focal),
                                         jnp.asarray(princpt)), "projection")


def test_batched_gt_padded_tail_matches_jax():
    """11 records in chunks of 4: the last chunk is padded with its last
    record and cut back."""
    params = synthetic.synthetic_body_params(num_vertices=98, num_joints=16, seed=6)
    jparams = jax_synthetic.synthetic_body_params(num_vertices=98, num_joints=16, seed=6)
    a = _gt_inputs(11, 16, np.random.default_rng(6))
    arrays = (a["pose"], a["shape"], a["R"], a["t"])
    tp = params.to("cpu")
    got = gt_synth.batched_gt(lambda *c: gt_synth.posed_mesh_rotated(tp, *c), arrays,
                              batch=4, device="cpu")
    want = jax_gt.batched_gt(lambda *c: jax_gt.posed_mesh_rotated(jparams, *c), arrays,
                             batch=4)
    for name, g, w in zip(("mesh", "joints"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        _close_mm(g, w, name)
    # one output, not a tuple
    single = gt_synth.batched_gt(lambda *c: gt_synth.posed_mesh_rotated(tp, *c)[1],
                                 arrays, batch=4, device="cpu")
    np.testing.assert_array_equal(single, got[1])


def test_batched_gt_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    arrays = (np.zeros((2, 3), np.float32),)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt_synth.batched_gt(lambda x: x, arrays, batch=2)
    out = gt_synth.batched_gt(lambda x: x * 2, arrays, batch=2, device="cpu")
    np.testing.assert_array_equal(out, arrays[0])


# ---- the .pkl loader ------------------------------------------------------

def _write_pkl(path, d, monkeypatch):
    """Pickle `d` with its arrays wrapped in a class of a module named
    `chumpy.ch`, as the licensed files store them."""
    mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x
    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    mod.Ch = Ch
    monkeypatch.setitem(sys.modules, "chumpy", types.ModuleType("chumpy"))
    monkeypatch.setitem(sys.modules, "chumpy.ch", mod)
    wrapped = {k: Ch(v) if k in ("v_template", "shapedirs", "posedirs") else v
               for k, v in d.items()}
    with open(path, "wb") as f:
        pickle.dump(wrapped, f, protocol=2)


def _pkl_dict(num_vertices, num_joints, seed):
    p = jax_synthetic.synthetic_body_params(num_vertices=num_vertices,
                                            num_joints=num_joints, seed=seed)
    parents = np.asarray(p.parents).copy()
    parents[0] = -1  # the files store the root's parent as -1 (as uint32 max)
    V = num_vertices
    return {"v_template": p.v_template.astype(np.float64),
            "shapedirs": p.shapedirs.astype(np.float64),
            "posedirs": p.posedirs.reshape(V, 3, -1).astype(np.float64),
            "J_regressor": sp.csc_matrix(p.J_regressor.astype(np.float64)),
            "weights": p.lbs_weights.astype(np.float64),
            "kintree_table": np.stack([parents, np.arange(num_joints)]),
            "f": p.faces.astype(np.uint32)}


def test_loader_reads_chumpy_pickles_as_jax(tmp_path, monkeypatch):
    d = _pkl_dict(62, 24, 8)
    _write_pkl(tmp_path / "basicModel_neutral_lbs_10_207_0_v1.0.0.pkl", d, monkeypatch)
    hand = _pkl_dict(98, 16, 9)
    hand["hands_mean"] = np.random.default_rng(9).standard_normal(45)
    _write_pkl(tmp_path / "MANO_RIGHT.pkl", hand, monkeypatch)
    for name in ("chumpy", "chumpy.ch"):  # the loaders need no chumpy
        monkeypatch.delitem(sys.modules, name)

    got = loader.load_smpl_params(str(tmp_path), "neutral")
    assert_params_equal(got, jax_loader.load_smpl_params(str(tmp_path), "neutral"))
    assert got.parents[0] == 0 and got.J_regressor.shape == (24, 62)
    assert loader.load_smpl_params(str(tmp_path), "male") is None
    assert loader.load_smpl_params(None, "neutral") is None

    got = loader.load_mano_params(str(tmp_path))
    assert_params_equal(got, jax_loader.load_mano_params(str(tmp_path)))
    assert got.pose_mean.shape == (45,)
