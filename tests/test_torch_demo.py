"""PyTorch port: the demo, the camera fit, the renderer and the drawings
against the JAX package (CPU, float32).

`fit_camera` (batched over persons, Adam written out) against the JAX fit
(optax.adam in a lax.fori_loop, vmapped): 100 steps within 1e-5 and the
full 1500 within 1e-3, and every fit's reprojection error equal within
1e-2 px.  The loss is an L1, whose gradient is a sum of signs: once the fit
nears the optimum a residual that differs in its last bit between the two
summation orders can flip a sign, and at lr 0.1 the two trajectories part
(on these inputs from step ~120; at step 200 they differ by up to 2.5e-2)
until the schedule's lr 0.001 from step 1000 draws them together again
(at most 4.3e-4 apart after 1500 steps).  `render_mesh_overlay` and
`_nms_people` bit-equal.  `cli.demo.main` at full SMPL width (stand-in
mesh, the datasets' 9-level graph, PoseNet 4096, batch 1) from one
reference-schema checkpoint in both packages: the .obj meshes within 1e-4
(relative L2).
"""
import json
import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.synthetic import uv_sphere
from pose2mesh_release_tpu.cli import demo as jax_demo
from pose2mesh_release_tpu.data import base as jax_base
from pose2mesh_release_tpu.models import camera as jax_camera
from pose2mesh_release_tpu.utils.renderer import render_mesh_overlay as jax_render
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.cli import demo
from pose2mesh_release_tpu_torch.data import base
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
from pose2mesh_release_tpu_torch.models import camera
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.utils.renderer import render_mesh_overlay
from pose2mesh_release_tpu_torch.utils.vis import vis_2d_pose, vis_3d_pose

from test_torch_artifact import fixed_eigsh_start


def _camera_case(seed, persons=3):
    rng = np.random.default_rng(seed)
    j3d = (rng.standard_normal((persons, 17, 3)) * 0.3).astype(np.float32)
    cams = np.stack([rng.uniform(1.0, 2.2, persons), rng.uniform(-0.3, 0.3, persons),
                     rng.uniform(-0.3, 0.3, persons)], 1).astype(np.float32)
    target = np.asarray(jax_camera.project_weak(jnp.asarray(j3d), jnp.asarray(cams), 500.0))
    return j3d, (target + rng.standard_normal(target.shape) * 3).astype(np.float32)


@pytest.mark.parametrize("steps,tol", [(100, 1e-5), (1500, 1e-3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_camera_matches_jax(seed, steps, tol):
    j3d, target = _camera_case(seed)
    want = np.asarray(jax_camera.fit_camera(jnp.asarray(j3d), jnp.asarray(target),
                                            num_steps=steps, img_res=500.0))
    got = camera.fit_camera(j3d, target, num_steps=steps, img_res=500.0, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    one = camera.fit_camera(j3d[1], target[1], num_steps=steps, img_res=500.0, device="cpu")
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=tol, atol=tol)

    def reproj(cam):
        p = camera.project_weak(torch.from_numpy(j3d), torch.as_tensor(np.array(cam)), 500.0)
        return (p - torch.from_numpy(target)).abs().mean((-2, -1)).numpy()
    np.testing.assert_allclose(reproj(got), reproj(want), atol=1e-2)
    np.testing.assert_allclose(
        camera.project_weak(torch.from_numpy(j3d), got, 500.0).numpy(),
        np.asarray(jax_camera.project_weak(jnp.asarray(j3d), jnp.asarray(got.numpy()), 500.0)),
        rtol=1e-6, atol=1e-4)


def test_camera_params_match_jax():
    cam, bbox = np.float32([1.7, 0.2, -0.3]), np.float32([100.0, 50.0, 400.0, 400.0])
    assert camera.cam_to_pixel_params(cam, 500.0) == jax_camera.cam_to_pixel_params(cam, 500.0)
    assert camera.crop_cam_to_orig_params(cam, bbox) == \
        jax_camera.crop_cam_to_orig_params(cam, bbox)


def test_renderer_bit_equal_to_jax():
    v, f = uv_sphere(110)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (64, 80, 3), dtype=np.uint8)
    verts = (v * 0.5 + rng.standard_normal(v.shape) * 0.02).astype(np.float32)
    for cam in (np.array([40.0, 32.0, 30.0]), np.array([25.0, 50.0, 20.0])):
        np.testing.assert_array_equal(render_mesh_overlay(img, verts, f, cam),
                                      jax_render(img, verts, f, cam))


def _detections(rng):
    base_kp = np.concatenate([rng.uniform(100, 300, (17, 2)), np.full((17, 1), 0.9)], 1)
    return [
        {"keypoints": base_kp.flatten().tolist()},
        {"keypoints": (base_kp + [3.0, 2.0, -0.1]).flatten().tolist()},   # duplicate box
        {"keypoints": (base_kp + [400.0, 0.0, -0.3]).flatten().tolist()},  # second person
        {"keypoints": (base_kp * [1, 1, 0.05]).flatten().tolist()},        # low confidence
    ]


def test_nms_people_bit_equal_to_jax():
    dets = _detections(np.random.default_rng(2))
    got, want = demo._nms_people(dets), jax_demo._nms_people(dets)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_drawings_write_png(tmp_path):
    """vis_2d_pose / vis_3d_pose write 8-bit RGB PNGs that decode to the
    drawing they return."""
    import matplotlib.image as mpimg
    pose = np.random.default_rng(3).uniform(50, 350, (17, 3))
    drawn = vis_2d_pose(pose, (400, 500), HUMAN36.skeleton)
    path = vis_2d_pose(pose, (400, 500), HUMAN36.skeleton, out_path=str(tmp_path / "a.png"))
    np.testing.assert_array_equal((mpimg.imread(path) * 255).round().astype(np.uint8), drawn)
    assert drawn.shape == (400, 500, 3) and (drawn != 255).any()
    path = vis_3d_pose(pose, HUMAN36.skeleton, out_path=str(tmp_path / "b.png"))
    assert mpimg.imread(path).shape == (480, 480, 3)


def _read_obj(path):
    return np.array([[float(x) for x in l.split()[1:]] for l in open(path)
                     if l.startswith("v ")], np.float32)


def test_demo_mesh_matches_jax(tmp_path, monkeypatch):
    """cli.demo.main on a 17-joint .npy with --joint_set human36, --device
    cpu, 50 camera steps, from one reference-schema checkpoint (random
    weights, PoseNet 4096) in both packages: the .obj mesh (6890 finite
    vertices) within 1e-4 relative L2 of the JAX demo's.  The JAX cascade's band convs run through its plain path
    (use_pallas=False), as the JAX package's CPU tests run them."""
    import functools

    from pose2mesh_release_tpu.body import smpl as jax_smpl
    from pose2mesh_release_tpu.models import pose2mesh as jax_pose2mesh
    from pose2mesh_release_tpu_torch.body import smpl as port_smpl
    monkeypatch.setattr(jax_pose2mesh, "Pose2Mesh",
                        functools.partial(jax_pose2mesh.Pose2Mesh, use_pallas=False))
    # one pair of joint regressors for both demos (the JAX package's own
    # stand-ins are seeded per process)
    smpl = SMPL()
    for rel, reg in (("Human36M/J_regressor_h36m_correct.npy", smpl.joint_regressor_h36m),
                     ("COCO/J_regressor_coco.npy", smpl.joint_regressor_coco)):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        np.save(tmp_path / rel, reg)
    for mod in (jax_smpl, port_smpl):
        monkeypatch.setattr(mod, "SMPL", functools.partial(mod.SMPL, data_dir=str(tmp_path)))
    jax_base.clear_pyramid_cache()
    base.clear_pyramid_cache()
    with fixed_eigsh_start():
        art = base.pyramid_for(smpl.face, HUMAN36, 9)
        jax_base.pyramid_for(np.asarray(smpl.face), jax_base.get_joint_set("human36"), 9)
    model = Pose2Mesh(17, art.mesh_ops[-1].num_vertices, inference_fused=False,
                      device="cpu", generator=torch.Generator().manual_seed(11))
    ckpt = str(tmp_path / "w.pth.tar")
    torch.save({"epoch": 1, "model_state_dict": {f"module.{k}": v for k, v in
                                                 model.state_dict().items()}}, ckpt)
    joints = smpl.joint_regressor_h36m @ smpl.v_template
    pose = np.float32(joints[:, :2] * [-400.0, -400.0] + [500.0, 500.0])
    np.save(tmp_path / "pose.npy", pose)
    try:
        outs = {}
        for side, main in (("jax", jax_demo.main), ("port", demo.main)):
            out_dir = str(tmp_path / side)
            argv = ["--input_pose", str(tmp_path / "pose.npy"), "--joint_set", "human36",
                    "--weights", ckpt, "--cam_steps", "50", "--out_dir", out_dir]
            res = main(argv + (["--device", "cpu"] if side == "port" else []))
            outs[side] = _read_obj(osp.join(out_dir, "person_0.obj"))
            assert osp.exists(osp.join(out_dir, "person_0_pose2d.png"))
    finally:
        jax_base.clear_pyramid_cache()
        base.clear_pyramid_cache()
    got, want = outs["port"], outs["jax"]
    assert got.shape == want.shape == (6890, 3) and np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    assert len(res["people"]) == 1 and len(res["people"][0]["cam"]) == 3


def test_demo_coco_detections_cpu(tmp_path):
    """The multi-person path of the port's demo on the CPU: a COCO
    detections .json (two people after NMS), pelvis and neck completed,
    random weights: two .obj files of 6890 finite vertices and their
    drawings."""
    dets = _detections(np.random.default_rng(4))
    path = tmp_path / "dets.json"
    path.write_text(json.dumps(dets))
    res = demo.main(["--input_pose", str(path), "--joint_set", "coco", "--cam_steps", "20",
                     "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert len(res["people"]) == 2
    for i, person in enumerate(res["people"]):
        mesh = _read_obj(person["obj"])
        assert mesh.shape == (6890, 3) and np.isfinite(mesh).all()
        assert np.isfinite(person["cam"]).all()
        assert osp.exists(osp.join(tmp_path, "out", f"person_{i}_pose2d.png"))
