"""PyTorch port: the host utilities of the data layer against the JAX
package (CPU): `utils/coords.py`, `utils/augment.py`, `utils/smooth.py`,
`utils/io.py`, `data/noise.py` and `data/coco_json.py`.  Both sides are
numpy, so every output is bit-equal on the same seeded inputs and the same
Generator seeds."""
import json
import random

import numpy as np
import pytest

from pose2mesh_release_tpu.data import coco_json as jax_coco_json
from pose2mesh_release_tpu.data import noise as jax_noise
from pose2mesh_release_tpu.utils import augment as jax_augment
from pose2mesh_release_tpu.utils import coords as jax_coords
from pose2mesh_release_tpu.utils import io as jax_io
from pose2mesh_release_tpu.utils import smooth as jax_smooth
from pose2mesh_release_tpu_torch.data import coco_json, noise
from pose2mesh_release_tpu_torch.data.joint_sets import COCO, HUMAN36
from pose2mesh_release_tpu_torch.utils import augment, coords, io, smooth


def _equal(got, want):
    if want is None:
        assert got is None
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _joints(seed, n=19, scale=150.0, offset=300.0):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * scale
            + offset).astype(np.float32)


COORDS_CASES = {
    "get_center_scale": lambda m, rng: m.get_center_scale(
        np.array([10.0, 20.0, 300.0, 150.0], np.float32)),
    "get_bbox": lambda m, rng: m.get_bbox(_joints(1)),
    "process_bbox_wide": lambda m, rng: m.process_bbox(
        np.array([5.0, 7.0, 400.0, 120.0], np.float32), 288 / 384),
    "process_bbox_tall": lambda m, rng: m.process_bbox(
        np.array([5.0, 7.0, 40.0, 520.0], np.float32), 288 / 384, 1.25),
    "process_bbox_empty": lambda m, rng: m.process_bbox(
        np.array([5.0, 7.0, 0.0, 520.0], np.float32), 1.0),
    "cam2pixel": lambda m, rng: m.cam2pixel(
        rng.standard_normal((17, 3)) * 300 + [0, 0, 4000], [1500.0, 1490.0],
        [500.0, 510.0]),
    "world2cam": lambda m, rng: m.world2cam(
        rng.standard_normal((17, 3)), rng.standard_normal((3, 3)), rng.standard_normal(3)),
    "pixel2cam": lambda m, rng: m.pixel2cam(
        rng.random((17, 3)) * 1000, [500.0, 510.0], [1500.0, 1490.0]),
    "rigid_transform_3d": lambda m, rng: m.rigid_transform_3d(
        rng.standard_normal((17, 3)), rng.standard_normal((17, 3))),
    "rigid_align": lambda m, rng: m.rigid_align(
        rng.standard_normal((17, 3)), rng.standard_normal((17, 3))),
    "euler2mat": lambda m, rng: m.euler2mat(rng.standard_normal((4, 5, 3))),
    "compute_error_accel": lambda m, rng: m.compute_error_accel(
        rng.standard_normal((12, 14, 3)), rng.standard_normal((12, 14, 3))),
    "compute_error_accel_vis": lambda m, rng: m.compute_error_accel(
        rng.standard_normal((12, 14, 3)), rng.standard_normal((12, 14, 3)),
        vis=rng.random(12) > 0.3),
}


@pytest.mark.parametrize("case", sorted(COORDS_CASES))
def test_coords_bit_equal(case):
    fn = COORDS_CASES[case]
    _equal(fn(coords, np.random.default_rng(0)), fn(jax_coords, np.random.default_rng(0)))


AUGMENT_CASES = {
    "transform_joint_to_other_db": lambda m, rng: m.transform_joint_to_other_db(
        rng.standard_normal((17, 3)), HUMAN36.joints_name, COCO.joints_name),
    "flip_2d_joint": lambda m, rng: m.flip_2d_joint(
        _joints(2), 288, COCO.flip_pairs),
    "flip_3d_joint": lambda m, rng: m.flip_3d_joint(
        rng.standard_normal((17, 3)), HUMAN36.flip_pairs),
    "get_affine_transform": lambda m, rng: m.get_affine_transform(
        [300.0, 250.0], [200.0, 260.0], 17.5, (288, 384)),
    "get_affine_transform_inv": lambda m, rng: m.get_affine_transform(
        [300.0, 250.0], 220.0, -31.0, (64, 64), inv=True),
    "affine_transform": lambda m, rng: m.affine_transform(
        np.array([120.0, 80.0]), rng.standard_normal((2, 3))),
    "j2d_processing": lambda m, rng: m.j2d_processing(
        _joints(3), (288, 384), np.array([150.0, 120.0, 300.0, 360.0], np.float32),
        23.0, 1, COCO.flip_pairs),
    "j2d_processing_noflip": lambda m, rng: m.j2d_processing(
        _joints(4), (64, 64), np.array([150.0, 120.0, 300.0, 300.0], np.float32),
        0, 0, None),
    "j3d_processing": lambda m, rng: m.j3d_processing(
        rng.standard_normal((17, 3)) * 300, -41.0, 1, HUMAN36.flip_pairs),
    "j3d_processing_mesh": lambda m, rng: m.j3d_processing(
        rng.standard_normal((200, 3)) * 300, 12.0, 0, ()),
}


@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_bit_equal(case):
    fn = AUGMENT_CASES[case]
    _equal(fn(augment, np.random.default_rng(0)), fn(jax_augment, np.random.default_rng(0)))


@pytest.mark.parametrize("is_train", [True, False])
def test_augm_params_same_draws(is_train):
    """augm_params draws its flip from the Generator and its rotation from
    numpy's global generator, as the JAX package does."""
    out = []
    for m in (augment, jax_augment):
        np.random.seed(5)
        rng = np.random.default_rng(3)
        out.append([m.augm_params(is_train, True, 30.0, rng=rng) for _ in range(20)])
    assert out[0] == out[1]


def test_smooth_pose_and_filter_bit_equal():
    rng = np.random.default_rng(6)
    pose = rng.standard_normal((15, 14, 3)).astype(np.float32) * 100
    _equal(smooth.smooth_pose(pose, min_cutoff=0.004, beta=0.005),
           jax_smooth.smooth_pose(pose, min_cutoff=0.004, beta=0.005))
    f, g = (m.OneEuroFilter(0.0, pose[0].reshape(-1), min_cutoff=0.5, beta=0.7)
            for m in (smooth, jax_smooth))
    for t in range(1, 5):
        _equal(f(float(t), pose[t].reshape(-1)), g(float(t), pose[t].reshape(-1)))


def test_save_obj_same_file(tmp_path):
    rng = np.random.default_rng(7)
    verts = rng.standard_normal((30, 3)).astype(np.float32)
    faces = rng.integers(0, 30, (20, 3))
    io.save_obj(verts, faces, str(tmp_path / "a.obj"))
    jax_io.save_obj(verts, faces, str(tmp_path / "b.obj"))
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "b.obj").read_text()


@pytest.mark.parametrize("seed,area,valid", [(0, 2.0e4, 17), (1, 9.0e3, 9), (2, 4.0e4, 4)])
def test_synthesize_pose_bit_equal(seed, area, valid):
    rng = np.random.default_rng(seed)
    joints = np.concatenate([rng.random((17, 2)) * 200 + 50, np.zeros((17, 1))], 1)
    joints[rng.permutation(17)[:valid], 2] = 1.0
    _equal(noise.synthesize_pose(joints, area, rng=np.random.default_rng(seed + 10)),
           jax_noise.synthesize_pose(joints, area, rng=np.random.default_rng(seed + 10)))


def test_h36m_noise_stats_bit_equal():
    a, b = noise.H36MNoiseStats(HUMAN36.joints_name), jax_noise.H36MNoiseStats(
        HUMAN36.joints_name)
    for f in ("mean", "std", "weight"):
        _equal(getattr(a, f), getattr(b, f))
    ra, rb = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        _equal(a.sample(ra), b.sample(rb))


def test_coco_index_same_index(tmp_path):
    rng = random.Random(0)
    paths = []
    for part in range(2):
        images = [{"id": part * 10 + i, "file_name": f"{part}_{i}.jpg"} for i in range(4)]
        anns = [{"id": part * 100 + k, "image_id": part * 10 + rng.randrange(4),
                 "bbox": [1.0, 2.0, 3.0, 4.0]} for k in range(7)]
        p = tmp_path / f"part{part}.json"
        p.write_text(json.dumps({"images": images, "annotations": anns, "info": part}))
        paths.append(str(p))
    a = coco_json.CocoIndex.from_files(paths)
    b = jax_coco_json.CocoIndex.from_files(paths)
    assert a.dataset == b.dataset and a.imgs == b.imgs and a.anns == b.anns
    assert a.img_anns == b.img_anns
    for iid in list(a.imgs) + [999]:
        assert a.anns_of(iid) == b.anns_of(iid)
    assert a.load_img(10) == b.load_img(10)
