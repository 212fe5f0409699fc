"""Stand-in annotation files of the release's three training sets (the
configuration's `train_list`: Human3.6M, COCO 2017 with its SMPLify fits,
MuCo-3DHP), made from the run's seed, in the layouts that the port's
datasets read (the release's `data/<set>/` trees), with the configuration's
frozen H36M and COCO regressors as the release's `.npy` files beside them.

Every sample is one SMPL fit of the stand-in body: a root turned about the
body's long axis (uniform yaw) and tilted (N(0, root_tilt_std^2) radians
about the other two), body joints N(0, body_pose_std^2), betas N(0,
shape_std^2) clipped to +-shape_clip (the traffic file's parameters).  Its
annotated joints are the frozen regressors over the fit's posed mesh
(`joints_of`, the port's stand-in body posed as its GT synthesis poses it),
so every fit agrees with its joints: a sample that a dataset's fit-error
filter invalidates, or whose targets disagree with its mesh, is the
datasets' GT synthesis at fault (the port's Human3.6M synthesis folds the
camera into the root in float32, wrong within about 0.05 rad of a half
turn: PERF.md):

  Human3.6M  subjects 1, 5, 6, 7, 8 (the train split), each frame seen by
             four cameras 5 m away (the world's z up), every fifth frame
             (the train split's sampling); world joints, SMPL fits, cameras.
  COCO       one person an image, 17 keypoints, the fit's weak-perspective
             camera (s, t) that projects them.
  MuCo       one person an image in its camera's frame, 21 joints in
             MuCo's order, 3.5-5.5 m from the camera.

Values are rounded before the joints are posed from them, so the files hold
the fits the joints come from.
"""
from __future__ import annotations

import json
import math
import os
from typing import Callable, Dict, List, Tuple

import numpy as np
from scipy.spatial.transform import Rotation

from .weights import sub_seed

__all__ = ["write_annotations", "H36M_CAMERAS"]

H36M_SUBJECTS = (1, 5, 6, 7, 8)
H36M_CAMERAS = 4
H36M_ACTIONS = 15            # action_idx 2..16, two subactions each
H36M_FRAME_STEP = 5          # the train split keeps frame_idx % 5 == 0
H36M_IMAGE = (1000, 1002)    # width, height
H36M_F, H36M_C = (1145.0, 1144.0), (512.0, 515.0)
H36M_DEPTH_MM = 5000.0
COCO_IMAGE = (640, 480)
MUCO_IMAGE = (2048, 2048)
MUCO_F, MUCO_C = (1500.0, 1500.0), (1024.0, 1024.0)
# MuCo's 21 joints (Head_top, Thorax, R_Shoulder, R_Elbow, R_Wrist, L_Shoulder,
# L_Elbow, L_Wrist, R_Hip, R_Knee, R_Ankle, L_Hip, L_Knee, L_Ankle, Pelvis,
# Spine, Head, R_Hand, L_Hand, R_Toe, L_Toe) from the H36M joints (Pelvis,
# R_Hip, R_Knee, R_Ankle, L_Hip, L_Knee, L_Ankle, Torso, Neck, Nose, Head,
# L_Shoulder, L_Elbow, L_Wrist, R_Shoulder, R_Elbow, R_Wrist): the joints both
# sets name are equal, the others (which no fit check reads) their nearest
MUCO_FROM_H36M = (10, 8, 14, 15, 16, 11, 12, 13, 1, 2, 3, 4, 5, 6, 0, 7, 10, 16, 13, 3, 6)
# the world's (or a body's) z up, as a camera sees it: x right, y down, z ahead
Z_UP_TO_CAMERA = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
REGRESSOR_FILES = {"j_regressor": ("Human36M", "J_regressor_h36m_correct.npy"),
                   "coco_regressor": ("COCO", "J_regressor_coco.npy")}


def _round(a: np.ndarray, decimals: int) -> np.ndarray:
    return np.round(np.asarray(a, np.float64), decimals)


def _rot_z(angle: np.ndarray) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    R = np.zeros(angle.shape + (3, 3))
    R[..., 0, 0], R[..., 0, 1], R[..., 1, 0], R[..., 1, 1] = c, -s, s, c
    R[..., 2, 2] = 1.0
    return R


def _fits(rng: np.random.Generator, n: int, traffic: Dict, upright: bool
          ) -> Tuple[np.ndarray, np.ndarray]:
    """n SMPL fits: pose (n, 72) with its root turned and tilted (and, for a
    camera's frame, stood up: the body's z to the camera's -y), betas (n,
    10)."""
    yaw = rng.uniform(-math.pi, math.pi, n)
    tilt = np.zeros((n, 3))
    tilt[:, :2] = rng.standard_normal((n, 2)) * float(traffic["root_tilt_std"])
    R = _rot_z(yaw) @ Rotation.from_rotvec(tilt).as_matrix()
    if upright:
        R = Z_UP_TO_CAMERA @ R
    body = rng.standard_normal((n, 69)) * float(traffic["body_pose_std"])
    pose = np.concatenate([Rotation.from_matrix(R).as_rotvec(), body], axis=1)
    clip = float(traffic["shape_clip"])
    shape = np.clip(rng.standard_normal((n, 10)) * float(traffic["shape_std"]), -clip, clip)
    return _round(pose, 5), _round(shape, 5)


def _bbox(xy: np.ndarray, pad: float = 1.2) -> List[float]:
    lo, hi = xy.min(0), xy.max(0)
    c, size = (lo + hi) / 2, (hi - lo) * pad
    return _round(np.concatenate([c - size / 2, size]), 3).tolist()


def _project(cam_mm: np.ndarray, f, c) -> np.ndarray:
    return cam_mm[..., :2] / cam_mm[..., 2:] * np.asarray(f) + np.asarray(c)


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, separators=(",", ":"))


def write_annotations(root: str, counts: Dict[str, int], traffic: Dict,
                      mesh: Dict[str, np.ndarray], seed: int,
                      joints_of: Callable[..., np.ndarray]) -> None:
    """Writes the sets of `counts` ({set name: samples}; Human3.6M's a
    multiple of its four cameras) under `root`/<set name>/.  joints_of(
    regressor (R, V), pose (N, 72), shape (N, 10), trans (N, 3) metres) ->
    (N, R, 3) mm: the regressor over the posed stand-in body."""
    for key, (folder, name) in REGRESSOR_FILES.items():
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        np.save(os.path.join(root, folder, name), mesh[key].astype(np.float32))
    rng = np.random.default_rng(sub_seed(seed, 8))
    n_h36m = int(counts.get("Human36M", 0))
    if n_h36m % H36M_CAMERAS:
        raise ValueError(f"Human36M: {n_h36m} samples, not a multiple of {H36M_CAMERAS} cameras")
    sizes = {"Human36M": n_h36m // H36M_CAMERAS, "COCO": int(counts.get("COCO", 0)),
             "MuCo": int(counts.get("MuCo", 0))}
    fits = {k: _fits(rng, n, traffic, upright=k != "Human36M") for k, n in sizes.items()}
    trans = {"Human36M": np.concatenate([rng.standard_normal((sizes["Human36M"], 2)) * 0.3,
                                         np.zeros((sizes["Human36M"], 1))], axis=1),
             "COCO": np.zeros((sizes["COCO"], 3)),
             "MuCo": np.stack([rng.standard_normal(sizes["MuCo"]) * 0.3,
                               rng.standard_normal(sizes["MuCo"]) * 0.1,
                               rng.uniform(3.5, 5.5, sizes["MuCo"])], axis=1)}
    trans = {k: _round(v, 5) for k, v in trans.items()}
    regs = np.concatenate([mesh["j_regressor"], mesh["coco_regressor"]])
    J = len(mesh["j_regressor"])
    order = [k for k in sizes if sizes[k]]
    joints = joints_of(regs, np.concatenate([fits[k][0] for k in order]),
                       np.concatenate([fits[k][1] for k in order]),
                       np.concatenate([trans[k] for k in order])).astype(np.float64)
    at = {}
    for k in order:
        at[k] = joints[:sizes[k]]
        joints = joints[sizes[k]:]
    if "Human36M" in at:
        _write_h36m(os.path.join(root, "Human36M"), *fits["Human36M"], trans["Human36M"],
                    at["Human36M"][:, :J], rng)
    if "COCO" in at:
        _write_coco(os.path.join(root, "COCO"), *fits["COCO"], at["COCO"][:, J:], rng)
    if "MuCo" in at:
        _write_muco(os.path.join(root, "MuCo"), *fits["MuCo"], trans["MuCo"],
                    at["MuCo"][:, :J])


def _write_h36m(root, pose, shape, trans, h36m, rng) -> None:
    n = len(pose)
    per = [n // len(H36M_SUBJECTS) + (i < n % len(H36M_SUBJECTS))
           for i in range(len(H36M_SUBJECTS))]
    at, image_id = 0, 0
    for subject, frames in zip(H36M_SUBJECTS, per):
        theta = math.pi / 4 + np.arange(H36M_CAMERAS) * math.pi / 2 + rng.normal(0, 0.05, 4)
        cams = {str(c + 1): {"R": _round(Z_UP_TO_CAMERA @ _rot_z(theta[c]), 6).tolist(),
                             "t": _round([0.0, 0.0, H36M_DEPTH_MM] + rng.normal(0, 100, 3),
                                         3).tolist(),
                             "f": list(H36M_F), "c": list(H36M_C)}
                for c in range(H36M_CAMERAS)}
        images, annotations, joints, params = [], [], {}, {}
        for k in range(frames):
            i = at + k
            act, sub = 2 + k % H36M_ACTIONS, 1 + (k // H36M_ACTIONS) % 2
            frame = H36M_FRAME_STEP * (k // (2 * H36M_ACTIONS))
            world = _round(h36m[i], 3)
            joints.setdefault(str(act), {}).setdefault(str(sub), {})[str(frame)] = world.tolist()
            params.setdefault(str(act), {}).setdefault(str(sub), {})[str(frame)] = {
                "pose": pose[i].tolist(), "shape": shape[i].tolist(), "trans": trans[i].tolist()}
            for cam, p in cams.items():
                R, t = np.asarray(p["R"]), np.asarray(p["t"])
                xy = _project(world @ R.T + t, H36M_F, H36M_C)
                name = (f"s_{subject:02d}_act_{act:02d}_subact_{sub:02d}_ca_{int(cam):02d}_"
                        f"{frame + 1:06d}.jpg")
                images.append({"id": image_id, "file_name": name, "width": H36M_IMAGE[0],
                               "height": H36M_IMAGE[1], "subject": subject, "action_idx": act,
                               "subaction_idx": sub, "frame_idx": frame, "cam_idx": int(cam)})
                annotations.append({"id": image_id, "image_id": image_id, "bbox": _bbox(xy)})
                image_id += 1
        at += frames
        base = os.path.join(root, "annotations", f"Human36M_subject{subject}")
        _dump(base + "_data.json", {"images": images, "annotations": annotations})
        _dump(base + "_camera.json", cams)
        _dump(base + "_joint_3d.json", joints)
        _dump(base + "_smpl_param.json", params)


def _write_coco(root, pose, shape, coco, rng) -> None:
    n = len(pose)
    s = _round(rng.uniform(180.0, 260.0, n), 3)
    t = _round(np.array(COCO_IMAGE) / 2 + rng.normal(0, 20, (n, 2)), 3)
    images, annotations, smplify = [], [], {}
    for i in range(n):
        kp = np.ones((len(coco[i]), 3)) * 2.0      # visibility 2: labelled, visible
        kp[:, :2] = _round(coco[i][:, :2] / 1000.0 * s[i] + t[i], 3)
        images.append({"id": i, "file_name": f"{i:012d}.jpg", "width": COCO_IMAGE[0],
                       "height": COCO_IMAGE[1]})
        annotations.append({"id": i, "image_id": i, "iscrowd": 0, "num_keypoints": len(kp),
                            "bbox": _bbox(kp[:, :2]), "keypoints": kp.reshape(-1).tolist()})
        smplify[str(i)] = {"smpl_param": {"pose": pose[i].tolist(), "shape": shape[i].tolist()},
                           "cam_param": {"s": [float(s[i])], "t": t[i].tolist()}}
    _dump(os.path.join(root, "annotations", "person_keypoints_train2017.json"),
          {"images": images, "annotations": annotations})
    _dump(os.path.join(root, "annotations", "coco_smplify_train.json"), smplify)


def _write_muco(root, pose, shape, trans, h36m) -> None:
    images, annotations, params = [], [], {}
    for i in range(len(pose)):
        cam = _round(h36m[i][list(MUCO_FROM_H36M)], 3)
        images.append({"id": i, "file_name": f"augmented_set/{i:06d}.jpg", "width": MUCO_IMAGE[0],
                       "height": MUCO_IMAGE[1], "f": list(MUCO_F), "c": list(MUCO_C)})
        annotations.append({"id": i, "image_id": i, "keypoints_cam": cam.tolist(),
                            "bbox": _bbox(_project(cam, MUCO_F, MUCO_C))})
        params[str(i)] = {"pose": pose[i].tolist(), "shape": shape[i].tolist(),
                          "trans": trans[i].tolist()}
    _dump(os.path.join(root, "data", "MuCo-3DHP.json"),
          {"images": images, "annotations": annotations})
    _dump(os.path.join(root, "data", "smpl_param.json"), params)
