"""AMASS dataset (train-only mocap; synthetic 2D via fixed H36M cameras).

Reference: data/AMASS/dataset.py (329 LoC).  Walks `<data>/<sub>/<seq>/
*_poses.npz` mocap files (poses 156-D, betas 16-D, trans); keeps CMU for
pose2mesh (CMU+BML for posenet); subsamples per sub-dataset (CMU 60,
BML/mosh 10, else 5); renders each frame from 4 fixed H36M camera
rotations at t=(0,0,10) m, focal 1500, princpt 500 — producing purely
synthetic 2D->3D supervision.  GT synthesis batches the camera-rotated LBS
(gt_synth.posed_mesh_cam with trans=0) instead of per-sample torch LBS.
"""
from __future__ import annotations

import glob
import os.path as osp
from typing import List

import numpy as np

from ..utils.coords import cam2pixel
from .base import MeshDataset
from .gt_synth import batched_gt, posed_mesh_rotated
from .joint_sets import COCO as COCO_SET
from .noise import synthesize_pose
from ..utils import augment as aug

__all__ = ["AMASS"]

# the four Human3.6M camera rotations (AMASS/dataset.py:101-104)
H36M_CAM_RS = np.array([
    [[-0.9153617, 0.40180838, 0.02574755],
     [0.05154812, 0.18037356, -0.9822465],
     [-0.39931902, -0.89778364, -0.18581952]],
    [[0.92816836, 0.37215385, 0.00224838],
     [0.08166409, -0.1977723, -0.9768404],
     [-0.36309022, 0.9068559, -0.2139576]],
    [[-0.91415495, -0.40277803, -0.04572295],
     [-0.04562341, 0.2143085, -0.97569996],
     [0.4027893, -0.8898549, -0.21428728]],
    [[0.91415626, -0.40060705, 0.06190599],
     [-0.05641001, -0.2769532, -0.9592262],
     [0.40141782, 0.8733905, -0.27577674]],
], dtype=np.float32)
CAM_T = np.array([0.0, 0.0, 10.0], np.float32)       # meters
FOCAL = np.array([1500.0, 1500.0], np.float32)
PRINCPT = np.array([500.0, 500.0], np.float32)


def _subsampling_ratio(sub_name: str) -> int:
    sub = sub_name.lower()
    if sub == "cmu":
        return 60
    if sub in ("mpi_mosh", "bmlrub", "bmlmovi"):
        return 10
    return 5


def _add_pelvis_neck(joints: np.ndarray) -> np.ndarray:
    names = COCO_SET.joints_name
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = ((joints[lhip] + joints[rhip]) * 0.5)[None]
    neck = ((joints[lsho] + joints[rsho]) * 0.5)[None]
    return np.concatenate([joints, pelvis, neck])


class AMASS(MeshDataset):
    name = "AMASS"
    levels = 9
    input_joint_name = "coco"
    target_joint_name = "human36"

    def __init__(self, data_split: str = "train", *, data_dir: str, **kw):
        self.data_dir = data_dir
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        if self.data_split != "train":
            return []
        datalist: List[dict] = []
        for sub in sorted(glob.glob(osp.join(self.data_dir, "*"))):
            sub_name = osp.basename(sub)
            if self.model_name == "pose2mesh_net":
                if "CMU" not in sub_name:
                    continue
            elif "CMU" not in sub_name and "BML" not in sub_name:
                continue
            ratio = _subsampling_ratio(sub_name)
            for seq in sorted(glob.glob(osp.join(sub, "*"))):
                for file in sorted(glob.glob(osp.join(seq, "*_poses.npz"))):
                    data = np.load(file)
                    poses = np.asarray(data["poses"], np.float32)
                    betas = np.asarray(data["betas"], np.float32)[:10]
                    for frame in range(0, len(poses), ratio):
                        for cam_idx in range(len(H36M_CAM_RS)):
                            datalist.append({
                                "smpl_pose": poses[frame, :72],
                                "smpl_shape": betas,
                                "cam_idx": cam_idx,
                                "joint_img": None, "joint_cam": None,
                            })
                if self.debug:
                    break
        return datalist

    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        pose = np.stack([d["smpl_pose"] for d in self.datalist])
        shape = np.stack([d["smpl_shape"] for d in self.datalist])
        R = H36M_CAM_RS[[d["cam_idx"] for d in self.datalist]]
        t_mm = np.tile(CAM_T * 1000.0, (n, 1))
        params = self._layer("neutral")
        mesh_mm, _ = batched_gt(
            lambda p, s, R_, t_: posed_mesh_rotated(params, p, s, R_, t_),
            (pose, shape, R, t_mm), batch=min(256, max(8, n)), device=self.device,
        )

        h36m_reg = np.asarray(self.mesh_model.joint_regressor_h36m)
        coco_reg = np.asarray(self.mesh_model.joint_regressor_coco)
        for i, d in enumerate(self.datalist):
            mc = mesh_mm[i]
            j_h36m = h36m_reg @ mc
            j_coco = _add_pelvis_neck(coco_reg @ mc)
            # reference projects meters (cam2pixel(joint/1000),
            # AMASS/dataset.py:239)
            ji = cam2pixel(j_coco / 1000.0, FOCAL, PRINCPT)[:, :2]
            d["joint_img"] = ji.astype(np.float32)
            d["joint_cam"] = (j_coco - j_coco[-2:-1]).astype(np.float32)
            mesh_mm[i] = mc - j_h36m[:1]
        self.gt_mesh = mesh_mm
        h36m = np.einsum("jv,nvc->njc", h36m_reg, mesh_mm)
        self.gt_reg3d = (h36m - h36m[:, :1]).astype(np.float32)
        self.fit_error = None  # mocap GT is exact

    def replace_joint_img(self, idx, joint_img, tight_bbox, trans):
        if self.input_joint_name == "coco" and self.is_train:
            xmin, ymin, w, h = tight_bbox
            pts = [aug.affine_transform(np.array(p, np.float32), trans)
                   for p in ((xmin, ymin), (xmin + w, ymin), (xmin + w, ymin + h))]
            area = (np.linalg.norm(pts[1] - pts[0])
                    * np.linalg.norm(pts[2] - pts[1]))
            joint_img = joint_img.copy()
            with_vis = np.concatenate(
                [joint_img[:17, :2], np.ones((17, 1), np.float32)], axis=1
            )
            joint_img[:17, :2] = synthesize_pose(
                with_vis, area, num_overlap=0, rng=self.rng
            )[:, :2]
        return joint_img
