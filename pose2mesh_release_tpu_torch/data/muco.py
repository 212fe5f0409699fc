"""MuCo-3DHP dataset (train-only; composited multi-person 3D).

Reference: data/MuCo/dataset.py (351 LoC).  Annotations: one COCO-format
json (per-image f/c intrinsics; per-annotation keypoints_cam/_img + bbox)
plus `smpl_param.json` fits keyed by annotation id.  Only the person
closest to the camera per image is used (dataset.py:139-141).  GT = neutral
SMPL with translation, already camera frame; fits farther than 45 mm from
the MuCo->H36M-remapped GT joints are invalidated (dataset.py:30,246-262).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import List

import numpy as np

from ..utils.augment import transform_joint_to_other_db
from ..utils.coords import cam2pixel, process_bbox
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_world
from .joint_sets import COCO as COCO_SET, HUMAN36
from .noise import synthesize_pose
from ..utils import augment as aug

__all__ = ["MuCo"]

MUCO_JOINTS_NAME = (
    "Head_top", "Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "L_Shoulder",
    "L_Elbow", "L_Wrist", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
    "L_Ankle", "Pelvis", "Spine", "Head", "R_Hand", "L_Hand", "R_Toe", "L_Toe",
)
MUCO_ROOT_IDX = MUCO_JOINTS_NAME.index("Pelvis")


def _add_pelvis_neck(joints: np.ndarray) -> np.ndarray:
    names = COCO_SET.joints_name
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = ((joints[lhip] + joints[rhip]) * 0.5)[None]
    neck = ((joints[lsho] + joints[rsho]) * 0.5)[None]
    return np.concatenate([joints, pelvis, neck])


class MuCo(MeshDataset):
    name = "MuCo"
    levels = 9
    input_joint_name = "coco"
    target_joint_name = "human36"
    fitting_thr = 45.0  # millimeters (MuCo/dataset.py:30)

    def __init__(self, data_split: str = "train", *, data_dir: str, **kw):
        self.data_dir = data_dir
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        if self.data_split != "train":
            return []
        db = CocoIndex.from_files(
            [osp.join(self.data_dir, "data", "MuCo-3DHP.json")]
        )
        with open(osp.join(self.data_dir, "data", "smpl_param.json")) as f:
            smpl_params = json.load(f)

        datalist = []
        for iid, img in db.imgs.items():
            anns = db.anns_of(iid)
            if not anns:
                continue
            # closest person to the camera (MuCo/dataset.py:139-141)
            depths = [ann["keypoints_cam"][MUCO_ROOT_IDX][2] for ann in anns]
            ann = anns[int(np.argmin(depths))]
            sp = smpl_params.get(str(ann["id"]))
            if sp is None:
                continue
            pose = np.array(sp["pose"], np.float32)
            shape = np.array(sp["shape"], np.float32)
            trans = np.array(sp["trans"], np.float32)
            if np.isnan(pose.sum() + shape.sum() + trans.sum()):
                continue
            bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                self.input_shape[1] / self.input_shape[0])
            if bbox is None:
                continue
            datalist.append({
                "annot_id": ann["id"],
                "img_path": osp.join(self.data_dir, "images", img["file_name"]),
                "img_hw": (img["height"], img["width"]),
                "bbox": bbox,
                "muco_joint_cam": np.array(ann["keypoints_cam"], np.float32),
                "cam_param": {
                    "focal": np.array(img["f"], np.float32),
                    "princpt": np.array(img["c"], np.float32),
                },
                "smpl_pose": pose.reshape(-1),
                "smpl_shape": shape.reshape(-1),
                "smpl_trans": trans.reshape(-1),
                "joint_img": None, "joint_cam": None,
            })
            if self.debug and len(datalist) > 10000:
                break
        return datalist

    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        pose = np.stack([d["smpl_pose"] for d in self.datalist])
        shape = np.stack([d["smpl_shape"] for d in self.datalist])
        shape = np.where((np.abs(shape) > 3).any(1, keepdims=True), 0.0, shape)
        trans = np.stack([d["smpl_trans"] for d in self.datalist])
        params = self._layer("neutral")
        mesh_mm, _ = batched_gt(
            lambda p, s, t: posed_mesh_world(params, p, s, t),
            (pose, shape, trans), batch=min(256, max(8, n)), device=self.device,
        )

        h36m_reg = np.asarray(self.mesh_model.joint_regressor_h36m)
        coco_reg = np.asarray(self.mesh_model.joint_regressor_coco)
        fit_error = np.zeros(n, np.float32)
        for i, d in enumerate(self.datalist):
            mc = mesh_mm[i]
            j_h36m = h36m_reg @ mc
            j_coco = _add_pelvis_neck(coco_reg @ mc)
            ji = cam2pixel(j_coco, d["cam_param"]["focal"],
                           d["cam_param"]["princpt"])[:, :2]
            d["joint_img"] = ji.astype(np.float32)
            d["joint_cam"] = (j_coco - j_coco[-2:-1]).astype(np.float32)
            fit_error[i] = self._fit_error(d["muco_joint_cam"], mc - j_h36m[:1])
            mesh_mm[i] = mc - j_h36m[:1]
        self.gt_mesh = mesh_mm
        h36m = np.einsum("jv,nvc->njc", h36m_reg, mesh_mm)
        self.gt_reg3d = (h36m - h36m[:, :1]).astype(np.float32)
        self.fit_error = fit_error

    def _fit_error(self, muco_joint: np.ndarray, smpl_mesh: np.ndarray) -> float:
        """MuCo->H36M remap + translation-aligned joint distance
        (MuCo/dataset.py:246-262)."""
        muco_joint = muco_joint - muco_joint[MUCO_ROOT_IDX, None]
        h36m_joint = transform_joint_to_other_db(
            muco_joint, MUCO_JOINTS_NAME, HUMAN36.joints_name
        )
        mask = transform_joint_to_other_db(
            np.ones((len(MUCO_JOINTS_NAME), 3), np.float32),
            MUCO_JOINTS_NAME, HUMAN36.joints_name,
        )[:, 0] > 0
        h36m_joint = h36m_joint[mask]
        from_smpl = (np.asarray(self.mesh_model.joint_regressor_h36m)
                     @ smpl_mesh)[mask]
        from_smpl = from_smpl - from_smpl.mean(0) + h36m_joint.mean(0)
        return float(np.sqrt(((h36m_joint - from_smpl) ** 2).sum(1)).mean())

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
