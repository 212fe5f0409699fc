"""COCO dataset (train-only; SMPLify pseudo-GT).

Reference: data/COCO/dataset.py (309 LoC).  Annotations:
`person_keypoints_train2017.json` (standard COCO keypoints) +
`coco_smplify_train.json` (per-annotation-id SMPLify fit: neutral SMPL
pose/shape and a weak-perspective camera {s, t}).  GT meshes are rootless
neutral LBS outputs; 2-D GT is the weak-perspective projection
mesh_xy/1000 * s + t.  Samples whose SMPLify fit reprojects >3 px (in a
64x64 square crop) from the annotated keypoints are invalidated
(COCO/dataset.py:28,196-214).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import List

import numpy as np

from ..utils import augment as aug
from ..utils.coords import get_bbox, process_bbox
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_world
from .joint_sets import COCO as COCO_SET
from .noise import synthesize_pose

__all__ = ["COCO"]


def _add_pelvis_neck(joints: np.ndarray) -> np.ndarray:
    names = COCO_SET.joints_name
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    pelvis = ((joints[lhip] + joints[rhip]) * 0.5)[None]
    neck = ((joints[lsho] + joints[rsho]) * 0.5)[None]
    return np.concatenate([joints, pelvis, neck])


class COCO(MeshDataset):
    name = "COCO"
    levels = 9
    input_joint_name = "coco"
    target_joint_name = "human36"
    fitting_thr = 3.0  # pixels in a 64x64 crop (COCO/dataset.py:28)

    def __init__(self, data_split: str = "train", *, data_dir: str, **kw):
        self.data_dir = data_dir
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        if self.data_split != "train":
            return []
        annot_path = osp.join(self.data_dir, "annotations")
        db = CocoIndex.from_files(
            [osp.join(annot_path, f"person_keypoints_{self.data_split}2017.json")]
        )
        with open(osp.join(annot_path, "coco_smplify_train.json")) as f:
            smplify = json.load(f)

        datalist = []
        for aid, ann in db.anns.items():
            if ann.get("iscrowd") or ann.get("num_keypoints", 0) == 0:
                continue
            if str(aid) not in smplify:
                continue
            img = db.load_img(ann["image_id"])
            bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                self.input_shape[1] / self.input_shape[0])
            if bbox is None:
                continue
            kp = np.array(ann["keypoints"], np.float32).reshape(-1, 3)
            joint_valid = (kp[:, 2:3] > 0).astype(np.float32)
            fit = smplify[str(aid)]
            sp, cp = fit["smpl_param"], fit["cam_param"]
            datalist.append({
                "img_path": osp.join(self.data_dir, "images", "train2017",
                                     img["file_name"]),
                "img_hw": (img["height"], img["width"]),
                "bbox": bbox,
                "coco_joint_img": kp[:, :2],      # annotated keypoints
                "coco_joint_valid": joint_valid,
                "smpl_pose": np.array(sp["pose"], np.float32).reshape(-1),
                "smpl_shape": np.array(sp["shape"], np.float32).reshape(-1),
                "cam_s": np.array(cp["s"], np.float32).reshape(-1),
                "cam_t": np.array(cp["t"], np.float32).reshape(2),
                "joint_img": None, "joint_cam": None,
            })
        return datalist

    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        pose = np.stack([d["smpl_pose"] for d in self.datalist])
        shape = np.stack([d["smpl_shape"] for d in self.datalist])
        shape = np.where((np.abs(shape) > 3).any(1, keepdims=True), 0.0, shape)
        trans = np.zeros((n, 3), np.float32)
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
            # weak-perspective projection (COCO/dataset.py:191-196)
            s, t = d["cam_s"], d["cam_t"]
            img_coco = (j_coco[:, :2] / 1000.0) * s + t[None]
            d["joint_img"] = img_coco.astype(np.float32)
            d["joint_cam"] = (j_coco - j_coco[-2:-1]).astype(np.float32)
            d["joint_valid"] = np.ones(len(j_coco), np.float32)
            fit_error[i] = self._fit_error_2d(
                d["coco_joint_img"], img_coco[:17],
                d["coco_joint_valid"], img_coco,
            )
            mesh_mm[i] = mc - j_h36m[:1]
        self.gt_mesh = mesh_mm
        h36m = np.einsum("jv,nvc->njc", h36m_reg, mesh_mm)
        self.gt_reg3d = (h36m - h36m[:, :1]).astype(np.float32)
        self.fit_error = fit_error

    def _fit_error_2d(self, coco_gt: np.ndarray, coco_from_smpl: np.ndarray,
                      valid: np.ndarray, bbox_src: np.ndarray) -> float:
        """2-D reprojection error in a square 64x64 crop
        (COCO/dataset.py:196-214)."""
        bbox = process_bbox(get_bbox(bbox_src), aspect_ratio=1.0)
        if bbox is None:
            return np.inf
        a, _ = aug.j2d_processing(coco_from_smpl.copy(), (64, 64), bbox, 0, 0, None)
        b, _ = aug.j2d_processing(coco_gt.copy(), (64, 64), bbox, 0, 0, None)
        m = valid.reshape(-1) > 0
        if not m.any():
            return np.inf
        return float(np.sqrt(((a[m, :2] - b[m, :2]) ** 2).sum(1)).mean())

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

    def __getitem__(self, idx: int):
        out = super().__getitem__(idx)
        # COCO invalidates ALL targets on a bad fit (COCO/dataset.py:270-272)
        if self.model_name == "pose2mesh_net" and self.fit_error is not None \
                and self.fit_error[idx] > self.fitting_thr:
            _, _, meta = out
            for k in meta:
                meta[k] = np.zeros_like(meta[k])
        return out
