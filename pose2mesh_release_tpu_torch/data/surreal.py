"""SURREAL dataset (synthetic; SMPL-joint benchmark).

Reference: data/SURREAL/dataset.py (296 LoC).  Annotations: one COCO-format
`{split}.json` (per-image cam_param; per-annotation smpl_param with gender
+ joint_cam + bbox) and `hrnet_output_on_{split}set.json` detector
keypoints.  Input joint set is 'smpl' (24 joints); GT = gendered SMPL with
translation, camera frame; evaluation is SMPL-joint MPJPE + MPVPE with
root-joint (pelvis, index 0) alignment — the base `evaluate` covers it.

The reference's duplicate-last-sample "fix gpu bug" hack
(SURREAL/dataset.py:96-99) is intentionally NOT reproduced (SURVEY.md §B).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import List

import numpy as np

from ..utils.coords import cam2pixel, process_bbox
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_world

__all__ = ["SURREAL"]


class SURREAL(MeshDataset):
    name = "SURREAL"
    levels = 9
    input_joint_name = "smpl"
    target_joint_name = "smpl"

    def __init__(self, data_split: str = "train", *, data_dir: str, **kw):
        self.data_dir = data_dir
        self.datalist_pose2d_det: List[dict] = []
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        db = CocoIndex.from_files(
            [osp.join(self.data_dir, "data", f"{self.data_split}.json")]
        )
        datalist = []
        for iid, img in db.imgs.items():
            anns = db.anns_of(iid)
            if not anns:
                continue
            ann = anns[0]
            bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                self.input_shape[1] / self.input_shape[0])
            if bbox is None:
                continue
            sp = ann["smpl_param"]
            datalist.append({
                "img_id": iid,
                "img_name": img["file_name"],
                "img_hw": (img["height"], img["width"]),
                "cam_param": {k: np.array(v, np.float32)
                              for k, v in img["cam_param"].items()},
                "bbox": bbox,
                "smpl_pose": np.array(sp["pose"], np.float32).reshape(-1),
                "smpl_shape": np.array(sp["shape"], np.float32).reshape(-1),
                "smpl_trans": np.array(sp["trans"], np.float32).reshape(-1),
                "gender": sp.get("gender", "neutral"),
                "joint_img": None, "joint_cam": None,
            })
            if self.debug and len(datalist) > 1000:
                break
        datalist.sort(key=lambda d: d["img_id"])

        det_path = osp.join(self.data_dir, "data",
                            f"hrnet_output_on_{self.data_split}set.json")
        if osp.exists(det_path):
            with open(det_path) as f:
                det = json.load(f)
            dets = [{"img_id": it["image_id"],
                     "img_joint": np.array(it["keypoints"], np.float32)}
                    for it in det]
            self.datalist_pose2d_det = sorted(dets, key=lambda d: d["img_id"])
        return datalist

    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        mesh_mm = np.zeros((n, self.mesh_model.vertex_num, 3), np.float32)
        joints_mm = np.zeros((n, 24, 3), np.float32)
        genders = np.array([d["gender"] for d in self.datalist])
        for gender in np.unique(genders):
            sel = np.nonzero(genders == gender)[0]
            pose = np.stack([self.datalist[i]["smpl_pose"] for i in sel])
            shape = np.stack([self.datalist[i]["smpl_shape"] for i in sel])
            trans = np.stack([self.datalist[i]["smpl_trans"] for i in sel])
            params = self._layer(str(gender))
            m, j = batched_gt(
                lambda p, s, t: posed_mesh_world(params, p, s, t),
                (pose, shape, trans), batch=min(256, max(8, len(sel))), device=self.device,
            )
            mesh_mm[sel], joints_mm[sel] = m, j

        det = {d["img_id"]: d["img_joint"] for d in self.datalist_pose2d_det}
        for i, d in enumerate(self.datalist):
            jc = joints_mm[i]
            if self.use_gt_input or d["img_id"] not in det:
                d["joint_img"] = cam2pixel(
                    jc, d["cam_param"]["focal"], d["cam_param"]["princpt"]
                )[:, :2].astype(np.float32)
            else:
                d["joint_img"] = det[d["img_id"]][:, :2].astype(np.float32)
            root = jc[:1]
            d["joint_cam"] = (jc - root).astype(np.float32)
            mesh_mm[i] -= root
        self.gt_mesh = mesh_mm
        self.gt_reg3d = np.stack([d["joint_cam"] for d in self.datalist])
        self.fit_error = None  # synthetic GT is exact
