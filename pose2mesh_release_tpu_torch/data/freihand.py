"""FreiHAND dataset (MANO hand benchmark).

Reference: data/FreiHAND/dataset.py (257 LoC).  Annotations:
`freihand_{train,eval}_coco.json` (COCO-format with per-image db_idx) +
`freihand_{train,eval}_data.json` (per-db_idx cam_param/mano_param/
joint_3d), detector files `hrnet_output_on_{train,eval}set.json`.  The
eval split ships dummy GT, so `evaluate` dumps a codalab `pred.json`
([joints, meshes]) exactly like FreiHAND/dataset.py:230-256.

GT synthesis folds the camera rotation into the MANO root axis-angle and
adds the camera translation pre-mm-scaling (gt_synth.posed_mesh_rotated
== ManoLayer trans semantics, manopth/manolayer.py:261-273), batched.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List

import numpy as np

from ..utils.coords import process_bbox
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_rotated

__all__ = ["FreiHAND"]


class FreiHAND(MeshDataset):
    name = "FreiHAND"
    levels = 6
    input_joint_name = "mano"
    target_joint_name = "mano"
    has_gt_mesh = True

    def __init__(self, data_split: str = "train", *, data_dir: str,
                 output_dir: str = ".", **kw):
        self.data_dir = data_dir
        self.output_dir = output_dir
        self.datalist_pose2d_det: List[dict] = []
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        tag = "train" if self.data_split == "train" else "eval"
        db = CocoIndex.from_files(
            [osp.join(self.data_dir, f"freihand_{tag}_coco.json")]
        )
        with open(osp.join(self.data_dir, f"freihand_{tag}_data.json")) as f:
            data = json.load(f)

        datalist = []
        for aid, ann in db.anns.items():
            img = db.load_img(ann["image_id"])
            db_idx = str(img["db_idx"])
            rec = data[db_idx]
            if self.data_split == "train":
                cam = rec["cam_param"]
                R = np.array(cam.get("R", np.eye(3).tolist()), np.float32)
                t = np.array(cam.get("t", [0, 0, 0]), np.float32).reshape(3)
                mano = rec["mano_param"]
                joint_cam = np.array(rec["joint_3d"], np.float32).reshape(-1, 3)
                bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                    self.input_shape[1] / self.input_shape[0])
                if bbox is None:
                    continue
            else:
                cam = rec["cam_param"]
                R = np.eye(3, dtype=np.float32)
                t = np.zeros(3, np.float32)
                mano = {"pose": np.ones(48, np.float32),
                        "shape": np.ones(10, np.float32)}
                joint_cam = np.ones((self.joint_num, 3), np.float32)
                bbox = None
            datalist.append({
                "img_id": ann["image_id"],
                "img_path": osp.join(self.data_dir, img["file_name"]),
                "img_hw": (img["height"], img["width"]),
                "cam_R": R, "cam_t": t,
                "focal": np.array(cam.get("focal", [500.0, 500.0]), np.float32),
                "princpt": np.array(cam.get("princpt", [112.0, 112.0]), np.float32),
                "mano_pose": np.array(mano["pose"], np.float32).reshape(-1),
                "mano_shape": np.array(mano["shape"], np.float32).reshape(-1),
                "joint_img": None,
                "joint_cam": joint_cam,
            })
        datalist.sort(key=lambda d: d["img_id"])

        det_path = osp.join(self.data_dir, f"hrnet_output_on_{tag}set.json")
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
        pose = np.stack([d["mano_pose"] for d in self.datalist])
        shape = np.stack([d["mano_shape"] for d in self.datalist])
        R = np.stack([d["cam_R"] for d in self.datalist])
        t_mm = np.stack([d["cam_t"] for d in self.datalist]) * 1000.0
        params = self._layer()
        mesh_mm, _ = batched_gt(
            lambda p, s, R_, t_: posed_mesh_rotated(params, p, s, R_, t_),
            (pose, shape, R, t_mm), batch=min(256, max(8, n)), device=self.device,
        )
        reg = np.asarray(self.mesh_model.joint_regressor_mano)
        det = {d["img_id"]: d["img_joint"] for d in self.datalist_pose2d_det}
        from ..utils.coords import cam2pixel
        for i, d in enumerate(self.datalist):
            mc = mesh_mm[i]
            j = reg @ mc
            root = j[:1]
            if d["img_id"] in det:
                d["joint_img"] = det[d["img_id"]][:, :2].astype(np.float32)
            else:
                jc = j.copy()
                jc[:, 2] = np.where(np.abs(jc[:, 2]) < 1e-6, 1e-6, jc[:, 2])
                d["joint_img"] = cam2pixel(
                    jc, d["focal"], d["princpt"]
                )[:, :2].astype(np.float32)
            d["joint_cam"] = (j - root).astype(np.float32)
            mesh_mm[i] = mc - root
        self.gt_mesh = mesh_mm
        self.gt_reg3d = np.stack([d["joint_cam"] for d in self.datalist])
        self.fit_error = None

    def _augm_params(self):
        return 0, 0.0  # FreiHAND/dataset.py:144: rot, flip = 0, 0

    def evaluate_joint(self, outs) -> Dict[str, float]:
        """Eval split has dummy GT: dump codalab pred.json
        (FreiHAND/dataset.py:203-228)."""
        joints = np.asarray(outs["joint_coord"])
        joints = joints - joints[:, :1]
        out_path = osp.join(self.output_dir, "pred.json")
        os.makedirs(self.output_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump([joints.tolist(), joints.tolist()], f)
        print(f"FreiHAND predictions saved to {out_path}")
        return {"saved": 1.0}

    def evaluate(self, outs, vis_dir=None) -> Dict[str, float]:
        if vis_dir is not None:
            self._dump_vis_objs(np.asarray(outs["mesh_coord"]), vis_dir)
        meshes = np.asarray(outs["mesh_coord"])
        reg = np.asarray(self.mesh_model.joint_regressor_mano)
        joints = np.einsum("jv,nvc->njc", reg, meshes)
        out_path = osp.join(self.output_dir, "pred.json")
        os.makedirs(self.output_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump([joints.tolist(), meshes.tolist()], f)
        print(f"FreiHAND predictions saved to {out_path}")
        return {"saved": 1.0}
