"""3DPW dataset (test benchmark).

Reference: data/PW3D/dataset.py (442 LoC).  Annotation files:
`3DPW_latest_{split}.json` (COCO-format; per-image cam_param + sequence,
per-annotation smpl_param with gender + openpose_result + bbox) and
`darkpose_3dpw_{split}set_output.json` (DarkPose COCO keypoints keyed by
annotation id).  GT meshes come from gendered SMPL with translation, in
camera frame, synthesized batched (gt_synth.posed_mesh_world).

Evaluation reports H36M-regressed MPJPE / PA-MPJPE (the README 3DPW
benchmark numbers), SMPL-joint MPJPE and MPVPE; the optional OneEuro
smoothing path (+ acceleration error) of PW3D/dataset.py:383-417 is a
first-class flag here instead of commented-out code.
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np

from ..utils.coords import cam2pixel, process_bbox, rigid_align
from ..utils.smooth import smooth_pose
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_world
from .joint_sets import COCO as COCO_SET, HUMAN36_EVAL_JOINTS

__all__ = ["PW3D"]

OPENPOSE_NAMES = (
    "Nose", "Neck", "R_Shoulder", "R_Elbow", "R_Wrist", "L_Shoulder",
    "L_Elbow", "L_Wrist", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
    "L_Ankle", "R_Eye", "L_Eye", "R_Ear", "L_Ear", "Pelvis",
)


def _add_pelvis_neck(joints: np.ndarray, names, only_pelvis: bool = False
                     ) -> np.ndarray:
    lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
    pelvis = ((joints[lhip] + joints[rhip]) * 0.5)[None]
    if only_pelvis:
        return np.concatenate([joints, pelvis])
    lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
    neck = ((joints[lsho] + joints[rsho]) * 0.5)[None]
    return np.concatenate([joints, pelvis, neck])


class PW3D(MeshDataset):
    name = "PW3D"
    levels = 9
    input_joint_name = "coco"
    target_joint_name = "human36"

    def __init__(self, data_split: str = "test", *, data_dir: str, **kw):
        self.data_dir = data_dir
        self.video_indices: List[np.ndarray] = []
        super().__init__(data_split, **kw)

    def load_data(self) -> List[dict]:
        path = osp.join(self.data_dir, f"3DPW_latest_{self.data_split}.json")
        db = CocoIndex.from_files([path])

        det_path = osp.join(
            self.data_dir, f"darkpose_3dpw_{self.data_split}set_output.json"
        )
        dets: Dict[str, np.ndarray] = {}
        if osp.exists(det_path):
            with open(det_path) as f:
                for item in json.load(f):
                    dets[str(item["annotation_id"])] = np.array(
                        item["keypoints"], np.float32
                    )[:, :3]

        datalist = []
        for aid, ann in db.anns.items():
            img = db.load_img(ann["image_id"])
            cam_param = {k: np.array(v, np.float32)
                         for k, v in img["cam_param"].items()}
            bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                self.input_shape[1] / self.input_shape[0])
            if bbox is None:
                continue
            pred2d = dets.get(str(aid))
            if pred2d is not None:
                pred2d = _add_pelvis_neck(pred2d, COCO_SET.joints_name[:17])
            sp = ann["smpl_param"]
            datalist.append({
                "annot_id": int(aid),
                "person_id": ann.get("person_id", 0),
                "img_path": osp.join(self.data_dir, "imageFiles",
                                     img.get("sequence", ""), img["file_name"]),
                "vid_name": img.get("sequence", "") + str(ann.get("person_id", 0)),
                "img_hw": (img["height"], img["width"]),
                "cam_param": cam_param,
                "bbox": bbox,
                "smpl_pose": np.array(sp["pose"], np.float32).reshape(-1),
                "smpl_shape": np.array(sp["shape"], np.float32).reshape(-1),
                "smpl_trans": np.array(sp["trans"], np.float32).reshape(-1),
                "gender": sp.get("gender", "neutral"),
                "pred_pose2d": pred2d,
                # filled by synthesize_gt:
                "joint_img": None, "joint_cam": None,
            })
        datalist.sort(key=lambda x: (x["person_id"], x["img_path"]))
        names = np.array([d["vid_name"] for d in datalist])
        self.video_indices = [names == u for u in np.unique(names)]
        return datalist

    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        mesh_mm = np.zeros((n, self.mesh_model.vertex_num, 3), np.float32)
        genders = np.array([d.get("gender", "neutral") for d in self.datalist])
        for gender in np.unique(genders):
            sel = np.nonzero(genders == gender)[0]
            pose = np.stack([self.datalist[i]["smpl_pose"] for i in sel])
            shape = np.stack([self.datalist[i]["smpl_shape"] for i in sel])
            trans = np.stack([self.datalist[i]["smpl_trans"] for i in sel])
            params = self._layer(str(gender))
            out, _ = batched_gt(
                lambda p, s, t: posed_mesh_world(params, p, s, t),
                (pose, shape, trans), batch=min(256, max(8, len(sel))), device=self.device,
            )
            mesh_mm[sel] = out

        coco_reg = np.asarray(self.mesh_model.joint_regressor_coco)
        h36m_reg = np.asarray(self.mesh_model.joint_regressor_h36m)
        names = COCO_SET.joints_name
        for i, d in enumerate(self.datalist):
            mc = mesh_mm[i]
            j_h36m = h36m_reg @ mc
            j_coco = _add_pelvis_neck(coco_reg @ mc, names[:17])
            gt_img = cam2pixel(j_coco, d["cam_param"]["focal"],
                               d["cam_param"]["princpt"])[:, :2]
            if self.use_gt_input or d["pred_pose2d"] is None:
                d["joint_img"] = gt_img.astype(np.float32)
            else:
                d["joint_img"] = d["pred_pose2d"][:, :2].astype(np.float32)
            d["joint_cam"] = (j_coco - j_coco[-2:-1]).astype(np.float32)
            mesh_mm[i] = mc - j_h36m[:1]
        self.gt_mesh = mesh_mm
        h36m = np.einsum("jv,nvc->njc", h36m_reg, mesh_mm)
        self.gt_reg3d = (h36m - h36m[:, :1]).astype(np.float32)
        self.fit_error = None  # no fitting-error invalidation for 3DPW

    def _augm_params(self):
        return 0, 0.0  # test-only dataset: no augmentation (dataset.py:212)

    def evaluate(self, outs, smooth: bool = False,
                 vis_dir=None) -> Dict[str, float]:
        if vis_dir is not None:
            self._dump_vis_objs(np.asarray(outs["mesh_coord"]), vis_dir)
        pred_mesh = np.asarray(outs["mesh_coord"])
        gt_mesh = np.asarray(outs["mesh_coord_target"])
        smpl_reg = np.asarray(self.mesh_model.joint_regressor_smpl)
        h36m_reg = np.asarray(self.mesh_model.joint_regressor_h36m)

        pred_smpl_j = np.einsum("jv,nvc->njc", smpl_reg, pred_mesh)
        gt_smpl_j = np.einsum("jv,nvc->njc", smpl_reg, gt_mesh)
        pred_mesh_r = pred_mesh - pred_smpl_j[:, :1]
        gt_mesh_r = gt_mesh - gt_smpl_j[:, :1]
        mpjpe_smpl = float(np.sqrt(
            ((pred_smpl_j - pred_smpl_j[:, :1] - gt_smpl_j + gt_smpl_j[:, :1])
             ** 2).sum(-1)).mean())
        mpvpe = float(np.sqrt(((pred_mesh_r - gt_mesh_r) ** 2).sum(-1)).mean())

        sel = list(HUMAN36_EVAL_JOINTS)
        ph = np.einsum("jv,nvc->njc", h36m_reg, pred_mesh_r)
        gh = np.einsum("jv,nvc->njc", h36m_reg, gt_mesh_r)
        ph = (ph - ph[:, :1])[:, sel]
        gh = (gh - gh[:, :1])[:, sel]
        mpjpe_h36m = float(np.sqrt(((ph - gh) ** 2).sum(-1)).mean())
        pa = np.stack([rigid_align(p, g) for p, g in zip(ph, gh)])
        pampjpe_h36m = float(np.sqrt(((pa - gh) ** 2).sum(-1)).mean())

        res = {
            "mpjpe": mpjpe_h36m, "pa_mpjpe": pampjpe_h36m,
            "mpjpe_smpl": mpjpe_smpl, "mpvpe": mpvpe,
        }
        print(f"3DPW eval: H36M MPJPE {mpjpe_h36m:.2f} mm, PA-MPJPE "
              f"{pampjpe_h36m:.2f} mm, SMPL MPJPE {mpjpe_smpl:.2f} mm, "
              f"MPVPE {mpvpe:.2f} mm")

        if smooth and self.video_indices:
            from ..utils.coords import compute_error_accel
            accel, sm_mpjpe, sm_pa = [], [], []
            for vid in self.video_indices:
                vid = vid[: len(ph)]
                pred, gt = ph[vid], gh[vid]
                if len(pred) < 3:
                    continue
                pred = smooth_pose(pred, min_cutoff=0.004, beta=0.005)
                accel.append(float(np.mean(compute_error_accel(gt, pred))))
                sm_mpjpe.append(float(np.sqrt(((pred - gt) ** 2).sum(-1)).mean()))
                pa_v = np.stack([rigid_align(p, g) for p, g in zip(pred, gt)])
                sm_pa.append(float(np.sqrt(((pa_v - gt) ** 2).sum(-1)).mean()))
            if accel:
                res["accel_error"] = float(np.mean(accel))
                res["smooth_mpjpe"] = float(np.mean(sm_mpjpe))
                res["smooth_pa_mpjpe"] = float(np.mean(sm_pa))
                print(f"  smoothed: MPJPE {res['smooth_mpjpe']:.2f} mm, "
                      f"PA-MPJPE {res['smooth_pa_mpjpe']:.2f} mm, accel "
                      f"{res['accel_error']:.2f} mm/s^2")
        return res
