"""Human3.6M dataset: loader, GT synthesis, evaluator.

Reference: data/Human36M/dataset.py (617 LoC).  Annotation layout (same
files): per-subject `Human36M_subject{N}_data.json` (COCO-format images +
annotations), `_camera.json` (R, t, f, c per camera id), `_joint_3d.json`
(world-frame 17-joint coords indexed [action][subaction][frame]) and
`_smpl_param.json` (pose/shape/trans fits, same indexing).  Test-split
detector inputs come from `absnet_output_on_testset.json`.

As in the JAX package, GT SMPL meshes for every record are synthesized in
one batched LBS pass at build time (`gt_synth.posed_mesh_cam`, on the
dataset's device) instead of per-sample LBS in dataloader workers
(reference dataset.py:344).
"""
from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List

import numpy as np

from ..utils import augment as aug
from ..utils.coords import cam2pixel, process_bbox, world2cam
from .base import MeshDataset
from .coco_json import CocoIndex
from .gt_synth import batched_gt, posed_mesh_cam
from .joint_sets import COCO as COCO_SET, HUMAN36
from .noise import H36MNoiseStats, synthesize_pose

__all__ = ["Human36M"]

ACTION_NAMES = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Posing",
    "Purchases", "Sitting", "SittingDown", "Smoking", "Photo", "Waiting",
    "Walking", "WalkDog", "WalkTogether",
)


class Human36M(MeshDataset):
    name = "Human36M"
    levels = 9
    fitting_thr = 25.0  # mm (Human36M/dataset.py:37)

    def __init__(self, data_split: str = "train", *, data_dir: str,
                 protocol: int = 2, input_joint_name: str = "human36",
                 **kw):
        self.data_dir = data_dir
        self.annot_path = osp.join(data_dir, "annotations")
        self.img_dir = osp.join(data_dir, "images")
        self.protocol = protocol
        self.input_joint_name = input_joint_name
        self.noise_stats = H36MNoiseStats(HUMAN36.joints_name)
        self.datalist_pose2d_det: List[dict] = []
        super().__init__(data_split, **kw)

    # --- loading -----------------------------------------------------------
    def _subjects(self) -> List[int]:
        if self.data_split == "train":
            subjects = [1, 5, 6, 7, 8] if self.protocol == 2 else [1, 5, 6, 7, 8, 9]
        else:
            subjects = [9, 11] if self.protocol == 2 else [11]
        return subjects[:1] if self.debug else subjects

    def _sampling_ratio(self) -> int:
        return 5 if self.data_split == "train" else 50

    def load_data(self) -> List[dict]:
        db = CocoIndex()
        cameras: Dict[str, dict] = {}
        joints: Dict[str, dict] = {}
        smpl_params: Dict[str, dict] = {}
        for subject in self._subjects():
            base = osp.join(self.annot_path, f"Human36M_subject{subject}")
            with open(base + "_data.json") as f:
                db.merge(json.load(f))
            with open(base + "_camera.json") as f:
                cameras[str(subject)] = json.load(f)
            with open(base + "_joint_3d.json") as f:
                joints[str(subject)] = json.load(f)
            with open(base + "_smpl_param.json") as f:
                smpl_params[str(subject)] = json.load(f)
        db.create_index()

        ratio = self._sampling_ratio()
        datalist: List[dict] = []
        skip_img_names: List[str] = []
        for aid, ann in db.anns.items():
            img = db.load_img(ann["image_id"])
            if img["frame_idx"] % ratio != 0:
                continue
            subject, act, subact, frame = (
                str(img["subject"]), str(img["action_idx"]),
                str(img["subaction_idx"]), str(img["frame_idx"]),
            )
            img_path = osp.join(self.img_dir, img["file_name"])
            try:
                smpl_param = smpl_params[subject][act][subact][frame]
            except KeyError:
                skip_img_names.append(osp.basename(img_path))
                continue
            cam = cameras[subject][str(img["cam_idx"])]
            R = np.array(cam["R"], np.float32)
            t = np.array(cam["t"], np.float32)
            f = np.array(cam["f"], np.float32)
            c = np.array(cam["c"], np.float32)

            joint_world = np.array(
                joints[subject][act][subact][frame], np.float32
            )
            joint_cam = world2cam(joint_world, R, t)
            joint_img = cam2pixel(joint_cam, f, c)

            bbox = process_bbox(np.array(ann["bbox"], np.float32),
                                self.input_shape[1] / self.input_shape[0])
            if bbox is None:
                continue
            datalist.append({
                "img_path": img_path,
                "img_name": osp.basename(img_path),
                "img_id": ann["image_id"],
                "bbox": bbox,
                "img_hw": (img["height"], img["width"]),
                "joint_img": joint_img[:, :2],  # h36m set, pixels
                "joint_cam": joint_cam,         # h36m set, camera mm
                "cam_param": {"R": R, "t": t, "focal": f, "princpt": c},
                "smpl_pose": np.array(smpl_param["pose"], np.float32).reshape(-1),
                "smpl_shape": np.array(smpl_param["shape"], np.float32).reshape(-1),
                "smpl_trans": np.array(smpl_param["trans"], np.float32).reshape(-1),
                # the reference hardcodes 'neutral' (Human36M/dataset.py:217,
                # per-subject genders commented out); honor an explicit
                # gender field when the annotations carry one
                "gender": smpl_param.get("gender", "neutral"),
            })
        datalist.sort(key=lambda x: x["img_name"])

        if self.data_split == "test":
            det_path = osp.join(self.data_dir, "absnet_output_on_testset.json")
            if osp.exists(det_path):
                with open(det_path) as f:
                    det = json.load(f)
                dets = [
                    {"img_name": k, "pose2d": np.array(v, np.float32)}
                    for k, v in det.items() if k not in skip_img_names
                ]
                dets.sort(key=lambda x: x["img_name"])
                self.datalist_pose2d_det = dets
        return datalist

    # --- GT synthesis (batched LBS on self.device) -------------------------
    def synthesize_gt(self) -> None:
        n = len(self.datalist)
        pose = np.stack([d["smpl_pose"] for d in self.datalist])
        shape = np.stack([d["smpl_shape"] for d in self.datalist])
        trans = np.stack([d["smpl_trans"] for d in self.datalist])
        R = np.stack([d["cam_param"]["R"] for d in self.datalist])
        t = np.stack([d["cam_param"]["t"] for d in self.datalist])
        genders = np.array([d.get("gender", "neutral") for d in self.datalist])

        # Per-gender batched LBS (reference: mesh_model.layer[gender],
        # Human36M/dataset.py:254,278 — gender is 'neutral' for the shipped
        # annotations but the per-sample field is honored when present).
        mesh_mm = np.zeros((n, self.mesh_model.vertex_num, 3), np.float32)
        for gender in np.unique(genders):
            sel = np.flatnonzero(genders == gender)
            params = self._layer(str(gender))

            def fn(p, s, tr, R_, t_, _params=params):
                return posed_mesh_cam(_params, p, s, tr, R_, t_)

            part, _ = batched_gt(
                fn, (pose[sel], shape[sel], trans[sel], R[sel], t[sel]),
                batch=min(256, max(8, len(sel))), device=self.device)
            mesh_mm[sel] = part
        # Root-relative (reference __getitem__: mesh_cam -= joint_cam_h36m[:1])
        h36m_cam = np.stack([d["joint_cam"] for d in self.datalist])
        self.gt_mesh = (mesh_mm - h36m_cam[:, :1]).astype(np.float32)
        self.gt_reg3d = (h36m_cam - h36m_cam[:, :1]).astype(np.float32)

        # fitting error: translation-aligned h36m-regressed joints
        reg = np.asarray(self.mesh_model.joint_regressor_h36m)
        reg_j = np.einsum("jv,nvc->njc", reg, self.gt_mesh)
        reg_j = reg_j - reg_j.mean(axis=1, keepdims=True) \
            + self.gt_reg3d.mean(axis=1, keepdims=True)
        self.fit_error = np.sqrt(
            ((self.gt_reg3d - reg_j) ** 2).sum(-1)
        ).mean(-1).astype(np.float32)

        if self.input_joint_name == "coco":
            coco_reg = np.asarray(self.mesh_model.joint_regressor_coco)
            names = COCO_SET.joints_name
            lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
            lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
            for i, d in enumerate(self.datalist):
                mesh_cam = mesh_mm[i]
                jc = coco_reg @ mesh_cam
                pelvis = (jc[lhip] + jc[rhip]) * 0.5
                neck = (jc[lsho] + jc[rsho]) * 0.5
                jc = np.concatenate([jc, pelvis[None], neck[None]])
                ji = cam2pixel(jc, d["cam_param"]["focal"],
                               d["cam_param"]["princpt"])[:, :2]
                d["joint_img"] = ji.astype(np.float32)
                d["joint_cam"] = (jc - jc[-2:-1]).astype(np.float32)

    # --- detector / noise input (Human36M/dataset.py:420-452) --------------
    def replace_joint_img(self, idx, joint_img, tight_bbox, trans):
        H, W = self.input_shape
        if self.input_joint_name == "coco":
            if self.is_train:
                xmin, ymin, w, h = tight_bbox
                pts = [aug.affine_transform(np.array(p, np.float32), trans)
                       for p in ((xmin, ymin), (xmin + w, ymin),
                                 (xmin + w, ymin + h))]
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
            det = self.datalist_pose2d_det[idx]["pose2d"].copy()
            det = self._add_pelvis_neck(det)
            for i in range(len(det)):
                det[i, :2] = aug.affine_transform(det[i, :2].copy(), trans)
            return det
        # human36 input
        if self.is_train:
            noise = (self.noise_stats.sample(self.rng) / 256.0) * np.array(
                [W, H], np.float32
            )
            return joint_img[:, :2] + noise
        det = self.datalist_pose2d_det[idx]["pose2d"][:, :2].copy()
        for i in range(len(det)):
            det[i, :2] = aug.affine_transform(det[i, :2].copy(), trans)
        return det

    @staticmethod
    def _add_pelvis_neck(joints: np.ndarray) -> np.ndarray:
        names = COCO_SET.joints_name
        lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
        lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
        pelvis = (joints[lhip] + joints[rhip]) * 0.5
        neck = (joints[lsho] + joints[rsho]) * 0.5
        return np.concatenate([joints, pelvis[None], neck[None]])

    # --- evaluation (Human36M/dataset.py:514-617) --------------------------
    def evaluate(self, outs, vis_dir=None) -> Dict[str, float]:
        res = super().evaluate(outs, vis_dir=vis_dir)
        # per-action breakdown (img names embed 'act_NN')
        pred_mesh = np.asarray(outs["mesh_coord"])
        gt_mesh = np.asarray(outs["mesh_coord_target"])
        reg = np.asarray(self.mesh_model.joint_regressor_h36m)
        pred_j = np.einsum("jv,nvc->njc", reg, pred_mesh)
        gt_j = np.einsum("jv,nvc->njc", reg, gt_mesh)
        pred_j = pred_j - pred_j[:, :1]
        gt_j = gt_j - gt_j[:, :1]
        sel = list(self.eval_joints)
        err = np.sqrt(((pred_j[:, sel] - gt_j[:, sel]) ** 2).sum(-1)).mean(-1)
        per_action: Dict[str, List[float]] = {}
        for n, d in enumerate(self.datalist[: len(err)]):
            name = d["img_name"]
            k = name.find("act")
            if k < 0:
                continue
            try:
                aidx = int(name[k + 4:k + 6]) - 2
                per_action.setdefault(ACTION_NAMES[aidx], []).append(err[n])
            except (ValueError, IndexError):
                continue
        for act, v in sorted(per_action.items()):
            res[f"mpjpe_{act}"] = float(np.mean(v))
            print(f"  {act}: {res[f'mpjpe_{act}']:.2f} mm")
        return res
