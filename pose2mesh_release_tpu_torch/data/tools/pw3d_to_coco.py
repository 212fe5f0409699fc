"""Offline converter: 3DPW sequence pickles -> COCO-format annotation json.

Reference: data/3dpw2coco.py (232 LoC, per-frame torch loop).  Reads the
official 3DPW `sequenceFiles/<split>/*.pkl` (keys: sequence, betas, poses,
trans, jointPositions, genders, campose_valid, cam_poses, cam_intrinsics,
poses2d) and writes `3DPW_latest_<split>.json` in the layout
data/pw3d.py consumes, key for key the JAX package's converter's.  The
camera fold (world->cam root-rotation + root-pivot translation
compensation) is the math of gt_synth.posed_mesh_cam, run as one batched
LBS per (person, sequence) on `device` (default the card) instead of a
python loop per frame.

Usage:
  python -m pose2mesh_release_tpu_torch.data.tools.pw3d_to_coco \
      --root /path/to/3dpw --split test --out 3DPW_latest_test.json [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os.path as osp
import pickle
from typing import Dict, List

import numpy as np
import torch

from ...body.model import lbs_forward, rodrigues
from ...body.smpl import SMPL
from ..gt_synth import batched_gt, mat2axisang
from ...utils.coords import cam2pixel

__all__ = ["convert_split", "convert_sequence"]


def _fold_camera_into_params(params, poses, shapes, trans, Rs, ts, device):
    """World-frame SMPL params + per-frame extrinsics -> camera-frame
    (pose', trans') as 3dpw2coco.py:139-160 computes them, batched on
    `device`."""

    def fn(pose, shape, tr, R, t):
        root_cam = mat2axisang(R @ rodrigues(pose[:, :3]))
        pose_cam = torch.cat([root_cam, pose[:, 3:]], dim=1)
        _, joints = lbs_forward(params, pose_cam, shape)
        root = joints[:, :1]
        tr_cam = (
            torch.einsum("nab,nb->na", R, tr)[:, None] + t[:, None]
            - root + torch.einsum("nab,njb->nja", R, root)
        )[:, 0]
        return pose_cam, tr_cam

    return batched_gt(fn, (poses, shapes, trans, Rs, ts),
                      batch=min(256, max(8, len(poses))), device=device)


def convert_sequence(pkl_path: str, smpl: SMPL, img_id0: int, annot_id0: int,
                     bbox_margin: float = 1.2,
                     device: str | torch.device | None = "cuda") -> Dict[str, list]:
    with open(pkl_path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    seq = str(data["sequence"])
    betas = [np.asarray(b, np.float32)[:10] for b in data["betas"]]
    poses = [np.asarray(p, np.float32) for p in data["poses"]]
    trans = [np.asarray(t, np.float32) for t in data["trans"]]
    joints3d = [np.asarray(j, np.float32) for j in data["jointPositions"]]
    genders = data["genders"]
    valid = np.asarray(data["campose_valid"])
    ext = np.asarray(data["cam_poses"], np.float32)
    K = np.asarray(data["cam_intrinsics"], np.float32)
    poses2d = np.asarray(data["poses2d"], np.float32)
    Rs, ts = ext[:, :3, :3], ext[:, :3, 3]
    focal = [float(K[0, 0]), float(K[1, 1])]
    princpt = [float(K[0, 2]), float(K[1, 2])]
    width = int(2 * princpt[0])
    height = int(2 * princpt[1])

    images, annotations = [], []
    img_id, annot_id = img_id0, annot_id0
    n_frames = len(Rs)
    # per-person batched camera fold over all frames at once
    folded = []
    for pid in range(len(betas)):
        pose_cam, tr_cam = _fold_camera_into_params(
            smpl.layer("neutral"),
            poses[pid][:n_frames],
            np.tile(betas[pid], (n_frames, 1)),
            trans[pid][:n_frames], Rs, ts, device,
        )
        folded.append((np.asarray(pose_cam), np.asarray(tr_cam)))

    for iid in range(n_frames):
        images.append({
            "id": img_id, "file_name": f"image_{iid:05d}.jpg",
            "sequence": seq, "frame_idx": iid,
            "width": width, "height": height,
            "cam_param": {"focal": focal, "princpt": princpt,
                          "R": Rs[iid].tolist(), "t": ts[iid].tolist()},
        })
        for pid in range(len(betas)):
            if not valid[pid][iid]:
                continue
            jw = joints3d[pid][iid].reshape(-1, 3)
            jc = jw @ Rs[iid].T + ts[iid]
            ji = cam2pixel(jc, focal, princpt)
            inside = ((ji[:, 0] >= 0) & (ji[:, 0] < width)
                      & (ji[:, 1] >= 0) & (ji[:, 1] < height))
            if not inside.any():
                continue
            xy = ji[inside, :2]
            c = (xy.min(0) + xy.max(0)) * 0.5
            wh = (xy.max(0) - xy.min(0)) * bbox_margin
            bbox = [float(c[0] - wh[0] / 2), float(c[1] - wh[1] / 2),
                    float(wh[0]), float(wh[1])]
            annotations.append({
                "id": annot_id, "image_id": img_id, "person_id": pid,
                "joint_cam": jc.tolist(),
                "joint_img": ji[:, :2].tolist(),
                "openpose_result": poses2d[pid][iid].transpose(1, 0).tolist()
                if poses2d.ndim >= 3 else [],
                "smpl_param": {
                    "pose": folded[pid][0][iid].reshape(-1).tolist(),
                    "shape": betas[pid].tolist(),
                    "trans": folded[pid][1][iid].reshape(-1).tolist(),
                    "gender": "female" if str(genders[pid]).startswith("f")
                              else "male",
                },
                "bbox": bbox,
            })
            annot_id += 1
        img_id += 1
    return {"images": images, "annotations": annotations}


def convert_split(root: str, split: str, out_path: str,
                  device: str | torch.device | None = "cuda") -> Dict[str, int]:
    smpl = SMPL()
    images: List[dict] = []
    annotations: List[dict] = []
    for pkl in sorted(glob.glob(osp.join(root, "sequenceFiles", split, "*.pkl"))):
        part = convert_sequence(pkl, smpl, len(images), len(annotations), device=device)
        images.extend(part["images"])
        annotations.extend(part["annotations"])
    with open(out_path, "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return {"images": len(images), "annotations": len(annotations)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="test",
                   choices=["train", "validation", "test"])
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the camera fold's LBS runs (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    out = args.out or f"3DPW_latest_{args.split}.json"
    stats = convert_split(args.root, args.split, out, device=args.device)
    print(f"wrote {out}: {stats}")


if __name__ == "__main__":
    main()
