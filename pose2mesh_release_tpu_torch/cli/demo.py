"""Demo CLI: 2D pose (.npy) or multi-person detections (.json) -> mesh.

Reference: demo/run.py (327 LoC).  Same interface as the JAX package's demo,
plus --device (default cuda):
  python -m pose2mesh_release_tpu_torch.cli.demo --input_pose pose.npy \
      --joint_set {human36,coco,smpl,mano} [--input_img img.png] \
      [--weights ckpt.pth.tar] [--out_dir demo_out] [--device cpu]

Pipeline per person (demo/run.py:149-197, 225-251): tight bbox -> affine
crop to the model input resolution -> per-sample mean/std normalization ->
the cascade's forward on the device (training form at train=False, as the
JAX demo runs it) -> un-permute -> regress 3D joints -> the 1500-step
weak-perspective camera fit on the device (models.camera.fit_camera) ->
z-buffer overlay render (utils.renderer) + .obj dump.  The multi-person
path reads HigherHRNet-format COCO json, adds pelvis/neck,
confidence-filters and NMS-dedups boxes (run.py:253-326).

The cascade computes in default_config().TPU.compute_dtype (bf16) on the
card, where the band kernels take bfloat16, and in float32 on the CPU.
Drawings are PNGs written by utils.vis; --input_img needs matplotlib to
decode the photo.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time
from typing import Tuple

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pose2Mesh demo (PyTorch/CUDA)")
    p.add_argument("--input_pose", type=str, required=True,
                   help=".npy (J, 2|3) single person or .json detections")
    p.add_argument("--joint_set", type=str, default="human36",
                   choices=["human36", "coco", "smpl", "mano"])
    p.add_argument("--input_img", type=str, default="")
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--out_dir", type=str, default="demo_out")
    p.add_argument("--cam_steps", type=int, default=1500)
    p.add_argument("--gpu", type=str, default="", help="ignored (see --device)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _setting(joint_set: str):
    """(mesh_model, joint_set_meta, levels, regressor) per joint set
    (demo/run.py:70-124)."""
    from ..body.mano import MANO
    from ..body.smpl import SMPL
    from ..data.joint_sets import get_joint_set

    js = get_joint_set(joint_set)
    if joint_set == "mano":
        m = MANO()
        return m, js, 6, np.asarray(m.joint_regressor_mano)
    m = SMPL()
    reg = {"human36": m.joint_regressor_h36m,
           "coco": None, "smpl": m.joint_regressor_smpl}.get(joint_set)
    if joint_set == "coco":
        reg = np.asarray(m.joint_regressor_coco)
        names = js.joints_name
        lhip, rhip = names.index("L_Hip"), names.index("R_Hip")
        lsho, rsho = names.index("L_Shoulder"), names.index("R_Shoulder")
        extra = np.zeros((2, reg.shape[1]), np.float32)
        extra[0] = 0.5 * (reg[lhip] + reg[rhip])
        extra[1] = 0.5 * (reg[lsho] + reg[rsho])
        reg = np.concatenate([reg, extra])
    return m, js, 9, np.asarray(reg, np.float32)


def _normalize_input(joint_img: np.ndarray, input_shape: Tuple[int, int]):
    """Crop + standardize exactly like training (demo/run.py:150-160)."""
    from ..utils import augment as aug
    from ..utils.coords import get_bbox, process_bbox

    H, W = input_shape
    bbox = process_bbox(get_bbox(joint_img), W / H)
    pose, trans = aug.j2d_processing(joint_img.copy(), (W, H), bbox, 0, 0, None)
    pose = pose[:, :2] / np.array([[W, H]], np.float32)
    mean, std = pose.mean(0), pose.std(0)
    return ((pose - mean) / np.maximum(std, 1e-6)).astype(np.float32), trans


CROP_SIZE = 500  # square render-crop resolution (demo/run.py:237: crop 500)


def run_person(model, art, joint_img, regressor, input_shape, cam_steps: int,
               timings: dict = None):
    """One person's mesh (V, 3) and joints (J, 3) in meters, root-relative,
    their fitted crop camera (s, tx, ty), the fit's square crop box and its
    target (J, 2) crop pixels.  `model` and `art` live on one device, where
    the camera fit runs too; `timings` (when given) receives the forward's
    and the fit's seconds."""
    import torch

    from ..models.camera import fit_camera
    from ..models.meshnet import extract_mesh
    from ..utils import augment as aug
    from ..utils.coords import get_bbox, process_bbox

    dev = art.vertex_gather.device
    t0 = time.perf_counter()
    norm, _ = _normalize_input(joint_img[:, :2], input_shape)
    with torch.inference_mode():
        mesh_dev, _pose3d = model(art, torch.from_numpy(norm)[None].to(dev))
        mesh = extract_mesh(art, mesh_dev)[0].float().cpu().numpy()  # (V, 3) meters
    t1 = time.perf_counter()
    joints3d = regressor @ mesh                                      # (J, 3) meters
    root = joints3d[:1]
    mesh = mesh - root
    joints3d = joints3d - root

    # square 1.25x crop for the camera fit (demo/run.py:150-153)
    bbox1 = process_bbox(get_bbox(joint_img), aspect_ratio=1.0, scale=1.25)
    target, _trans = aug.j2d_processing(
        joint_img.copy(), (CROP_SIZE, CROP_SIZE), bbox1, 0, 0, None)
    target = target[:, :2].astype(np.float32)
    t2 = time.perf_counter()
    cam = fit_camera(joints3d, target, num_steps=cam_steps, img_res=CROP_SIZE,
                     device=dev).cpu().numpy()
    if timings is not None:
        timings.update(forward_s=t1 - t0, camera_s=time.perf_counter() - t2)
    return mesh, joints3d, cam, bbox1, target


def _nms_people(dets, joint_thr=0.1, box_iou_thr=0.6):
    """Confidence filter + manual box NMS over detections
    (demo/run.py:277-306)."""
    people = []
    for d in dets:
        kp = np.array(d["keypoints"], np.float32).reshape(-1, 3)
        if kp[:, 2].mean() < joint_thr:
            continue
        people.append(kp)
    kept = []
    for kp in sorted(people, key=lambda k: -k[:, 2].mean()):
        x0, y0 = kp[:, 0].min(), kp[:, 1].min()
        x1, y1 = kp[:, 0].max(), kp[:, 1].max()
        dup = False
        for other in kept:
            ox0, oy0 = other[:, 0].min(), other[:, 1].min()
            ox1, oy1 = other[:, 0].max(), other[:, 1].max()
            ix = max(0, min(x1, ox1) - max(x0, ox0))
            iy = max(0, min(y1, oy1) - max(y0, oy0))
            inter = ix * iy
            union = ((x1 - x0) * (y1 - y0) + (ox1 - ox0) * (oy1 - oy0)
                     - inter + 1e-9)
            if inter / union > box_iou_thr:
                dup = True
                break
        if not dup:
            kept.append(kp)
    return kept


def _read_image(path: str) -> np.ndarray:
    try:
        import matplotlib.image as mpimg
    except ImportError as e:
        raise RuntimeError("--input_img needs matplotlib to decode the photo, and it is "
                           "not installed") from e
    img = np.asarray(mpimg.imread(path))[..., :3]
    return (img * 255).astype(np.uint8) if img.max() <= 1.0 else img


def main(argv=None):
    """Returns {"people": [{"obj", "cam", "joints3d", "target2d",
    "forward_s", "camera_s"}, ...]}: per person its .obj path, its camera
    and the fit's inputs (root-relative joints in meters, crop pixels)."""
    args = parse_args(argv)
    import torch

    from ..config import default_config
    from ..core.checkpoint import load_checkpoint
    from ..data.base import pyramid_for
    from ..device import resolve_device
    from ..models.camera import crop_cam_to_orig_params
    from ..models.pose2mesh import Pose2Mesh
    from ..utils.io import save_obj
    from ..utils.renderer import render_mesh_overlay
    from ..utils.vis import vis_2d_pose, write_png

    cfg = default_config()
    dev = resolve_device(args.device)
    dtype = (torch.bfloat16 if dev.type == "cuda" and cfg.TPU.compute_dtype == "bf16"
             else torch.float32)
    os.makedirs(args.out_dir, exist_ok=True)
    mesh_model, js, levels, regressor = _setting(args.joint_set)
    art_host = pyramid_for(np.asarray(mesh_model.face), js, levels)
    art = art_host.to(dev, dtype)
    model = Pose2Mesh(js.joint_num, art_host.mesh_ops[-1].num_vertices,
                      mano=args.joint_set == "mano", dtype=dtype, inference_fused=False,
                      device=dev, generator=torch.Generator().manual_seed(0))
    if args.weights:
        model.load_state_dict(load_checkpoint(args.weights, pick_best=True,
                                              device=dev)["model_state_dict"])
    else:
        print("WARNING: no --weights given; using random init (shapes demo)")

    img = _read_image(args.input_img) if args.input_img and osp.exists(args.input_img) \
        else None

    if args.input_pose.endswith(".json"):
        with open(args.input_pose) as f:
            people = _nms_people(json.load(f))
    else:
        people = [np.load(args.input_pose).astype(np.float32)]

    out = []
    canvas = img
    for i, kp in enumerate(people):
        kp = np.asarray(kp, np.float32)
        if kp.shape[1] == 2:
            kp = np.concatenate([kp, np.ones((len(kp), 1), np.float32)], 1)
        if args.joint_set == "coco" and len(kp) == 17:
            pelvis = 0.5 * (kp[11] + kp[12])
            neck = 0.5 * (kp[5] + kp[6])
            kp = np.concatenate([kp, pelvis[None], neck[None]])
        timings = {}
        mesh, joints3d, cam, fit_bbox, target = run_person(
            model, art, kp, regressor, cfg.MODEL.input_shape, args.cam_steps, timings)
        obj = osp.join(args.out_dir, f"person_{i}.obj")
        save_obj(mesh, np.asarray(mesh_model.face), obj)
        vis_2d_pose(kp, img if img is not None else (1000, 1000), js.skeleton,
                    out_path=osp.join(args.out_dir, f"person_{i}_pose2d.png"))
        if img is not None:
            # crop cam -> original-image pixel params, overlay on the input
            # photo (demo/run.py:24-43 + render at :241), people accumulating
            canvas = render_mesh_overlay(canvas, mesh, np.asarray(mesh_model.face),
                                         np.asarray(crop_cam_to_orig_params(cam, fit_bbox)))
            write_png(osp.join(args.out_dir, f"person_{i}_overlay.png"), canvas)
        out.append({"obj": obj, "cam": cam.tolist(), "joints3d": joints3d.tolist(),
                    "target2d": target.tolist(), **timings})
        print(f"person {i}: mesh -> person_{i}.obj (cam s={cam[0]:.2f})")
    print(f"demo outputs in {args.out_dir}")
    return {"people": out}


if __name__ == "__main__":
    main()
