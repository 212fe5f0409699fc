"""Dataset base: graph pyramid, cached GT synthesis, sample pipeline, metrics.

Every dataset in the reference duplicates the same machinery
(data/<X>/dataset.py): a datalist of per-image records, a per-sample
__getitem__ that synthesizes SMPL/MANO GT and augments the 2-D input, and
numpy evaluation helpers consumed by the engine (lib/core/base.py:53-63,
205-230).  Here, as in the JAX package, that machinery lives once:

  * GT meshes/joints are synthesized ONCE at build time by the batched LBS
    (`data.gt_synth`) on the dataset's `device` (default "cuda") and cached
    as host numpy arrays; the reference instead runs a full per-sample LBS
    inside its dataloader workers (Human36M/dataset.py:344).
  * __getitem__ is cheap numpy on the cached arrays (2-D augmentation,
    normalization, noise); `get_batch` is the same over a whole batch, its
    point math as torch ops on the batch's device (data/pipeline.py).
  * metric helpers are vectorized numpy.
  * `graph` is the coarsening pyramid packed on the CPU at dense_threshold
    1024 (`pyramid_for`); the caller moves it with `art.to(device, dtype)`.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..graphs.artifact import PyramidArtifact, pack_pyramid
from ..graphs.build import build_pyramid
from ..utils import augment as aug
from ..utils.coords import get_bbox, process_bbox, rigid_align
from .joint_sets import HUMAN36_EVAL_JOINTS, JointSet, get_joint_set
from .pipeline import batch_pipeline

__all__ = ["MeshDataset", "pyramid_for", "clear_pyramid_cache"]

# The coarsening pyramid is deterministic per (topology, joint set, levels,
# dense threshold): share it across dataset instances within a process.
_PYRAMID_CACHE: Dict[Tuple, PyramidArtifact] = {}


def pyramid_for(
    faces: np.ndarray,
    joint_set: JointSet,
    levels: int,
    dense_threshold: int = 1024,
) -> PyramidArtifact:
    """The packed pyramid of `faces` and `joint_set`, float32 on the CPU.

    dense_threshold 1024, the JAX datasets' default: SMPL's 981-vertex
    level and the whole MANO pyramid are dense (`deploy.build_artifact`
    packs at 768)."""
    key = (faces.shape, int(faces.sum()), joint_set.name, levels, dense_threshold)
    art = _PYRAMID_CACHE.get(key)
    if art is None:
        pyr = build_pyramid(
            faces,
            joint_num=joint_set.joint_num,
            skeleton=joint_set.skeleton,
            flip_pairs=joint_set.flip_pairs,
            levels=levels,
            extra_joint_edges=joint_set.extra_edges,
        )
        art = pack_pyramid(pyr, faces, dense_threshold=dense_threshold,
                           device="cpu")
        _PYRAMID_CACHE[key] = art
    return art


def clear_pyramid_cache() -> None:
    _PYRAMID_CACHE.clear()


class MeshDataset:
    """Base class for all pose->mesh datasets.

    Subclasses set the metadata class attributes, implement `load_data()`
    returning a list of record dicts, and (for mesh-supervised sets)
    `synthesize_gt()` filling the cached GT arrays.  Records carry:

      joint_img   (J_in, 2|3) float  2-D input pose in pixels
      joint_cam   (J_in, 3)   float  3-D pose, camera frame, millimeters
      joint_valid (J_in,)     float  per-joint validity (optional, def. 1)
      bbox        (4,)        float  xywh crop box (optional: from joints)

    and the base caches, when mesh supervision exists:

      gt_mesh     (N, V, 3) float32  camera-frame GT mesh, millimeters
      gt_reg3d    (N, 17|J, 3)       target-joint-set GT pose (mm)
      fit_error   (N,)               SMPL-fit error for validity masking

    device: where GT synthesis runs and where `get_batch` puts its batch
    (default "cuda"; raises without CUDA unless "cpu").  mesh_dtype:
    the dtype `get_batch` copies the GT mesh in (torch.float16 halves the
    dominant host-to-device payload; it is rounded before the rotation,
    which runs in float32, and reaches the step as float32).
    """

    # --- subclass metadata -------------------------------------------------
    name: str = "base"
    levels: int = 9
    input_joint_name: str = "coco"
    target_joint_name: str = "human36"
    fitting_thr: float = 25.0  # millimeters (Human36M/dataset.py:37)
    has_gt_mesh: bool = True

    def __init__(
        self,
        data_split: str = "train",
        *,
        mesh_model=None,
        input_shape: Tuple[int, int] = (384, 288),  # (H, W), cfg.MODEL.input_shape
        use_gt_input: bool = True,
        model_name: str = "pose2mesh_net",
        build_graph: bool = True,
        debug: bool = False,
        seed: int = 0,
        device: str | torch.device | None = "cuda",
        mesh_dtype: torch.dtype = torch.float32,
    ):
        if mesh_dtype not in (torch.float32, torch.float16):
            raise ValueError(f"mesh_dtype={mesh_dtype}: expected torch.float32 or "
                             "torch.float16")
        self.device = resolve_device(device)
        self.mesh_dtype = mesh_dtype
        self.data_split = data_split
        self.is_train = data_split == "train"
        self.mesh_model = mesh_model
        self.input_shape = tuple(input_shape)
        self.use_gt_input = use_gt_input
        self.model_name = model_name
        self.debug = debug
        self.rng = np.random.default_rng(seed)

        self.joint_set = get_joint_set(self.input_joint_name)
        self.joint_num = self.joint_set.joint_num
        self.skeleton = self.joint_set.skeleton
        self.flip_pairs = self.joint_set.flip_pairs
        self.root_joint_idx = self.joint_set.root_joint_idx

        self.datalist: List[dict] = self.load_data()
        # cached GT arrays (filled by synthesize_gt for mesh datasets)
        self.gt_mesh: Optional[np.ndarray] = None
        self.gt_reg3d: Optional[np.ndarray] = None
        self.fit_error: Optional[np.ndarray] = None
        if self.has_gt_mesh and self.datalist:
            self.synthesize_gt()

        self.graph: Optional[PyramidArtifact] = None
        if build_graph and mesh_model is not None:
            self.graph = pyramid_for(
                np.asarray(mesh_model.face), self.joint_set, self.levels
            )

    # --- subclass hooks ----------------------------------------------------
    def load_data(self) -> List[dict]:
        raise NotImplementedError

    def synthesize_gt(self) -> None:
        """Fill self.gt_mesh / gt_reg3d / fit_error (batched LBS)."""
        raise NotImplementedError

    def _layer(self, *gender: str):
        """The mesh model's LBS parameters (of `gender`), on self.device."""
        return self.mesh_model.layer(*gender).to(self.device)

    def replace_joint_img(self, idx: int, joint_img: np.ndarray,
                          tight_bbox: np.ndarray, trans: np.ndarray) -> np.ndarray:
        """Detector-input / synthetic-noise replacement hook
        (Human36M/dataset.py:420-452)."""
        return joint_img

    # --- sample pipeline ---------------------------------------------------
    def __len__(self) -> int:
        return len(self.datalist)

    def _augm_params(self) -> Tuple[bool, float]:
        return aug.augm_params(
            is_train=self.is_train, flip_enabled=True, rotate_factor=30.0,
            rng=self.rng,
        )

    def __getitem__(self, idx: int):
        rec = self.datalist[idx]
        flip, rot = self._augm_params()

        joint_img = np.array(rec["joint_img"][:, :2], np.float32)
        joint_cam = np.array(rec["joint_cam"], np.float32)
        joint_valid = np.array(
            rec.get("joint_valid", np.ones(len(joint_cam), np.float32)), np.float32
        ).reshape(-1)

        mesh_cam = None
        reg3d = None
        fit_err = None
        if self.gt_mesh is not None:
            mesh_cam = np.asarray(self.gt_mesh[idx], np.float32)
            reg3d = np.asarray(self.gt_reg3d[idx], np.float32)
            fit_err = float(self.fit_error[idx]) if self.fit_error is not None else None

        # crop box: tight around the 2-D pose (Human36M/dataset.py:364-368);
        # the annotation bbox only pre-filters records at load time.
        tight_bbox = get_bbox(joint_img)
        bbox = process_bbox(tight_bbox.copy(),
                            self.input_shape[1] / self.input_shape[0])
        if bbox is None:
            bbox = tight_bbox

        H, W = self.input_shape
        joint_img, trans = aug.j2d_processing(
            joint_img, (W, H), bbox, rot, 0, None
        )
        if not self.use_gt_input:
            joint_img = self.replace_joint_img(idx, joint_img, tight_bbox, trans)
        if flip:
            joint_img = aug.flip_2d_joint(joint_img, W, self.flip_pairs)
        joint_cam = aug.j3d_processing(joint_cam, rot, flip, self.flip_pairs)
        if flip or rot != 0:
            if mesh_cam is not None:
                mesh_cam = aug.j3d_processing(mesh_cam, rot, flip, ())
            if reg3d is not None:
                reg3d = aug.j3d_processing(reg3d, rot, flip,
                                           self.target_flip_pairs())

        # pixels -> [0, 1] -> per-sample standardization
        # (Human36M/dataset.py:383-388; identical in demo/run.py:156-159)
        joint_img = joint_img[:, :2] / np.array([[W, H]], np.float32)
        mean, std = joint_img.mean(axis=0), joint_img.std(axis=0)
        joint_img = (joint_img - mean) / np.maximum(std, 1e-6)

        if self.model_name == "posenet":
            valid = joint_valid.reshape(-1, 1).astype(np.float32)
            if fit_err is not None and fit_err > self.fitting_thr \
                    and self.input_joint_name == "coco":
                valid = np.zeros_like(valid)
            return joint_img.astype(np.float32), joint_cam.astype(np.float32), valid

        V = self.mesh_model.vertex_num if self.mesh_model is not None else 0
        # mesh validity is PER SAMPLE (fit-error / missing-GT invalidation
        # zeroes whole samples in every dataset), so the mask is a (1, 1)
        # broadcast scalar — shipping a (V, 1) per-vertex copy doubled the
        # host->device bytes of every training batch for no information
        if mesh_cam is None:
            mesh_cam = np.zeros((V, 3), np.float32)
            mesh_valid = np.zeros((1, 1), np.float32)
        else:
            mesh_valid = np.ones((1, 1), np.float32)
        if reg3d is None:
            nt = len(get_joint_set(self.target_joint_name).joints_name)
            reg3d = np.zeros((nt, 3), np.float32)
            reg_valid = np.zeros((len(reg3d), 1), np.float32)
        else:
            reg_valid = np.ones((len(reg3d), 1), np.float32)
        lift_valid = (joint_valid.reshape(-1, 1) > 0).astype(np.float32)

        # fitting-error invalidation (Human36M/dataset.py:396-400)
        if fit_err is not None and fit_err > self.fitting_thr:
            mesh_valid[:] = 0
            if self.input_joint_name == "coco":
                lift_valid[:] = 0

        inputs = {"pose2d": joint_img.astype(np.float32)}
        targets = {
            "mesh": (mesh_cam / 1000.0).astype(np.float32),  # meters
            "lift_pose3d": joint_cam.astype(np.float32),      # millimeters
            "reg_pose3d": reg3d.astype(np.float32),           # millimeters
        }
        meta = {
            "mesh_valid": mesh_valid,
            "lift_pose3d_valid": lift_valid,
            "reg_pose3d_valid": reg_valid,
        }
        return inputs, targets, meta

    def target_flip_pairs(self) -> Tuple[Tuple[int, int], ...]:
        return get_joint_set(self.target_joint_name).flip_pairs

    # --- vectorized batch path (data/pipeline.py) ---------------------------
    def supports_batch(self) -> bool:
        """The fused pipeline covers the GT-input pose2mesh path; detector
        replacement / PoseFix noise need the per-sample hook."""
        return (self.model_name == "pose2mesh_net" and self.use_gt_input
                and self.gt_mesh is not None and len(self.datalist) > 0)

    def get_batch(self, indices, device: str | torch.device | None = None):
        """Whole-batch __getitem__ with identical semantics
        (pipeline.batch_pipeline): the batch's rows of the host cache,
        copied to `device` (default self.device; from pinned memory on the
        card, without blocking, on the current stream) and augmented there.
        Returns (inputs, targets, meta) of float32 tensors on `device`."""
        dev = self.device if device is None else resolve_device(device)
        idx = np.asarray(indices)
        joint_img = np.stack(
            [self.datalist[i]["joint_img"][:, :2] for i in idx]
        ).astype(np.float32)
        joint_cam = np.stack(
            [self.datalist[i]["joint_cam"] for i in idx]
        ).astype(np.float32)
        mesh = np.asarray(self.gt_mesh[idx], np.float32)
        half = self.mesh_dtype == torch.float16
        if half:  # meters, rounded to float16 before the rotation
            mesh = (mesh / 1000.0).astype(np.float16)
        reg3d = np.asarray(self.gt_reg3d[idx], np.float32)

        out = batch_pipeline(
            joint_img, joint_cam, self.input_shape, self.flip_pairs,
            is_train=self.is_train, rng=self.rng, mesh_cam=mesh, reg3d=reg3d,
            target_flip_pairs=self.target_flip_pairs(), device=dev,
        )
        B = len(idx)
        # per-sample broadcast mask (see __getitem__ note)
        mesh_valid = np.ones((B, 1, 1), np.float32)
        lift_valid = np.ones((B, joint_cam.shape[1], 1), np.float32)
        reg_valid = np.ones((B, reg3d.shape[1], 1), np.float32)
        if self.fit_error is not None:
            bad = self.fit_error[idx] > self.fitting_thr
            mesh_valid[bad] = 0.0
            if self.input_joint_name == "coco":
                lift_valid[bad] = 0.0
        inputs = {"pose2d": out["pose2d"]}
        targets = {"mesh": out["mesh"] if half else out["mesh"] / 1000.0,
                   "lift_pose3d": out["lift_pose3d"],
                   "reg_pose3d": out["reg_pose3d"]}
        meta = {"mesh_valid": to_device(mesh_valid, dev),
                "lift_pose3d_valid": to_device(lift_valid, dev),
                "reg_pose3d_valid": to_device(reg_valid, dev)}
        return inputs, targets, meta

    # --- metrics (numpy, engine contract base.py:205-230) -------------------
    @property
    def eval_joints(self) -> Sequence[int]:
        if self.target_joint_name == "human36":
            return list(HUMAN36_EVAL_JOINTS)
        return list(range(get_joint_set(self.target_joint_name).joint_num))

    def compute_joint_err(self, pred_joint: np.ndarray,
                          target_joint: np.ndarray) -> float:
        """Root-aligned MPJPE over the eval subset, millimeters."""
        pred = pred_joint - pred_joint[:, :1]
        gt = target_joint - target_joint[:, :1]
        sel = self.eval_joints
        pred, gt = pred[:, sel], gt[:, sel]
        return float(np.sqrt(((pred - gt) ** 2).sum(-1)).mean())

    def compute_both_err(self, pred_mesh: np.ndarray, target_mesh: np.ndarray,
                         pred_joint: np.ndarray, target_joint: np.ndarray
                         ) -> Tuple[float, float]:
        """(joint err, mesh vertex err) root-aligned, millimeters."""
        root_p = pred_joint[:, self.target_root_idx():self.target_root_idx() + 1]
        root_g = target_joint[:, self.target_root_idx():self.target_root_idx() + 1]
        pm = pred_mesh - root_p
        gm = target_mesh - root_g
        pj = pred_joint - root_p
        gj = target_joint - root_g
        sel = self.eval_joints
        j_err = float(np.sqrt(((pj[:, sel] - gj[:, sel]) ** 2).sum(-1)).mean())
        v_err = float(np.sqrt(((pm - gm) ** 2).sum(-1)).mean())
        return j_err, v_err

    def target_root_idx(self) -> int:
        return get_joint_set(self.target_joint_name).root_joint_idx

    def evaluate_joint(self, outs: Dict[str, np.ndarray]) -> Dict[str, float]:
        """PoseNet evaluation: MPJPE + PA-MPJPE over the eval subset."""
        pred = np.asarray(outs["joint_coord"])
        gt = np.stack([d["joint_cam"] for d in self.datalist])[: len(pred)]
        pred = pred - pred[:, :1]
        gt = gt - gt[:, :1]
        sel = self.eval_joints if self.input_joint_name == self.target_joint_name \
            else list(range(pred.shape[1]))
        mpjpe = float(np.sqrt(((pred[:, sel] - gt[:, sel]) ** 2).sum(-1)).mean())
        pa = np.stack([rigid_align(p, g) for p, g in zip(pred, gt)])
        pampjpe = float(np.sqrt(((pa[:, sel] - gt[:, sel]) ** 2).sum(-1)).mean())
        out = {"mpjpe": mpjpe, "pa_mpjpe": pampjpe}
        print(f"{self.name} posenet eval: MPJPE {mpjpe:.2f} mm, "
              f"PA-MPJPE {pampjpe:.2f} mm")
        return out

    def evaluate(self, outs: Dict[str, np.ndarray],
                 vis_dir: str = None) -> Dict[str, float]:
        """Mesh evaluation: regressed-joint MPJPE / PA-MPJPE + MPVPE.

        vis_dir: when set (cfg.TEST.vis), every 500th predicted mesh is
        dumped as an .obj in meters — the reference's evaluation-time
        visualization (Human36M/dataset.py:574-578, PW3D/dataset.py:377-381).
        """
        pred_mesh = np.asarray(outs["mesh_coord"])          # (N, V, 3) mm
        gt_mesh = np.asarray(outs["mesh_coord_target"])     # (N, V, 3) mm
        if vis_dir is not None:
            self._dump_vis_objs(pred_mesh, vis_dir)
        reg = self.target_regressor()
        pred_j = np.einsum("jv,nvc->njc", reg, pred_mesh)
        gt_j = np.einsum("jv,nvc->njc", reg, gt_mesh)
        root = self.target_root_idx()
        pred_mesh = pred_mesh - pred_j[:, root:root + 1]
        gt_mesh = gt_mesh - gt_j[:, root:root + 1]
        pred_j = pred_j - pred_j[:, root:root + 1]
        gt_j = gt_j - gt_j[:, root:root + 1]
        sel = self.eval_joints
        mpjpe = float(np.sqrt(((pred_j[:, sel] - gt_j[:, sel]) ** 2).sum(-1)).mean())
        pa = np.stack([rigid_align(p, g) for p, g in
                       zip(pred_j[:, sel], gt_j[:, sel])])
        pampjpe = float(np.sqrt(((pa - gt_j[:, sel]) ** 2).sum(-1)).mean())
        mpvpe = float(np.sqrt(((pred_mesh - gt_mesh) ** 2).sum(-1)).mean())
        out = {"mpjpe": mpjpe, "pa_mpjpe": pampjpe, "mpvpe": mpvpe}
        print(f"{self.name} eval: MPJPE {mpjpe:.2f} mm, PA-MPJPE "
              f"{pampjpe:.2f} mm, MPVPE {mpvpe:.2f} mm")
        return out

    def _dump_vis_objs(self, pred_mesh: np.ndarray, vis_dir: str,
                       every: int = 500) -> None:
        import os

        from ..utils.io import save_obj

        os.makedirs(vis_dir, exist_ok=True)
        for n in range(0, len(pred_mesh), every):
            save_obj(pred_mesh[n] / 1000.0, np.asarray(self.mesh_model.face),
                     osp.join(vis_dir, f"{self.name.lower()}_{n}.obj"))

    def target_regressor(self) -> np.ndarray:
        m = self.mesh_model
        return np.asarray(getattr(m, f"joint_regressor_{self.target_joint_name}"))
