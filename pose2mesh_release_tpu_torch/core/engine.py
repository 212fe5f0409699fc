"""Training/evaluation engine: Trainer / Tester / LiftTrainer / LiftTester.

Reference: lib/core/base.py (334 LoC): dataloader assembly, model build,
loss/optim/scheduler build, resume, the epoch loop bodies.  As in the JAX
package's `core/engine.py`:

  * datasets come from the name registry (data.get_dataset_class), not
    `eval(...)` dispatch (base.py:28);
  * the per-batch compute is `core.train`'s train and eval steps, fed by
    the threaded `BatchLoader`, whose batches already sit on the device;
  * checkpoints keep the reference's best/final semantics
    (funcs_utils.py:111-128, main/train.py:43-58), in its `.pth.tar` form
    (`core.checkpoint`).

Every engine takes `device=` (default "cuda") and passes it to the datasets,
the loader and the model.  On the card the band convs run on the port's
CUDA kernels, in `TPU.compute_dtype` (bf16 or f32) on every path: the
engines refuse `TPU.use_pallas: false` there; on the CPU every setting runs
through the kernels' plain versions.
Weights are drawn from a CPU `torch.Generator` seeded with `cfg.seed or 0`;
training dropout from one device generator per epoch, seeded from
(cfg.seed, epoch) and, on a mesh of several data ranks, the data rank.

Multi-device (`TPU.data_axis * TPU.graph_axis > 1`, the JAX engine's mesh):
one process per device, launched by torchrun (`cli.train` / `cli.test`
call `parallel.distributed.init_distributed` first); the mesh's size must
be the world size.  Each rank computes on cuda:LOCAL_RANK unless the caller
names a device (every rank on cuda:0 under gloo is for tests and the smoke
run).  The engines run the same steps on the mesh (`core.train`): each data
rank trains on its rows of every global batch (the loader's `data_rank`),
graph ranks split the band levels (`parallel.sharding.shard_artifact`),
rank 0's state is broadcast at the start, and a step equals the
single-device step of the global batch.  Graph ranks of one data index draw
the same dropout mask (the seed has no graph index), which keeps the
replicated PoseNet and dense levels equal.  Testers gather the predictions
of every data rank on every rank.  Rank 0 alone writes checkpoints,
metrics.jsonl, plots and prints, each save followed by a barrier; resume
reads on every rank.  steps_per_dispatch > 1 is refused on a mesh, as the
JAX engine refuses it.
"""
from __future__ import annotations

import os.path as osp
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..body.mano import MANO
from ..body.smpl import SMPL
from ..config import Config
from ..data import BatchLoader, MultipleDatasets, get_dataset_class
from ..device import resolve_device
from ..models.fold import fold_bn_variables
from ..models.pose2mesh import Pose2Mesh
from ..models.posenet import PoseNet
from ..parallel.collectives import barrier, broadcast_object
from ..parallel.distributed import is_primary, local_rank
from ..parallel.mesh import make_mesh
from ..parallel.sharding import shard_artifact, shard_state
from ..train_setup import train_batch
from ..utils.metrics_log import MetricsLogger
from ..utils.plots import save_plot
from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .optim import ReduceLROnPlateau, make_preconditioner, multistep_lr
from .train import (TrainState, make_eval_step, make_multi_train_step,
                    make_posenet_steps, make_train_step)

__all__ = ["Trainer", "Tester", "LiftTrainer", "LiftTester", "build_datasets"]


def _mesh_model_for(joint_set: str, data_dir: str):
    """MANO for the hand, else SMPL with its joint regressors read from the
    data directory (<data_dir>/Human36M/..., <data_dir>/COCO/...)."""
    return MANO() if joint_set == "mano" else SMPL(data_dir=data_dir)


def build_datasets(cfg: Config, split: str, mesh_model, *, model_name: str,
                   debug: bool = False, device: str | torch.device | None = "cuda") -> List:
    names = (cfg.DATASET.train_list if split == "train"
             else cfg.DATASET.test_list)
    out = []
    for name in names:
        kwargs: Dict[str, Any] = dict(
            mesh_model=mesh_model,
            input_shape=cfg.MODEL.input_shape,
            use_gt_input=cfg.DATASET.use_gt_input,
            model_name=model_name,
            debug=debug,
            device=device,
        )
        if name == "Human36M":
            kwargs["input_joint_name"] = cfg.DATASET.input_joint_set
        out.append(get_dataset_class(name)(split, data_dir=osp.join(cfg.data_dir, name),
                                           **kwargs))
    return out


def _epoch_generator(seed: int, epoch: int, device: torch.device, mesh=None
                     ) -> torch.Generator:
    """The dropout noise of one epoch, seeded from (seed, epoch) and, with
    several data ranks, this rank's data index."""
    key = [seed, epoch] + ([mesh.data_rank] if mesh is not None and mesh.data > 1 else [])
    state = int(np.random.SeedSequence(key).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


def _mean(totals: List[torch.Tensor]) -> float:
    """Mean of the per-step losses in float64, as the JAX engine takes it."""
    if not totals:
        return 0.0
    return float(np.mean(torch.stack(totals).cpu().numpy().astype(np.float64)))


def _mesh_for(cfg: Config, mesh):
    """The (data, graph) mesh cfg.TPU asks for (None for 1 x 1); its size
    must be the number of processes."""
    d, g = cfg.TPU.data_axis, cfg.TPU.graph_axis
    world = dist.get_world_size() if dist.is_initialized() else 1
    if d * g != world:
        raise ValueError(
            f"cfg.TPU asks for a {d}x{g} mesh, {world} process(es) running: launch one "
            f"process per device, e.g. torchrun --nproc_per_node {d * g} -m "
            f"pose2mesh_release_tpu_torch.cli.train --cfg ...")
    if mesh is not None and (mesh.data, mesh.graph) != (d, g):
        raise ValueError(f"a {mesh.data}x{mesh.graph} mesh given for cfg.TPU's {d}x{g}")
    if mesh is None and d * g > 1:
        mesh = make_mesh(g)
    return mesh


class _Base:
    """Common: mesh, device, compute dtype and the checks of what the port
    runs.  mesh: the Trainer's, shared with its Tester (else built)."""

    def __init__(self, cfg: Config, *, debug: bool = False,
                 device: str | torch.device | None = "cuda", mesh=None):
        self.cfg = cfg
        self.debug = debug
        self.mesh = _mesh_for(cfg, mesh)
        if self.mesh is not None and torch.device(device or "cuda") == torch.device("cuda"):
            device = torch.device("cuda", local_rank())
        self.device = resolve_device(device)
        if self.mesh is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.primary = is_primary()
        self.seed = cfg.seed or 0
        if self.device.type == "cuda" and not cfg.TPU.use_pallas:
            raise ValueError("cfg.TPU.use_pallas: false on CUDA: the band convs on the card "
                             "are the CUDA kernels; their plain versions are for the CPU")
        if cfg.TPU.compute_dtype not in ("bf16", "f32"):
            raise ValueError(f"cfg.TPU.compute_dtype {cfg.TPU.compute_dtype!r}: bf16 or f32")
        self.dtype = torch.bfloat16 if cfg.TPU.compute_dtype == "bf16" else torch.float32

    def _build_cascade(self, joint_num: int, art, mano: bool, deploy: bool = False):
        return Pose2Mesh(joint_num, art.mesh_ops[-1].num_vertices, mano=mano,
                         posenet_hidden=self.cfg.MODEL.posenet_hidden, dtype=self.dtype,
                         inference_fused=deploy, device=self.device,
                         generator=torch.Generator().manual_seed(self.seed), mesh=self.mesh)

    def _art_on_device(self, art):
        """The operators in the compute dtype on the device, split over the
        mesh's graph axis."""
        art = art.to(self.device, self.dtype)
        return shard_artifact(art, self.mesh) if self.mesh is not None else art

    def _loader_rows(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return {"data_rank": self.mesh.data_rank, "data_ranks": self.mesh.data}

    def _saved(self) -> None:
        """After rank 0's save: every rank waits until the file is there."""
        if self.mesh is not None:
            barrier(self.mesh)


class Trainer(_Base):
    """Pose2Mesh trainer (lib/core/base.py:97-164).

    datasets / test_dataset / mesh_model: built from cfg when None.
    model: a training-form `Pose2Mesh` on `device`, trained with the
    weights it holds; when None one is built from cfg with seeded weights.
    """

    def __init__(self, cfg: Config, *, resume: bool = False,
                 debug: bool = False, datasets: Optional[List] = None,
                 test_dataset=None, model: Optional[Pose2Mesh] = None, mesh_model=None,
                 device: str | torch.device | None = "cuda"):
        super().__init__(cfg, debug=debug, device=device)
        if cfg.TPU.steps_per_dispatch > 1 and self.mesh is not None:
            raise ValueError("cfg.TPU.steps_per_dispatch > 1 requires a 1x1 mesh, as the "
                             "JAX engine does")
        if mesh_model is None:
            mesh_model = (datasets[0].mesh_model if datasets
                          else _mesh_model_for(cfg.DATASET.input_joint_set, cfg.data_dir))
        self.mesh_model = mesh_model
        self.datasets = datasets if datasets is not None else build_datasets(
            cfg, "train", mesh_model, model_name="pose2mesh_net", debug=debug,
            device=self.device)
        main = self.datasets[0]
        self.art = main.graph
        # the operators in the compute dtype on the device, once per engine
        # (the in-epoch eval shares them)
        self.art_dev = self._art_on_device(main.graph)
        self.joint_num = main.joint_num
        self.loader = BatchLoader(
            MultipleDatasets(self.datasets, make_same_len=True)
            if len(self.datasets) > 1 else self.datasets[0],
            cfg.TRAIN.batch_size, shuffle=cfg.TRAIN.shuffle, drop_last=True,
            num_workers=cfg.DATASET.workers, device=self.device, **self._loader_rows())

        self.model = model if model is not None else self._build_cascade(
            self.joint_num, main.graph, mano=cfg.DATASET.input_joint_set == "mano")
        if self.mesh is not None:
            shard_state(self.model.use_mesh(self.mesh), self.mesh)
        self.optimizer = make_preconditioner(cfg.TRAIN.optimizer, self.model.parameters())
        self.lr_at = multistep_lr(cfg.TRAIN.lr, cfg.TRAIN.lr_step, cfg.TRAIN.lr_factor)
        self._train_step = make_train_step(
            self.model, self.optimizer, main.target_regressor(),
            normal_weight=cfg.MODEL.normal_loss_weight,
            edge_weight=cfg.MODEL.edge_loss_weight,
            joint_weight=cfg.MODEL.joint_loss_weight, device=self.device, mesh=self.mesh)
        # k > 1: k loader batches stacked and run by one call
        self.steps_per_dispatch = max(1, cfg.TPU.steps_per_dispatch)
        self._multi_step = (make_multi_train_step(self._train_step)
                            if self.steps_per_dispatch > 1 else None)

        if cfg.MODEL.posenet_pretrained and cfg.MODEL.posenet_path:
            self._load_posenet(cfg.MODEL.posenet_path)
        self.state = TrainState(self.model, self.optimizer)
        self.begin_epoch = 1
        self.train_log: List[float] = []
        self.test_log: List[float] = []
        if resume:
            self._resume()
        self.tester = Tester(cfg, debug=debug, dataset=test_dataset,
                             mesh_model=mesh_model, model=self.model, device=self.device,
                             mesh=self.mesh)

    def _load_posenet(self, path: str) -> None:
        """A pretrained PoseNet checkpoint into the cascade's lifter
        (posenet.py:89-92 semantics: the best lifter weights)."""
        payload = load_checkpoint(path, pick_best=True, device=self.device)
        if payload["family"] != "posenet":
            raise ValueError(f"{path}: a {payload['family']} checkpoint, not a PoseNet one")
        self.model.pose_lifter.load_state_dict(payload["model_state_dict"])

    def _resume(self) -> None:
        path = latest_checkpoint(self.cfg.checkpoint_dir)
        if path is None:
            return
        payload = load_checkpoint(path, device=self.device)
        self.model.load_state_dict(payload["model_state_dict"])
        self.optimizer.load_state_dict(payload["optim_state_dict"])
        self.state = TrainState(self.model, self.optimizer, payload["step"])
        self.begin_epoch = payload["epoch"] + 1
        self.train_log = list(payload["train_log"])
        self.test_log = list(payload["test_log"].get("joint", []))

    def train_epoch(self, epoch: int, lr_override: Optional[float] = None) -> float:
        lr = self.lr_at(epoch) if lr_override is None else lr_override
        use_edge = epoch > self.cfg.TRAIN.edge_loss_start
        gen = _epoch_generator(self.seed, epoch, self.device, self.mesh)
        totals: List[torch.Tensor] = []
        t0 = time.time()
        k = self.steps_per_dispatch
        pending: List[Dict[str, torch.Tensor]] = []

        def flush_pending():
            stacked = {key: torch.stack([b[key] for b in pending]) for key in pending[0]}
            self.state, ls = self._multi_step(self.state, self.art_dev, stacked, lr,
                                              use_edge, gen)
            totals.extend(ls["total"].unbind(0))
            pending.clear()

        for i, batch in enumerate(self.loader):
            batch = train_batch(*batch)
            if k > 1:
                pending.append(batch)
                if len(pending) == k:
                    flush_pending()
            else:
                self.state, loss = self._train_step(self.state, self.art_dev, batch, lr,
                                                    use_edge, gen)
                totals.append(loss["total"])
            if i % self.cfg.TRAIN.print_freq == 0 and totals and self.primary:
                l_tot = float(totals[-1])
                rate = (i + 1) * self.cfg.TRAIN.batch_size / (time.time() - t0)
                print(f"epoch {epoch} it {i}/{len(self.loader)} "
                      f"loss {l_tot:.4f} ({rate:.0f} samples/s)")
        # a tail shorter than k: one step per call
        for b in pending:
            self.state, loss = self._train_step(self.state, self.art_dev, b, lr, use_edge, gen)
            totals.append(loss["total"])
        mean = _mean(totals)
        self.train_log.append(mean)
        return mean

    def fit(self) -> Dict[str, float]:
        """Epochs begin_epoch..end_epoch: train, evaluate, log, checkpoint
        and plot.  Each epoch's line in metrics.jsonl also holds its wall
        seconds: training (`train_s`) and all of it (`epoch_s`)."""
        cfg = self.cfg
        best_err = float("inf")
        result: Dict[str, float] = {}
        plateau = (ReduceLROnPlateau(cfg.TRAIN.lr) if cfg.TRAIN.scheduler == "plateau"
                   else None)
        mlog = MetricsLogger(osp.join(cfg.output_dir, "metrics.jsonl")
                             if self.primary else None)
        try:
            for epoch in range(self.begin_epoch, cfg.TRAIN.end_epoch + 1):
                t0 = time.time()
                lr_override = plateau.lr if plateau is not None else None
                mean_loss = self.train_epoch(epoch, lr_override=lr_override)
                train_s = time.time() - t0
                err = self.tester.test(epoch, art=self.art_dev,
                                       full_eval=epoch == cfg.TRAIN.end_epoch)
                if plateau is not None:
                    plateau.step(err.get("joint_err", mean_loss))
                self.test_log.append(err.get("joint_err", 0.0))
                result = err
                is_best = err.get("joint_err", np.inf) < best_err
                if is_best:
                    best_err = err["joint_err"]
                self._save(epoch, is_best, final=epoch == cfg.TRAIN.end_epoch)
                mlog.log("epoch", epoch=epoch, train_loss=mean_loss, train_s=train_s,
                         epoch_s=time.time() - t0, **err)
                if not self.primary:
                    continue
                # loss / error curves (funcs_utils.py:131-151, main/train.py:60-62)
                save_plot(self.train_log, cfg.graph_dir, title="train_loss")
                if self.test_log:
                    save_plot(self.test_log, cfg.graph_dir, title="test_joint_err",
                              ylabel="mm")
                print(f"epoch {epoch}: train loss {mean_loss:.4f}, "
                      f"test joint err {err.get('joint_err', -1):.2f} mm"
                      + (" (best)" if is_best else ""))
        finally:
            mlog.close()
        return result

    def _save(self, epoch: int, is_best: bool, final: bool) -> None:
        if self.primary:
            save_checkpoint(self.cfg.checkpoint_dir, epoch, self.model, self.optimizer,
                            step=self.state.step, train_log=self.train_log,
                            test_log={"joint": list(self.test_log)},
                            is_best=is_best, is_final=final)
        self._saved()


class Tester(_Base):
    """Pose2Mesh evaluator (lib/core/base.py:167-230).

    With cfg.TEST.deploy and no caller model it builds the deploy cascade
    (BatchNorm folded, the band convs on the group kernels) and loads
    `load_path` folded; a caller model (the training loop's in-epoch eval)
    is evaluated in its training form at train=False."""

    def __init__(self, cfg: Config, *, load_path: str = "", debug: bool = False,
                 dataset=None, mesh_model=None, model: Optional[Pose2Mesh] = None,
                 device: str | torch.device | None = "cuda", mesh=None):
        super().__init__(cfg, debug=debug, device=device, mesh=mesh)
        if mesh_model is None:
            mesh_model = _mesh_model_for(cfg.DATASET.input_joint_set, cfg.data_dir)
        self.mesh_model = mesh_model
        if dataset is None:
            built = build_datasets(cfg, "test", mesh_model, model_name="pose2mesh_net",
                                   debug=debug, device=self.device)
            dataset = built[0] if built else None
        self.dataset = dataset
        self.model = model
        self._deploy = bool(cfg.TEST.deploy) and model is None
        self._has_weights = model is not None
        self._art = None
        if dataset is None:
            return
        if self.model is None:
            self.model = self._build_cascade(dataset.joint_num, dataset.graph,
                                             mano=cfg.DATASET.input_joint_set == "mano",
                                             deploy=self._deploy)
        self.model.use_mesh(self.mesh)
        self._eval_step = make_eval_step(self.model, dataset.target_regressor(),
                                         device=self.device, mesh=self.mesh)
        self.loader = BatchLoader(dataset, cfg.TEST.batch_size, shuffle=False,
                                  drop_last=False, num_workers=cfg.DATASET.workers,
                                  device=self.device)
        if load_path:
            sd = load_checkpoint(load_path, pick_best=True,
                                 device=self.device)["model_state_dict"]
            self.model.load_state_dict(fold_bn_variables(sd) if self._deploy else sd)
            self._has_weights = True

    def test(self, epoch: int = 0, *, art=None,
             full_eval: Optional[bool] = None) -> Dict[str, float]:
        """joint_err / mesh_err (mm) over the test set; with full_eval (by
        default at epoch 0) also the dataset's evaluate() of every mesh.
        art: the graph in the compute dtype on the device (default: the
        dataset's, cast once)."""
        ds = self.dataset
        if ds is None:
            return {}
        if not self._has_weights:
            raise ValueError("no weights: pass load_path= or model=")
        if art is None:
            if self._art is None:
                self._art = self._art_on_device(ds.graph)
            art = self._art

        j_errs, v_errs = [], []
        meshes, target_meshes = [], []
        # the full evaluate() (every predicted mesh in host memory) only at
        # epoch 0 or when asked, as the reference collects meshes only at
        # epoch 0 / the end (lib/core/base.py:217-222)
        collect = full_eval if full_eval is not None else epoch == 0
        B = self.cfg.TEST.batch_size
        for inputs, targets, _meta in self.loader:
            pose2d = inputs["pose2d"]
            n = pose2d.shape[0]
            if n < B:  # pad the tail: every batch runs at one shape
                pose2d = torch.cat([pose2d, pose2d[-1:].expand(B - n, *pose2d.shape[1:])])
            mesh_mm, reg_pose, _ = self._eval_step(art, pose2d)
            mesh_mm = mesh_mm[:n].float().cpu().numpy()
            reg_pose = reg_pose[:n].float().cpu().numpy()
            gt_mesh = targets["mesh"].float().cpu().numpy() * 1000.0
            gt_reg = targets["reg_pose3d"].float().cpu().numpy()
            j, v = ds.compute_both_err(mesh_mm, gt_mesh, reg_pose, gt_reg)
            j_errs.append(j)
            v_errs.append(v)
            if collect:
                meshes.append(mesh_mm)
                target_meshes.append(gt_mesh)

        out = {"joint_err": float(np.mean(j_errs)) if j_errs else 0.0,
               "mesh_err": float(np.mean(v_errs)) if v_errs else 0.0}
        if self.primary:
            print(f"test epoch {epoch}: joint {out['joint_err']:.2f} mm, "
                  f"mesh {out['mesh_err']:.2f} mm")
        if collect and meshes:
            kwargs = {}
            if self.cfg.TEST.vis:  # .obj dumps during eval (config.py TEST.vis)
                kwargs["vis_dir"] = self.cfg.vis_dir
            # every rank holds every prediction; rank 0 evaluates
            res = ds.evaluate({
                "mesh_coord": np.concatenate(meshes),
                "mesh_coord_target": np.concatenate(target_meshes),
            }, **kwargs) if self.primary else None
            out.update(broadcast_object(res, self.mesh) if self.mesh is not None else res)
        return out


def _posenet(joint_num: int, seed: int, device: torch.device, mesh) -> PoseNet:
    """The lifter at the reference's width (4096), seeded, on `device`, on `mesh`."""
    model = PoseNet(joint_num)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.mesh = mesh
    return model.to(device)


class LiftTrainer(_Base):
    """PoseNet-only trainer (lib/core/base.py:233-276)."""

    def __init__(self, cfg: Config, *, debug: bool = False,
                 datasets: Optional[List] = None,
                 device: str | torch.device | None = "cuda"):
        super().__init__(cfg, debug=debug, device=device)
        mesh_model = _mesh_model_for(cfg.DATASET.input_joint_set, cfg.data_dir)
        self.datasets = datasets if datasets is not None else build_datasets(
            cfg, "train", mesh_model, model_name="posenet", debug=debug, device=self.device)
        self.joint_num = self.datasets[0].joint_num
        self.loader = BatchLoader(
            MultipleDatasets(self.datasets, make_same_len=True)
            if len(self.datasets) > 1 else self.datasets[0],
            cfg.TRAIN.batch_size, shuffle=True, drop_last=True,
            num_workers=cfg.DATASET.workers, device=self.device, **self._loader_rows())
        self.model = _posenet(self.joint_num, self.seed, self.device, self.mesh)
        if self.mesh is not None:
            shard_state(self.model, self.mesh)
        self.optimizer = make_preconditioner(cfg.TRAIN.optimizer, self.model.parameters())
        self.lr_at = multistep_lr(cfg.TRAIN.lr, cfg.TRAIN.lr_step, cfg.TRAIN.lr_factor)
        self._train_step, _ = make_posenet_steps(self.model, self.optimizer, self.mesh)
        self.state = TrainState(self.model, self.optimizer)
        self.train_log: List[float] = []

    def train_epoch(self, epoch: int) -> float:
        lr = self.lr_at(epoch)
        gen = _epoch_generator(self.seed, epoch, self.device, self.mesh)
        losses = []
        for joint_img, joint_cam, valid in self.loader:
            batch = {"pose2d": joint_img.reshape(len(joint_img), -1),
                     "pose3d": joint_cam, "pose3d_valid": valid}
            self.state, loss = self._train_step(self.state, batch, lr, gen)
            losses.append(loss)
        mean = _mean(losses)
        self.train_log.append(mean)
        return mean

    def save(self, epoch: int, is_best: bool = False) -> None:
        if self.primary:
            save_checkpoint(self.cfg.checkpoint_dir, epoch, self.model, self.optimizer,
                            step=self.state.step, train_log=self.train_log,
                            is_best=is_best)
        self._saved()


class LiftTester(_Base):
    """PoseNet-only evaluator (lib/core/base.py:278-332)."""

    def __init__(self, cfg: Config, *, load_path: str = "", debug: bool = False,
                 dataset=None, device: str | torch.device | None = "cuda"):
        super().__init__(cfg, debug=debug, device=device)
        mesh_model = _mesh_model_for(cfg.DATASET.input_joint_set, cfg.data_dir)
        if dataset is None:
            built = build_datasets(cfg, "test", mesh_model, model_name="posenet",
                                   debug=debug, device=self.device)
            dataset = built[0] if built else None
        self.dataset = dataset
        self.model = (_posenet(dataset.joint_num, self.seed, self.device, self.mesh)
                      if dataset is not None else None)
        if load_path and self.model is not None:
            self.model.load_state_dict(load_checkpoint(
                load_path, pick_best=True, device=self.device)["model_state_dict"])

    def test(self, epoch: int = 0, *, state: Optional[TrainState] = None
             ) -> Dict[str, float]:
        """MPJPE / PA-MPJPE of `state.model` (default: the loaded lifter)."""
        ds = self.dataset
        if ds is None:
            return {}
        state = state if state is not None else TrainState(self.model, None)
        _, eval_step = make_posenet_steps(state.model, state.optimizer, self.mesh)
        loader = BatchLoader(ds, self.cfg.TEST.batch_size, shuffle=False,
                             num_workers=self.cfg.DATASET.workers, device=self.device)
        preds = [eval_step(state, joint_img.reshape(len(joint_img), -1)).float().cpu().numpy()
                 for joint_img, _joint_cam, _valid in loader]
        return ds.evaluate_joint({"joint_coord": np.concatenate(preds)})
