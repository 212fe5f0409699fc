"""Rank-side code of the port's multi-device tests, and the tiny datasets of
the engine tests.

Imports torch and the port only: `parallel.distributed.spawn_ranks` runs
these functions in spawned processes (each joins a gloo group), which must
not pay for importing JAX.  Each returns numpy (picklable) results; the
test process holds them against the JAX package and the one-device port.
"""
import os

import numpy as np
import torch

from pose2mesh_release_tpu_torch.core.engine import _epoch_generator
from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
from pose2mesh_release_tpu_torch.graphs.artifact import LevelOperator
from pose2mesh_release_tpu_torch.models.meshnet import masked_batch_norm
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.models.posenet import PoseNet
from pose2mesh_release_tpu_torch.ops import hop as hop_ops
from pose2mesh_release_tpu_torch.parallel.audit import boundary_gathers, census
from pose2mesh_release_tpu_torch.parallel.halo import global_rows, halo_banded_hop
from pose2mesh_release_tpu_torch.parallel.mesh import make_mesh
from pose2mesh_release_tpu_torch.parallel.sharding import (
    shard_artifact, shard_batch, shard_level,
)

J = 7
TEST_BLOCKS = ((5, 8, 8), (8, 16), (16, 16), (16, 16), (16, 8, 3))


class TinyMeshModel:
    def __init__(self, faces, vertex_num):
        self.face = faces
        self.vertex_num = vertex_num


class TinyDataset:
    """Duck-typed mesh dataset (the engine's contract), numpy per sample;
    one instance per package (`graph` is that package's artifact)."""
    name = "Tiny"

    def __init__(self, n, art, faces, joint_num=J, seed=0):
        rng = np.random.default_rng(seed)
        nv = len(np.unique(faces))
        self.n, self.graph, self.joint_num = n, art, joint_num
        self.mesh_model = TinyMeshModel(faces, nv)
        self.pose2d = rng.standard_normal((n, joint_num, 2)).astype(np.float32)
        self.mesh = (rng.standard_normal((n, nv, 3)) * 0.05).astype(np.float32)
        self.pose3d = (rng.standard_normal((n, joint_num, 3)) * 50).astype(np.float32)
        reg = rng.random((joint_num, nv)).astype(np.float32) ** 4
        self.reg = reg / reg.sum(1, keepdims=True)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        inputs = {"pose2d": self.pose2d[i]}
        targets = {"mesh": self.mesh[i], "lift_pose3d": self.pose3d[i],
                   "reg_pose3d": self.pose3d[i]}
        meta = {"mesh_valid": np.ones((1, 1), np.float32),
                "lift_pose3d_valid": np.ones((self.joint_num, 1), np.float32),
                "reg_pose3d_valid": np.ones((self.joint_num, 1), np.float32)}
        return inputs, targets, meta

    def target_regressor(self):
        return self.reg

    def compute_both_err(self, pm, tm, pj, tj):
        return float(np.abs(pj - tj).mean()), float(np.abs(pm - tm).mean())

    def evaluate(self, outs):
        return {"mpvpe": float(np.abs(outs["mesh_coord"] - outs["mesh_coord_target"]).mean())}


class LiftDataset(TinyDataset):
    """The lifter's samples: (2D pose, 3D pose, validity)."""

    def __getitem__(self, i):
        return self.pose2d[i], self.pose3d[i], np.ones((self.joint_num, 1), np.float32)

    def evaluate_joint(self, outs):
        pred = np.asarray(outs["joint_coord"])
        return {"mpjpe": float(np.sqrt(((pred - self.pose3d[:len(pred)]) ** 2).sum(-1)).mean())}


def engine_cfg(make, out_dir, data_axis=1, graph_axis=1):
    """The engine tests' configuration (batch 4, float32, PoseNet 32) on a
    data_axis x graph_axis mesh, SGD, the loader unshuffled."""
    cfg = make()
    cfg.TRAIN.batch_size = 4
    cfg.TRAIN.end_epoch = 2
    cfg.TRAIN.print_freq = 100
    cfg.TRAIN.edge_loss_start = 0
    cfg.TEST.batch_size = 4
    cfg.DATASET.workers = 1
    cfg.TPU.compute_dtype = "f32"
    cfg.MODEL.posenet_hidden = 32
    cfg.output_dir = str(out_dir)
    cfg.TPU.data_axis, cfg.TPU.graph_axis = data_axis, graph_axis
    return cfg


def _numpy(sd):
    return {k: v.detach().float().cpu().numpy().copy() for k, v in sd.items()}


def _torch(sd, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in sd.items()}


def _threads():
    if not torch.cuda.is_available():
        torch.set_num_threads(1)


def halo_hops(rank, world, cases, device="cpu"):
    """Each case (band (2k+1, nt, T, T) float32, x and g (V, B, F) float32,
    dtype name) through `halo_banded_hop` on a (1, world) mesh: this rank's
    rows of the hop and of its VJP (float32), the hop kernel's launches and
    the census."""
    _threads()
    mesh = make_mesh(world)
    dev = torch.device(device)
    out = []
    for band, x, g, dt in cases:
        dtype = getattr(torch, dt)
        op = LevelOperator(kind="band", band_val=torch.from_numpy(band).to(dev, dtype),
                           num_vertices=x.shape[0], block_size=band.shape[-1],
                           band_k=band.shape[0] // 2)
        op = shard_level(op, mesh)
        rows, j = op.padded_vertices, mesh.graph_rank

        def local(a):
            a = torch.from_numpy(a).to(dev, dtype)
            a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, global_rows(op, world) - a.shape[0]))
            return a[j * rows:(j + 1) * rows].contiguous()

        xl = local(x).requires_grad_()
        before = hop_ops.launches["banded_hop"]
        with census(mesh) as c:
            y = halo_banded_hop(op, xl, mesh)
            y.backward(local(g))
            again = halo_banded_hop(op, xl.detach(), mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append({"y": y.detach().float().cpu().numpy(),
                    "dx": xl.grad.float().cpu().numpy(),
                    "equal_bits": bool(torch.equal(again, y.detach())),
                    "launches": hop_ops.launches["banded_hop"] - before,
                    "census": c.summary()})
    return out


def masked_bn(rank, world, y, real_rows, params):
    """`masked_batch_norm` in training on a (1, world) mesh over y (Vp, B, F)
    (pad rows zero): this rank's rows of the output, the running statistics."""
    _threads()
    mesh = make_mesh(world)
    bn = torch.nn.BatchNorm1d(y.shape[-1])
    bn.load_state_dict(_torch(params), strict=False)
    rows = y.shape[0] // world
    mask = (torch.arange(rows) + rank * rows < real_rows).view(rows, 1, 1)
    yl = torch.from_numpy(y[rank * rows:(rank + 1) * rows])
    out = masked_batch_norm(yl, bn, True, real_rows, mask, mesh)
    return {"out": out.detach().numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


def sharded_step(rank, world, graph_axis, art, blocks, hidden, state, batch, jreg, lr,
                 dropout=0.0):
    """One SGD train step of a cascade loaded with `state` on a
    (world / graph_axis, graph_axis) mesh over the global `batch`: the
    losses, every parameter and statistic after it, the census of the step
    and the band-sized gathers its graph-split levels allow."""
    _threads()
    mesh = make_mesh(graph_axis)
    model = Pose2Mesh(art.joint_num, art.mesh_ops[-1].num_vertices, posenet_hidden=hidden,
                      blocks=blocks, inference_fused=False, dropout=dropout, device="cpu",
                      mesh=mesh)
    model.load_state_dict(_torch(state))
    opt = make_preconditioner("sgd", model.parameters())
    step = make_train_step(model, opt, jreg, device="cpu", mesh=mesh)
    gen = _epoch_generator(0, 1, torch.device("cpu"), mesh)
    local = shard_batch(_torch(batch), mesh)
    art_s = shard_artifact(art, mesh)
    with census(mesh) as c:
        _, losses = step(TrainState(model, opt), art_s, local, lr, True, gen)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "state": _numpy(model.state_dict()), "census": c.summary(),
            "records": list(c.records), "allowed_gathers": boundary_gathers(art_s)}


def dropout_run(rank, world, x, art, blocks, state, batch, jreg):
    """On a (2, 2) mesh: a training PoseNet forward (dropout 0.5, hidden 16)
    of the same input on every rank, its noise from the engine's epoch
    generator; then `sharded_step` with dropout 0.5."""
    _threads()
    mesh = make_mesh(2)
    model = PoseNet(x.shape[1] // 2, hidden=16, dropout=0.5)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.mesh = mesh
    gen = _epoch_generator(0, 1, torch.device("cpu"), mesh)
    y = model(torch.from_numpy(x), train=True, generator=gen).detach().numpy()
    step = sharded_step(rank, world, 2, art, blocks, 32, state, batch, jreg, 1e-3,
                        dropout=0.5)
    return {"posenet": y, "state": step["state"], "losses": step["losses"]}


def trainer_fit(rank, world, graph_axis, art, faces, out_dir):
    """`Trainer.fit` (one epoch) of the engine tests' cascade on a mesh, each
    rank's output directory its own: the training log, the result, the
    state after the epoch, and the files the rank wrote."""
    _threads()
    from pose2mesh_release_tpu_torch.config import default_config
    from pose2mesh_release_tpu_torch.core.engine import Trainer

    out = os.path.join(out_dir, f"rank{rank}")
    cfg = engine_cfg(default_config, out, world // graph_axis, graph_axis)
    cfg.TRAIN.end_epoch = 1
    cfg.TRAIN.optimizer = "sgd"
    model = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=32,
                      blocks=TEST_BLOCKS, inference_fused=False, dropout=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tr = Trainer(cfg, datasets=[TinyDataset(8, art, faces)],
                 test_dataset=TinyDataset(4, art, faces, seed=1), model=model, device="cpu")
    result = tr.fit()
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    return {"train_log": list(tr.train_log), "result": result,
            "state": _numpy(tr.model.state_dict()), "files": files,
            "deploy": deploy_test(cfg, tr.model, art, faces),
            "lift": lift_fit(os.path.join(out, "lift"), world // graph_axis, graph_axis)}


def lift_fit(out, data_axis=1, graph_axis=1):
    """One epoch of `LiftTrainer` (PoseNet 4096, SGD lr 1e-2, dropout off)
    on 8 LiftDataset samples at batch 4, then `LiftTester` on 6 others: the
    epoch's loss, the MPJPE, the lifter's small tensors and a (sum, sum of
    squares) digest of each large one."""
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    from pose2mesh_release_tpu_torch.config import default_config
    from pose2mesh_release_tpu_torch.core.engine import LiftTester, LiftTrainer

    cfg = engine_cfg(default_config, out, data_axis, graph_axis)
    cfg.MODEL.name = "posenet"
    cfg.TRAIN.optimizer = "sgd"
    cfg.TRAIN.lr = 1e-2
    _, faces = uv_sphere(110)
    tr = LiftTrainer(cfg, datasets=[LiftDataset(8, None, faces)], device="cpu")
    tr.model.dropout = 0.0
    loss = tr.train_epoch(1)
    ev = LiftTester(cfg, dataset=LiftDataset(6, None, faces, seed=1),
                    device="cpu").test(1, state=tr.state)
    sd = {k: v.double() for k, v in tr.model.state_dict().items()}
    return {"loss": loss, "mpjpe": ev["mpjpe"],
            "small": {k: v.numpy() for k, v in sd.items() if v.numel() <= 1 << 16},
            "digest": {k: (float(v.sum()), float(v.square().sum())) for k, v in sd.items()}}


def deploy_test(cfg, model, art, faces):
    """The deploy `Tester` (BatchNorm folded into a copy of `model`'s
    weights) on the test TinyDataset, on cfg's mesh."""
    from pose2mesh_release_tpu_torch.core.engine import Tester
    from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables

    deploy = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=32,
                       blocks=TEST_BLOCKS, device="cpu")
    deploy.load_state_dict(fold_bn_variables(model.state_dict()))
    return Tester(cfg, dataset=TinyDataset(4, art, faces, seed=1), model=deploy,
                  device="cpu").test(0)
