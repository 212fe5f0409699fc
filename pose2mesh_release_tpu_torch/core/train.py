"""Training and evaluation steps of the cascade (`Trainer`'s and `Tester`'s
per-batch compute).

The train step is one forward in training mode, the joint regressor, the
five losses, one backward and one optimizer step.  As in the JAX package the
learning rate and the edge-loss gate are arguments of every step, and the
dropout noise comes from the generator the caller passes.  BatchNorm
running statistics move inside the forward (momentum 0.1, biased batch
variance, as flax stores them).

On a mesh (`mesh=`, the model's): a train step takes this data rank's rows
of the global batch (`parallel.sharding.shard_batch`), the mean of each loss
over them, and before the optimizer step averages the gradients over the
data ranks (`parallel.sharding.sync_grads`; the graph-split convs' also
summed over the graph ranks), so every rank takes the single-device step of
the global batch; the losses it returns are the global means.  An eval step
takes the global batch, evaluates this data rank's rows and gathers the
predictions of every data rank.

On one CUDA device the train step and the eval step are each captured once
as a CUDA graph and replayed (`_KeyedGraphs`): the first call with a new key
(`graph_key`) runs eagerly, the second captures and replays, later ones
copy the batch into the graph's inputs and replay.  A graph reads the
model's tensors (and the optimizer's state) where they are, so a weight
load or an in-place write is read by the next replay; the graphs are
dropped only when one of `held_tensors` is replaced (a new address).  On
the CPU, on a mesh (its collectives are gloo's) and with the spans on
(their breakdown needs the launches) every step runs eagerly
(`eager_reason`).  `graph_counters` counts both.
"""
from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.artifact import PyramidArtifact
from ..models.meshnet import extract_mesh
from ..parallel.collectives import all_reduce_sum, gather_rows
from ..parallel.sharding import sync_grads
from ..utils.profiling import span, spans_enabled
from .losses import coord_l1, pose2mesh_loss
from .optim import set_lr

__all__ = ["TrainState", "make_train_step", "make_multi_train_step",
           "make_eval_step", "make_posenet_steps", "graph_counters", "graph_key",
           "eager_reason", "held_tensors", "same_held"]

Batch = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class TrainState:
    """The model (parameters and BatchNorm statistics, updated in place), its
    optimizer (and the optimizer's state) and the number of steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _model_device(model: torch.nn.Module, device) -> torch.device:
    dev = resolve_device(device)
    p = next(model.parameters())
    if p.device.type != dev.type:
        raise ValueError(f"model is on {p.device}, step on {dev}")
    return p.device


def _check_state(state: TrainState, model, optimizer):
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the state holds another model or optimizer than the "
                         "step was built for")


def _global_means(losses: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The per-rank means of equal shards -> the means over the global batch."""
    if mesh is None:
        return {k: v.detach() for k, v in losses.items()}
    vals = all_reduce_sum(torch.stack([v.detach() for v in losses.values()]), mesh,
                          "data", site="losses") / mesh.data
    return dict(zip(losses, vals.unbind(0)))


def _data_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of the global batch x, padded with its last row
    to a multiple of the data ranks (the gathered tail is cut again)."""
    per = -(-x.shape[0] // mesh.data)
    pad = per * mesh.data - x.shape[0]
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def _gather_data(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    return gather_rows(t.contiguous(), mesh, "data", site="predictions")[:n]


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    j_regressor: np.ndarray | torch.Tensor, *,
                    normal_weight: float = 0.1, edge_weight: float = 20.0,
                    joint_weight: float = 1e-3,
                    device: str | torch.device | None = "cuda", mesh=None,
                    graph: bool = True) -> Callable:
    """The cascade's train step: `step(state, art, batch, lr, use_edge_loss,
    generator) -> (state, losses)`.  `model` (a `Pose2Mesh` with
    inference_fused=False) must already live on `device`; j_regressor is the
    (J_target, V) dense regressor of the mesh-to-joint loss.  On `mesh`
    (the model's) art is `shard_artifact`'s and batch this data rank's rows.
    graph=False: every step eager, also on one CUDA device."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    def run(art: PyramidArtifact, batch: Batch, lr: float,
            use_edge_loss: bool | torch.Tensor, generator: Optional[torch.Generator],
            mode: str) -> Dict[str, torch.Tensor]:
        """One step's work; its losses (with their graph)."""
        with span("p2m.step", kind="train", graph=mode):
            if batch["mesh"].dtype != torch.float32:
                # half-precision targets: upcast once so the face losses run in f32
                batch = dict(batch, mesh=batch["mesh"].float())
            optimizer.zero_grad(set_to_none=True)
            mesh_dev, pose3d = model(art, batch["pose2d"], train=True, generator=generator)
            with span("p2m.extract_mesh"):
                verts = extract_mesh(art, mesh_dev)  # (B, V, 3), meters
            with span("p2m.regressor"):
                reg_pose = torch.einsum("jv,bvc->bjc", jreg, verts * 1000.0)
            # the face corners' backward: the banded selector product over the
            # artifact's tables, as the JAX step's
            with span("p2m.losses"):
                losses = pose2mesh_loss(
                    verts, pose3d, reg_pose, batch, art.faces, normal_weight=normal_weight,
                    edge_weight=edge_weight, joint_weight=joint_weight,
                    use_edge_loss=use_edge_loss,
                    face_band=(art.face_perm, art.face_sel, art.vertex_gather))
            with span("p2m.backward"):
                losses["total"].backward()
            if mesh is not None:
                with span("p2m.grad_sync"):
                    sync_grads(model.parameters(), mesh,
                               model.pose2mesh.graph_split_parameters(art))
            with span("p2m.optimizer"):
                set_lr(optimizer, lr)
                optimizer.step()
            return losses

    def step_losses(mode: str) -> Callable:
        """The step as its losses, detached (on a mesh their global means);
        `mode` marks its span."""
        return lambda *args: _global_means(run(*args, mode), mesh)

    graphs = _KeyedGraphs(step_losses("capture"), model, dev, optimizer)
    eager = step_losses("eager")

    def train_step(state: TrainState, art: PyramidArtifact, batch: Batch, lr: float,
                   use_edge_loss: bool | torch.Tensor,
                   generator: Optional[torch.Generator]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        _check_state(state, model, optimizer)
        losses = graphs(graph, mesh, eager, art, batch, lr, use_edge_loss, generator)
        return dataclasses.replace(state, step=state.step + 1), losses

    return train_step


# ---- the steps as CUDA graphs -----------------------------------------------

MAX_GRAPHS = 3   # live graphs a step keeps: each one's pool holds a step's activations
_MAX_SEEN = 16   # keys remembered as run eagerly

# steps by path: captured (each replayed at once), replayed (the captures'
# included), eager, eager by reason ("off": built with graph=False), and the
# graphs dropped because what they hold changed; the train step's unprefixed,
# the eval step's under "eval."
_COUNTS = ("captures", "replays", "eager", "eager.cpu", "eager.mesh", "eager.spans",
           "eager.first", "eager.off", "dropped")
graph_counters: Dict[str, int] = {p + k: 0 for p in ("", "eval.") for k in _COUNTS}


def _named(a) -> bool:
    """Whether a key names argument `a` by its identity: not a tensor, a dict
    of tensors or a scalar."""
    return not (torch.is_tensor(a) or isinstance(a, (dict, bool, int, float)))


def graph_key(*args) -> tuple:
    """What a captured step bakes in, read from the step's arguments: a
    tensor (and each tensor of a dict) by shape and dtype, its values copied
    in before each replay; a scalar by value (lr: the captured optimizer
    kernels take it as a constant; the edge gate); anything else (the
    artifact, the generator) by identity."""
    def key(a):
        if torch.is_tensor(a):
            return tuple(a.shape), a.dtype
        if isinstance(a, dict):
            return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(a.items()))
        return id(a) if _named(a) else a
    return tuple(key(a) for a in args)


def eager_reason(*, cuda: bool, mesh, spans: bool, seen: bool) -> Optional[str]:
    """Why a step runs eagerly ("cpu", "mesh", "spans", "first"), or None:
    it captures or replays.  A graph holds no collective; the spans'
    breakdown needs every launch; the first step of a key makes what
    capture cannot (the optimizer's state, the libraries' plans, the
    kernels' one-time tables)."""
    if not cuda:
        return "cpu"
    if mesh is not None:
        return "mesh"
    if spans:
        return "spans"
    return None if seen else "first"


def held_tensors(model: torch.nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None) -> List:
    """What a captured step holds by address: the parameters, the buffers
    and, with an optimizer, every tensor of its state and each param
    group's `capturable`."""
    out: List = list(model.parameters()) + list(model.buffers())
    for group in optimizer.param_groups if optimizer is not None else ():
        out.append(group.get("capturable"))
        for p in group["params"]:
            out.extend(v for v in optimizer.state.get(p, {}).values() if torch.is_tensor(v))
    return out


def same_held(a: List, b: List) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Param groups that take `capturable` set to it, their step counts on
    their parameters' device (a checkpoint written before the step was
    captured loads them non-capturable, its step counts on the CPU)."""
    for group in optimizer.param_groups:
        if "capturable" not in group:
            continue
        group["capturable"] = True
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get("step")) and st["step"].device != p.device:
                st["step"] = st["step"].to(p.device)


def _static(a, dev: torch.device):
    """A graph's own copy of a tensor argument (of each tensor of a dict)."""
    if torch.is_tensor(a):
        return a.detach().to(dev, copy=True)
    if isinstance(a, dict):
        return {k: v.detach().to(dev, copy=True) for k, v in a.items()}
    return a


@dataclass
class _StepGraph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple     # the call's arguments, tensors as the copies the graph reads
    outs: object      # the step's outputs (a dict or a tuple), written by each replay
    keep: tuple       # the objects the key names: their ids stay theirs


class _KeyedGraphs:
    """A step's graphs by `graph_key`, at most MAX_GRAPHS (the least
    recently replayed goes), and the keys run eagerly (at most _MAX_SEEN): a
    key's first call runs eagerly, its second captures `run` and replays,
    later ones replay.  Each graph and seen key keeps the objects its key
    names by identity, so their ids are not reused while it lives.  When one
    of `held_tensors(model, optimizer)` is replaced, every graph and key is
    dropped.  `prefix` names the step's `graph_counters`."""

    def __init__(self, run: Callable, model: torch.nn.Module, dev: torch.device,
                 optimizer: Optional[torch.optim.Optimizer] = None, prefix: str = ""):
        self.run, self.model, self.dev = run, model, dev
        self.optimizer, self.prefix = optimizer, prefix
        self.graphs: "collections.OrderedDict[tuple, _StepGraph]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        self.held: Optional[List] = None
        self.key: Optional[tuple] = None

    def __call__(self, graph: bool, mesh, eager: Callable, *args):
        """One call of the step: eager(*args), or the graph of args' key
        (graph=False: always eager)."""
        reason = "off" if not graph else self.eager_reason(mesh, *args)
        if reason is None:
            return self.replay(*args)
        graph_counters[self.prefix + "eager"] += 1
        graph_counters[self.prefix + "eager." + reason] += 1
        out = eager(*args)
        self.ran_eagerly(*args)
        return out

    def held_now(self) -> List:
        return held_tensors(self.model, self.optimizer)

    def eager_reason(self, mesh, *args) -> Optional[str]:
        cuda = self.dev.type == "cuda"
        self.key = None
        if cuda and mesh is None:
            if self.held is None or not same_held(self.held_now(), self.held):
                graph_counters[self.prefix + "dropped"] += len(self.graphs)
                self.graphs.clear()
                self.seen.clear()
            self.key = graph_key(*args)
        return eager_reason(cuda=cuda, mesh=mesh, spans=spans_enabled(),
                            seen=self.key in self.seen)

    def ran_eagerly(self, *args) -> None:
        if self.key is None:
            return
        self.seen[self.key] = tuple(a for a in args if _named(a))
        self.seen.move_to_end(self.key)
        while len(self.seen) > _MAX_SEEN:
            self.seen.popitem(last=False)
        self.held = self.held_now()

    def replay(self, *args):
        g = self.graphs.get(self.key)
        if g is None:
            g = self.graphs[self.key] = self.capture(*args)
            graph_counters[self.prefix + "captures"] += 1
            self.held = self.held_now()
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
        self.graphs.move_to_end(self.key)
        for mine, a in zip(g.inputs, args):
            if torch.is_tensor(mine):
                mine.copy_(a)
            elif isinstance(mine, dict):
                for k, v in a.items():
                    mine[k].copy_(v)
        g.graph.replay()
        graph_counters[self.prefix + "replays"] += 1
        # the caller may hold these while the next call replays
        if isinstance(g.outs, dict):
            return {k: v.clone() for k, v in g.outs.items()}
        return tuple(t.clone() for t in g.outs)

    def capture(self, *args) -> _StepGraph:
        """Capture `run` on static copies of the call's tensors; the work
        runs at the first replay.  The graph reads the parameters, the
        buffers and the optimizer's state where they are (the band convs
        derive their kernels' weights inside it).  Inside the step nothing
        reads the device from the host, synchronizes or copies from the host
        once its first, eager call has made the optimizer's state,
        `MeshNet._skip_w`'s matrices, the losses' gate and the kernels'
        one-time tables."""
        if self.optimizer is not None:
            make_capturable(self.optimizer)
        inputs = tuple(_static(a, self.dev) for a in args)
        graph = torch.cuda.CUDAGraph()
        for a in args:
            if isinstance(a, torch.Generator):
                # replays draw the dropout from the offsets an eager step would
                graph.register_generator_state(a)
        # thread_local: a loader's threads go on copying and pinning batches
        # while this thread captures (unsafe calls stay refused on this one)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = self.run(*inputs)
        return _StepGraph(graph, inputs, outs, tuple(a for a in args if _named(a)))


def make_multi_train_step(train_step: Callable) -> Callable:
    """k train steps over a stacked batch (leaves (k, B, ...)), one after the
    other; returns the state and the losses stacked (k,) per key."""

    def multi_step(state, art, batches: Batch, lr, use_edge_loss, generator):
        k = next(iter(batches.values())).shape[0]
        history = []
        for i in range(k):
            state, losses = train_step(state, art, {n: v[i] for n, v in batches.items()},
                                       lr, use_edge_loss, generator)
            history.append(losses)
        return state, {n: torch.stack([h[n] for h in history]) for n in history[0]}

    return multi_step


def make_eval_step(model: torch.nn.Module, j_regressor: np.ndarray | torch.Tensor,
                   *, device: str | torch.device | None = "cuda", mesh=None,
                   graph: bool = True) -> Callable:
    """Eval forward returning (pred_mesh mm (B, V, 3), pred_reg_pose mm
    (B, J, 3), lifted pose mm (B, J, 3)), for the deploy form or the
    training form at eval.  `model` must already live on `device`;
    j_regressor is the (J_target, V) dense regressor.  On `mesh` (the
    model's) pose2d is the global batch and so are the predictions.  On one
    CUDA device the forward replays a CUDA graph (see the module note); each
    call returns tensors of its own.  graph=False: every call eager."""
    dev = _model_device(model, device)
    jreg = torch.as_tensor(j_regressor, dtype=torch.float32).to(dev)

    def run(art: PyramidArtifact, pose2d: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        n = pose2d.shape[0]
        with span("p2m.step", kind="eval"):
            if mesh is not None:
                pose2d = _data_rows(pose2d, mesh)
            mesh_dev, pose3d = model(art, pose2d)
            with span("p2m.extract_mesh"):
                mesh_mm = extract_mesh(art, mesh_dev) * 1000.0
            with span("p2m.regressor"):
                reg_pose = torch.einsum("jv,bvc->bjc", jreg, mesh_mm)
            if mesh is None:
                return mesh_mm, reg_pose, pose3d
            return tuple(_gather_data(t, mesh, n) for t in (mesh_mm, reg_pose, pose3d))

    graphs = _KeyedGraphs(run, model, dev, prefix="eval.")

    @torch.inference_mode()
    def eval_step(art: PyramidArtifact, pose2d: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return graphs(graph, mesh, run, art, pose2d)

    return eval_step


def make_posenet_steps(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       mesh=None):
    """Train and eval steps of the standalone PoseNet lifter: masked L1 on the
    3D joints.  `train_step(state, batch, lr, generator) -> (state, loss)`,
    `eval_step(state, pose2d) -> (B, J, 3)`.  On `mesh` (the model's) as
    `make_train_step` and `make_eval_step` are."""

    def train_step(state: TrainState, batch: Batch, lr: float,
                   generator: Optional[torch.Generator]):
        _check_state(state, model, optimizer)
        with span("p2m.step", kind="train"):
            optimizer.zero_grad(set_to_none=True)
            with span("p2m.posenet"):
                pred = model(batch["pose2d"], train=True, generator=generator)
            pred = pred.reshape(pred.shape[0], -1, 3)
            with span("p2m.losses"):
                loss = coord_l1(pred, batch["pose3d"], batch["pose3d_valid"])
            with span("p2m.backward"):
                loss.backward()
            if mesh is not None:
                with span("p2m.grad_sync"):
                    sync_grads(model.parameters(), mesh)
            with span("p2m.optimizer"):
                set_lr(optimizer, lr)
                optimizer.step()
            return (dataclasses.replace(state, step=state.step + 1),
                    _global_means({"loss": loss}, mesh)["loss"])

    @torch.inference_mode()
    def eval_step(state: TrainState, pose2d: torch.Tensor) -> torch.Tensor:
        n = pose2d.shape[0]
        with span("p2m.step", kind="eval"):
            with span("p2m.posenet"):
                pred = state.model(pose2d if mesh is None else _data_rows(pose2d, mesh))
            pred = pred.reshape(pred.shape[0], -1, 3)
            return pred if mesh is None else _gather_data(pred, mesh, n)

    return train_step, eval_step
