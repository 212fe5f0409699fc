"""PyTorch port: the train step captured as a CUDA graph and replayed.

CPU (tier 1): the capture decision and its key as pure functions, the
bookkeeping that drops a graph when what it holds by address changes, the
eager step's losses, the optimizers' `capturable`, and the tables the losses
copy to a device once.

CUDA (marker `cuda`, skipped elsewhere): the graphed step against the eager
step (`make_train_step(graph=False)`) on MANO and at SMPL width, batch 64,
bf16, from the same weights, batches and dropout seed; re-captures on a
change of lr and of the edge gate; no stale replay after
`optimizer.load_state_dict`.  On the card, without the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph.py
"""
import copy
import threading

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu_torch.core import losses as tl
from pose2mesh_release_tpu_torch.core import train as tt
from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
from pose2mesh_release_tpu_torch.core.train import (
    TrainState, eager_reason, graph_counters, graph_key, held_tensors, make_train_step,
    same_held,
)
from pose2mesh_release_tpu_torch.utils.profiling import record_spans


# ---- CPU: the decision and its bookkeeping ------------------------------------

@pytest.mark.parametrize("cuda,mesh,spans,seen,want", [
    (False, None, False, True, "cpu"),
    (True, object(), False, True, "mesh"),
    (True, None, True, True, "spans"),
    (True, None, False, False, "first"),
    (True, None, False, True, None),
    (False, object(), True, False, "cpu"),
    (True, object(), True, False, "mesh"),
])
def test_eager_reason(cuda, mesh, spans, seen, want):
    assert eager_reason(cuda=cuda, mesh=mesh, spans=spans, seen=seen) == want


def _key_args():
    g = torch.Generator()
    batch = {"pose2d": torch.zeros(4, 7, 2), "mesh": torch.zeros(4, 9, 3)}
    return [object(), batch, 1e-3, True, g]


def _changed(i, value):
    def change(args):
        args[i] = value(args[i])
        return args
    return change


@pytest.mark.parametrize("change,same", [
    (_changed(1, lambda b: {k: v + 1.0 for k, v in b.items()}), True),   # values only
    (_changed(1, lambda b: dict(b, pose2d=torch.zeros(8, 7, 2))), False),
    (_changed(1, lambda b: dict(b, mesh=b["mesh"].half())), False),
    (_changed(1, lambda b: dict(b, extra=torch.zeros(1))), False),
    (_changed(0, lambda a: object()), False),
    (_changed(2, lambda lr: 2e-3), False),
    (_changed(3, lambda e: False), False),
    (_changed(3, lambda e: torch.tensor(True)), False),
    (_changed(4, lambda g: torch.Generator()), False),
    (_changed(4, lambda g: None), False),
], ids=["values", "shape", "dtype", "keys", "artifact", "lr", "edge", "edge_tensor",
        "generator", "no_generator"])
def test_graph_key(change, same):
    args = _key_args()
    base = graph_key(*args)
    assert graph_key(*args) == base
    assert (graph_key(*change(list(args))) == base) is same
    # a tensor gate is keyed by shape and dtype: its value is copied in
    gate = [*args[:3], torch.tensor(True), args[4]]
    assert graph_key(*gate) == graph_key(*gate[:3], torch.tensor(False), gate[4])


def _tiny_model_and_optimizer():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    opt = make_preconditioner("rmsprop", model.parameters())
    model(torch.randn(5, 4)).sum().backward()
    opt.step()
    return model, opt


def _replace_weight(model, opt):
    model[0].weight = torch.nn.Parameter(model[0].weight.detach().clone())


def _replace_buffer(model, opt):
    model[1].running_mean = torch.zeros(3)


def _reload_optimizer(model, opt):
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))   # as from a checkpoint


def _flip_capturable(model, opt):
    opt.param_groups[0]["capturable"] = True


def _spans(model, opt):
    pass


@pytest.mark.parametrize("change,want", [
    (None, None), (_replace_weight, "first"), (_replace_buffer, "first"),
    (_reload_optimizer, "first"), (_flip_capturable, "first"), (_spans, "spans"),
], ids=["unchanged", "parameter", "buffer", "optimizer_state", "capturable", "spans"])
def test_capture_decision_after_a_seen_key(change, want):
    """The bookkeeping of one step on a CUDA device (nothing launched): the
    first call of a key is eager, the second would capture; a change of what
    a graph holds by address forgets every key, so the next call is eager."""
    model, opt = _tiny_model_and_optimizer()
    steps = tt._KeyedGraphs(None, model, torch.device("cuda"), opt)
    args = _key_args()
    assert steps.eager_reason(None, *args) == "first"
    steps.ran_eagerly(*args)
    assert steps.eager_reason(None, *args) is None
    assert steps.eager_reason(object(), *args) == "mesh"
    if change is not None:
        change(model, opt)
    if change is _spans:
        with record_spans():
            assert steps.eager_reason(None, *args) == want
        return
    assert steps.eager_reason(None, *args) == want
    cpu = tt._KeyedGraphs(None, model, torch.device("cpu"), opt)
    assert cpu.eager_reason(None, *args) == "cpu"


def test_held_tensors_by_identity():
    model, opt = _tiny_model_and_optimizer()
    a = held_tensors(model, opt)
    assert same_held(a, held_tensors(model, opt))
    # 4 parameters, 3 buffers, square_avg and step a parameter, capturable
    assert len(a) == 4 + 3 + 4 * 2 + 1
    with torch.no_grad():
        model[0].weight.add_(1.0)          # in place: the same tensors
    assert same_held(a, held_tensors(model, opt))
    assert not same_held(a, a[:-1])


def _tiny_cascade():
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    from pose2mesh_release_tpu_torch.train_setup import synthetic_batch
    J, V = 7, 110
    verts, faces = uv_sphere(V)
    pyr = build_pyramid(faces, joint_num=J,
                        skeleton=[(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)], levels=2)
    art = pack_pyramid(pyr, faces, device="cpu")
    rng = np.random.default_rng(3)
    jreg = rng.random((J, V)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(verts.astype(np.float32), 2, jreg, rng).items()}
    model = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=16,
                      blocks=((5, 8), (8, 8), (8, 3)), inference_fused=False, device="cpu")
    return model, art, jreg, batch


@pytest.mark.parametrize("graph", [True, False])
def test_cpu_steps_are_eager_with_losses_of_their_own(graph):
    """On the CPU every step runs eagerly, counted by reason; each step's
    losses are tensors of its own that later steps leave as they were."""
    model, art, jreg, batch = _tiny_cascade()
    opt = make_preconditioner("rmsprop", model.parameters())
    step = make_train_step(model, opt, jreg, device="cpu", graph=graph)
    state, gen = TrainState(model, opt), torch.Generator().manual_seed(0)
    before = dict(graph_counters)
    out, kept = [], []
    for _ in range(3):
        state, losses = step(state, art, batch, 1e-3, True, gen)
        out.append(losses)
        kept.append({k: v.clone() for k, v in losses.items()})
    delta = {k: graph_counters[k] - before[k] for k in graph_counters}
    reason = "eager.cpu" if graph else "eager.off"
    assert delta == {**{k: 0 for k in delta}, "eager": 3, reason: 3}
    assert state.step == 3
    assert out[0]["total"] is not out[1]["total"]
    assert out[0]["total"].data_ptr() != out[1]["total"].data_ptr()
    assert not torch.equal(out[0]["total"], out[2]["total"])
    for got, want in zip(out, kept):
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


@pytest.mark.parametrize("name", ["rmsprop", "adam", "sgd"])
def test_preconditioner_not_capturable_on_the_cpu(name):
    opt = make_preconditioner(name, torch.nn.Linear(3, 2).parameters())
    assert all(not g.get("capturable", False) for g in opt.param_groups)


def test_loss_tables_made_once_a_device():
    """The Laplacian loss's edge list and degrees, and the edge term's gate,
    are made on a device once and reused."""
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    _, faces = uv_sphere(110)
    loss = tl.make_laplacian_loss(faces)
    x = torch.randn(2, 110, 3)
    first = loss(x)
    tables = dict(loss.tables)
    assert list(tables) == [x.device]
    assert torch.equal(loss(x, average=False), first)
    assert len(loss.tables) == 1 and all(a is b for a, b in
                                         zip(loss.tables[x.device], tables[x.device]))
    cpu = torch.device("cpu")
    assert tl._edge_gate(True, cpu) is tl._edge_gate(True, cpu)
    assert bool(tl._edge_gate(True, cpu)) and not bool(tl._edge_gate(False, cpu))
    gate = torch.tensor(1, dtype=torch.int32)
    assert tl._edge_gate(gate, cpu).dtype == torch.bool


# ---- CUDA: the graphed step against the eager step ----------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(which: str, graph: bool):
    """A bf16 batch-64 train setup (seed 0 weights) and its step, graphed or
    eager; the dropout generator seeded alike on both."""
    from pose2mesh_release_tpu_torch.train_setup import mano_train_setup, smpl_train_setup
    make = {"mano": mano_train_setup, "smpl": smpl_train_setup}[which]
    s = make(dtype=torch.bfloat16, device="cuda", seed=0, batch=64)
    step = make_train_step(s.state.model, s.state.optimizer, s.j_regressor, device="cuda",
                           graph=graph)
    return s, step


def _batches(batch, n=3):
    """n batches of the setup's shapes and different values."""
    g = torch.Generator(device=batch["pose2d"].device).manual_seed(5)
    out = []
    for i in range(n):
        b = dict(batch)
        b["pose2d"] = batch["pose2d"] + 0.01 * i * torch.randn(
            batch["pose2d"].shape, generator=g, device=g.device)
        b["mesh"] = batch["mesh"] + 0.002 * i * torch.randn(
            batch["mesh"].shape, generator=g, device=g.device)
        out.append(b)
    return out


def _state(s):
    model, opt = s.state.model, s.state.optimizer
    out = {f"param {n}": p.detach() for n, p in model.named_parameters()}
    out.update({f"buffer {n}": b for n, b in model.named_buffers()})
    for n, p in model.named_parameters():
        out[f"square_avg {n}"] = opt.state[p]["square_avg"]
    return out


def _run(s, step, batches, n, lr=1e-3, edge=True):
    state, losses = s.state, []
    for i in range(n):
        state, l_ = step(state, s.art_compute, batches[i % len(batches)], lr, edge,
                         s.generator)
        losses.append(l_)
    s.state = state
    return losses


STEPS = 7


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mano", "smpl"])
def test_graphed_step_matches_eager(which):
    """7 calls on one key: 1 eager, 1 capture, 6 replays; each step's losses,
    then every parameter, RMSprop's square_avg, the BatchNorm statistics and
    the dropout stream equal to the eager step's."""
    _cuda()
    sg, step_g = _setup(which, True)
    se, step_e = _setup(which, False)
    batches = _batches(sg.batch)
    before = dict(graph_counters)
    lg = _run(sg, step_g, batches, STEPS)
    delta = {k: graph_counters[k] - before[k] for k in graph_counters}
    assert delta == {**{k: 0 for k in delta}, "eager": 1, "eager.first": 1, "captures": 1,
                     "replays": STEPS - 1}
    kept = [{k: v.clone() for k, v in l_.items()} for l_ in lg]
    le = _run(se, step_e, batches, STEPS)
    torch.cuda.synchronize()
    for i, (g, e) in enumerate(zip(lg, le)):
        assert g.keys() == e.keys()
        for k in e:
            torch.testing.assert_close(g[k], e[k], rtol=1e-4, atol=1e-7,
                                       msg=lambda m: f"step {i} {k}: {m}")
            assert torch.equal(g[k], kept[i][k]), "a later step overwrote the losses"
    got, want = _state(sg), _state(se)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"{k}: {m}")
    # the dropout stream: both generators at the same offset, the next draw equal
    assert torch.equal(sg.generator.get_state(), se.generator.get_state())
    draw = [torch.empty(4096, device="cuda").bernoulli_(0.5, generator=s.generator)
            for s in (sg, se)]
    assert torch.equal(*draw)


@pytest.mark.cuda
def test_lr_and_edge_gate_recapture_once():
    """A new lr, then a new edge gate: each a new key (one eager step, one
    capture); the first key's graph is replayed again without a capture."""
    _cuda()
    s, step = _setup("mano", True)
    batches = _batches(s.batch)
    _run(s, step, batches, 3)
    for kw in ({"lr": 2e-3}, {"lr": 2e-3, "edge": False}, {}):
        before = dict(graph_counters)
        _run(s, step, batches, 3, **kw)
        delta = {k: graph_counters[k] - before[k] for k in graph_counters}
        want = ({"eager": 1, "eager.first": 1, "captures": 1, "replays": 2} if kw
                else {"replays": 3})
        assert delta == {**{k: 0 for k in delta}, **want}, kw


@pytest.mark.cuda
def test_capture_beside_a_producer_thread():
    """A thread pinning host batches, copying them to the card on a stream of
    its own and synchronizing it, as `data.loader.BatchLoader`'s producer
    does, while the step captures: the capture holds, the replays match the
    eager step."""
    dev = _cuda()
    sg, step_g = _setup("mano", True)
    se, step_e = _setup("mano", False)
    batches = _batches(sg.batch)
    stop, copied = threading.Event(), []

    def produce():
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            while not stop.is_set():
                host = torch.randn(1 << 18).pin_memory()
                copied.append(float(host.to(dev, non_blocking=True).sum()))
                stream.synchronize()

    t = threading.Thread(target=produce)
    t.start()
    try:
        before = dict(graph_counters)
        lg = _run(sg, step_g, batches, 4)
    finally:
        stop.set()
        t.join()
    delta = {k: graph_counters[k] - before[k] for k in graph_counters}
    assert delta == {**{k: 0 for k in delta}, "eager": 1, "eager.first": 1, "captures": 1,
                     "replays": 3}
    assert copied
    le = _run(se, step_e, batches, 4)
    for g, e in zip(lg, le):
        torch.testing.assert_close(g["total"], e["total"], rtol=1e-4, atol=1e-7)


@pytest.mark.cuda
def test_no_stale_replay_after_load_state_dict():
    """After `optimizer.load_state_dict` the graph is dropped (`dropped`) and
    the next call runs eagerly; a state saved non-capturable with its step
    counts on the CPU (as a checkpoint of an older port loads) is made
    capturable before the next capture, and the step then matches the eager
    step from the same state."""
    _cuda()
    sg, step_g = _setup("mano", True)
    se, step_e = _setup("mano", False)
    batches = _batches(sg.batch)
    _run(sg, step_g, batches, 3)
    _run(se, step_e, batches, 3)
    for s in (sg, se):
        sd = s.state.optimizer.state_dict()
        for group in sd["param_groups"]:
            group["capturable"] = False
        for st in sd["state"].values():
            st["step"] = st["step"].cpu()
        s.state.optimizer.load_state_dict(sd)
    opt = sg.state.optimizer
    assert not opt.param_groups[0]["capturable"]
    before = dict(graph_counters)
    lg = _run(sg, step_g, batches, 3)
    delta = {k: graph_counters[k] - before[k] for k in graph_counters}
    assert delta == {**{k: 0 for k in delta}, "dropped": 1, "eager": 1, "eager.first": 1,
                     "captures": 1, "replays": 2}
    assert opt.param_groups[0]["capturable"]
    assert all(st["step"].is_cuda for st in opt.state.values())
    le = _run(se, step_e, batches, 3)
    for g, e in zip(lg, le):
        torch.testing.assert_close(g["total"], e["total"], rtol=1e-4, atol=1e-7)
    got, want = _state(sg), _state(se)
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), rtol=1e-3, atol=1e-5,
                                   msg=lambda m: f"{k}: {m}")
