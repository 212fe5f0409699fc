"""PyTorch port: the eval step captured as a CUDA graph and replayed.

CPU (tier 1): the eval step's key, its held check (a weight's address),
its eager reasons, the eval calls that leave every version as it was, a CPU
eval step's answers against `make_eval_step(graph=False)`, and `Tester`'s
padded tail on one key.

CUDA (marker `cuda`, skipped elsewhere): the graphed eval step against the
eager one (`make_eval_step(graph=False)`) at batch 64 on SMPL bf16, SMPL
float32 and MANO bf16; a replay after a weight load or an in-place update
reads the new weights; a held request's answers through the next replay; a padded `Tester`
epoch on one graph; a capture beside a producer thread.  On the card,
without the JAX-importing conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_graph.py
"""
import threading

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.core import train as tt
from pose2mesh_release_tpu_torch.core.train import (
    graph_counters, graph_key, held_tensors, make_eval_step,
)
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.utils.profiling import record_spans

J = 7
SKEL = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]
V = 770
# the joint graph, a dense level (444) and a band level (770) twice, as
# tests/test_torch_spans.py: a skip conv and a narrowing (commuted) conv
BLOCKS = ((5, 8, 8), (8, 8, 8), (8, 16, 8), (8, 4, 3))


@pytest.fixture(scope="module")
def tiny():
    _, faces = uv_sphere(V)
    pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=3)
    art = pack_pyramid(pyr, faces, dense_threshold=500, device="cpu")
    assert [op.kind for op in art.mesh_ops] == ["band", "dense"]
    rng = np.random.default_rng(0)
    jreg = rng.random((J, V)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    pose2d = torch.from_numpy(rng.standard_normal((3, 2, J, 2)).astype(np.float32))
    return art, faces, jreg, pose2d


def _model(art, seed=0, **kw):
    return Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=16, blocks=BLOCKS,
                     device="cpu", generator=torch.Generator().manual_seed(seed), **kw)


def _delta(before):
    return {k: graph_counters[k] - before[k] for k in graph_counters}


# ---- CPU: the key, the held check, the decision -------------------------------

@pytest.mark.parametrize("change,same", [
    (lambda a, x: (a, x + 1.0), True),                                # values only
    (lambda a, x: (a, x.clone()), True),                              # another tensor
    (lambda a, x: (a, torch.zeros(3, J, 2)), False),                  # batch
    (lambda a, x: (a, torch.zeros(2, J + 1, 2)), False),              # joints
    (lambda a, x: (a, x.double()), False),                            # dtype
    (lambda a, x: (object(), x), False),                              # artifact
], ids=["values", "tensor", "batch", "joints", "dtype", "artifact"])
def test_eval_graph_key(change, same):
    art, x = object(), torch.zeros(2, J, 2)
    base = graph_key(art, x)
    assert graph_key(art, x) == base
    assert (graph_key(*change(art, x)) == base) is same


def _form(model):
    return {"inference_fused": model.pose2mesh.inference_fused}


def _in_place(model, art):
    with torch.no_grad():
        next(model.parameters()).mul_(1.0)       # the same values, a new version


def _load_state_dict(model, art):
    model.load_state_dict(_model(art, seed=1, **_form(model)).state_dict())


def _replace_parameter(model, art):
    lin = model.pose2mesh.cl[0]
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())


def _replace_buffer(model, art):
    model.pose_lifter.linear_stages[0].batch_norm1.running_mean = torch.zeros(16)


CHANGES = {"in_place": _in_place, "load_state_dict": _load_state_dict,
           "parameter": _replace_parameter, "buffer": _replace_buffer}


@pytest.mark.parametrize("form", ["deploy", "training"])
@pytest.mark.parametrize("change", sorted(CHANGES))
def test_held_tensors_by_address(tiny, form, change):
    """A parameter or buffer replaced moves the held set; a weight written in
    place or loaded keeps it (a replay reads the new values)."""
    art = tiny[0]
    model = _model(art, inference_fused=form == "deploy")
    a = held_tensors(model)
    assert tt.same_held(a, held_tensors(model))
    CHANGES[change](model, art)
    assert tt.same_held(a, held_tensors(model)) is (change not in ("parameter", "buffer"))


@pytest.mark.parametrize("form", ["deploy", "training"])
def test_eval_calls_leave_the_versions(tiny, form):
    """An eval call (eager, on the CPU's plain versions) writes no parameter
    or buffer: a graph's weights hold from one call to the next."""
    art, _, jreg, pose2d = tiny
    model = _model(art, inference_fused=form == "deploy")
    step = make_eval_step(model, jreg, device="cpu")
    held = held_tensors(model)
    versions = [t._version for t in held]
    for x in pose2d:
        step(art, x)
    assert tt.same_held(held, held_tensors(model))
    assert [t._version for t in held] == versions


def _decide(model, art, x, change):
    """The bookkeeping of one eval step on a CUDA device (nothing launched):
    the first call of a key is eager, the second would capture (a stand-in
    graph is put in its place); then `change`.  Returns the next call's
    reason, the graphs dropped, the graphs left."""
    steps = tt._KeyedGraphs(None, model, torch.device("cuda"), prefix="eval.")
    assert steps.eager_reason(None, art, x) == "first"
    steps.ran_eagerly(art, x)
    assert steps.eager_reason(None, art, x) is None
    steps.graphs[steps.key] = "graph"
    assert steps.eager_reason(None, art, x + 1.0) is None      # values: the same graph
    assert steps.eager_reason(object(), art, x) == "mesh"
    assert steps.eager_reason(None, art, x[:1]) == "first"     # another key
    if callable(change):
        change(model, art)
    before = dict(graph_counters)
    if change == "spans":
        with record_spans():
            reason = steps.eager_reason(None, art, x)
    else:
        reason = steps.eager_reason(None, art, x)
    return reason, _delta(before)["eval.dropped"], len(steps.graphs)


REASON_AFTER = {"buffer": "first", "in_place": None, "load_state_dict": None, "parameter": "first"}


@pytest.mark.parametrize("form", ["deploy", "training"])
@pytest.mark.parametrize("change,want", [
    (None, None), ("spans", "spans"), *[(c, REASON_AFTER[c]) for c in sorted(CHANGES)],
], ids=["unchanged", "spans", *sorted(CHANGES)])
def test_eval_graphs_dropped_when_held_weights_change(tiny, form, change, want):
    """A parameter or buffer replaced (a new address) drops every graph and
    key: the next call runs eagerly and `eval.dropped` counts the graph.  A
    weight written in place or loaded keeps the graph, whose next replay
    reads the new weights."""
    art, _, _, pose2d = tiny
    model = _model(art, inference_fused=form == "deploy")
    reason, dropped, left = _decide(model, art, pose2d[0], CHANGES.get(change, change))
    assert reason == want
    assert (dropped, left) == ((1, 0) if want == "first" else (0, 1))


def test_eval_eager_reason_off_the_card(tiny):
    art, _, _, pose2d = tiny
    model = _model(art)
    cpu = tt._KeyedGraphs(None, model, torch.device("cpu"), prefix="eval.")
    assert cpu.eager_reason(None, art, pose2d[0]) == "cpu"
    assert cpu.eager_reason(object(), art, pose2d[0]) == "cpu"
    cuda = tt._KeyedGraphs(None, model, torch.device("cuda"), prefix="eval.")
    with record_spans():
        assert cuda.eager_reason(object(), art, pose2d[0]) == "mesh"
        assert cuda.eager_reason(None, art, pose2d[0]) == "spans"


@pytest.mark.parametrize("graph,spans", [(True, False), (False, False), (True, True)],
                         ids=["graph", "off", "spans"])
@pytest.mark.parametrize("form", ["deploy", "training"])
def test_cpu_eval_step_is_eager_with_answers_of_its_own(tiny, form, graph, spans):
    """On the CPU every eval call runs eagerly, counted under `eval.eager.cpu`
    (`eval.eager.off` when built with graph=False); its answers are the
    graph=False step's, bit for bit, each call's tensors its own."""
    art, _, jreg, pose2d = tiny
    model = _model(art, inference_fused=form == "deploy")
    step = make_eval_step(model, jreg, device="cpu", graph=graph)
    eager = make_eval_step(model, jreg, device="cpu", graph=False)
    before = dict(graph_counters)
    if spans:
        with record_spans():
            got = [step(art, x) for x in pose2d]
    else:
        got = [step(art, x) for x in pose2d]
    delta = _delta(before)
    reason = "eval.eager.cpu" if graph else "eval.eager.off"
    assert delta == {**{k: 0 for k in delta}, "eval.eager": 3, reason: 3}
    kept = [tuple(t.clone() for t in out) for out in got]
    want = [eager(art, x) for x in pose2d]
    for g, k, w in zip(got, kept, want):
        assert [t.shape for t in g] == [(2, V, 3), (2, J, 3), (2, J, 3)]
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(g, k, w))
    assert got[0][0].data_ptr() != got[1][0].data_ptr()
    assert not torch.equal(got[0][0], got[1][0])


def _tester(cfg, ds, model, device):
    from pose2mesh_release_tpu_torch.core.engine import Tester
    return Tester(cfg, dataset=ds, mesh_model=ds.mesh_model, model=model, device=device)


def _cfg(batch, dtype):
    from pose2mesh_release_tpu_torch.config import default_config
    cfg = default_config()
    cfg.TEST.batch_size = batch
    cfg.DATASET.workers = 2
    cfg.TPU.compute_dtype = dtype
    return cfg


def test_tester_pads_its_tail_to_one_key(tiny):
    """`Tester.test` pads the last batch to the batch size: every call of an
    epoch has one eval key, so a test epoch uses one graph."""
    from torch_mesh_helpers import TinyDataset
    art, faces, _, _ = tiny
    ds = TinyDataset(2 * 4 + 3, art, faces)
    tester = _tester(_cfg(4, "f32"), ds, _model(art), "cpu")
    keys, step = [], tester._eval_step

    def spy(a, x):
        keys.append(graph_key(a, x))
        return step(a, x)
    tester._eval_step = spy
    tester.test(0)
    tester.test(1)
    assert len(keys) == 6 and len(set(keys)) == 1
    assert keys[0][1] == ((4, J, 2), torch.float32)


# ---- CUDA: the graphed eval step against the eager one --------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _deploy(which: str, dtype, seed: int = 0):
    from pose2mesh_release_tpu_torch.deploy import mano_deploy_forward, smpl_deploy_forward
    make = {"mano": mano_deploy_forward, "smpl": smpl_deploy_forward}[which]
    return make(dtype=dtype, device="cuda", seed=seed)


def _requests(d, n=5, batch=64):
    g = torch.Generator().manual_seed(7)
    return [torch.randn(batch, d.model.num_joint, 2, generator=g).cuda() for _ in range(n)]


def _assert_as_eager(got, want, again, msg):
    """Bit-equal, or within the eager step's own run-to-run difference."""
    for g, w, a in zip(got, want, again):
        if not torch.equal(g, w):
            own = float((a - w).abs().max())
            diff = float((g - w).abs().max())
            assert diff <= own, f"{msg}: graphed vs eager {diff}, eager vs eager {own}"


CASES = [("smpl", torch.bfloat16), ("smpl", torch.float32), ("mano", torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("which,dtype", CASES, ids=["smpl_bf16", "smpl_f32", "mano_bf16"])
def test_graphed_eval_matches_eager(which, dtype):
    """5 requests on one key: 1 eager, 1 capture, 4 replays; each answer
    the eager step's on the same weights and request."""
    _cuda()
    d = _deploy(which, dtype)
    eager = make_eval_step(d.model, d.j_regressor, device="cuda", graph=False)
    reqs = _requests(d)
    before = dict(graph_counters)
    got = [d.eval_step(d.art_compute, x) for x in reqs]
    delta = _delta(before)
    assert delta == {**{k: 0 for k in delta}, "eval.eager": 1, "eval.eager.first": 1,
                     "eval.captures": 1, "eval.replays": len(reqs) - 1}
    for i, x in enumerate(reqs):
        want = eager(d.art_compute, x)
        again = eager(d.art_compute, x)
        _assert_as_eager(got[i], want, again, f"{which} {dtype} request {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["load_state_dict", "in_place"])
def test_no_stale_replay_after_a_weight_change(change):
    """After a weight load (another seed's weights) or an in-place update the
    graph stays and its replays read the new weights (the band convs derive
    their kernels' weights inside it): every answer is the new weights'."""
    _cuda()
    d = _deploy("mano", torch.bfloat16)
    eager = make_eval_step(d.model, d.j_regressor, device="cuda", graph=False)
    reqs = _requests(d, n=3)
    old = [d.eval_step(d.art_compute, x) for x in reqs]
    if change == "load_state_dict":
        d.model.load_state_dict(_deploy("mano", torch.bfloat16, seed=1).model.state_dict())
    else:
        with torch.no_grad():
            for p in d.model.pose2mesh.cl.parameters():
                p.mul_(1.5)
    before = dict(graph_counters)
    got = [d.eval_step(d.art_compute, x) for x in reqs]
    delta = _delta(before)
    assert delta == {**{k: 0 for k in delta}, "eval.replays": 3}
    for i, x in enumerate(reqs):
        want = eager(d.art_compute, x)
        assert not torch.equal(got[i][0], old[i][0]), "the old weights' answer"
        _assert_as_eager(got[i], want, eager(d.art_compute, x), f"{change} request {i}")


@pytest.mark.cuda
def test_held_answers_survive_the_next_replay():
    """A request's answers are tensors of its own: the next replay leaves
    them as they were."""
    _cuda()
    d = _deploy("mano", torch.bfloat16)
    reqs = _requests(d, n=4)
    d.eval_step(d.art_compute, reqs[0])
    first = d.eval_step(d.art_compute, reqs[1])        # the capture's answers
    kept = tuple(t.clone() for t in first)
    second = d.eval_step(d.art_compute, reqs[2])
    third = d.eval_step(d.art_compute, reqs[3])
    torch.cuda.synchronize()
    for a, b, c, e in zip(first, kept, second, third):
        assert torch.equal(a, b)
        assert a.data_ptr() != c.data_ptr() and c.data_ptr() != e.data_ptr()
    assert not torch.equal(first[0], second[0])


@pytest.mark.cuda
def test_tester_epoch_runs_on_one_graph():
    """`Tester` over 3 full batches of 64 and a tail of 5, padded: the first
    epoch runs 1 eager call, 1 capture and 3 replays, the second 4
    replays; its errors are those of the eager step."""
    from torch_mesh_helpers import TinyDataset

    from pose2mesh_release_tpu_torch.body.mano import MANO
    _cuda()
    d = _deploy("mano", torch.bfloat16)
    ds = TinyDataset(3 * 64 + 5, d.art, MANO().face, joint_num=21)
    tester = _tester(_cfg(64, "bf16"), ds, d.model, "cuda")
    before = dict(graph_counters)
    first = tester.test(0)
    delta = _delta(before)
    assert delta == {**{k: 0 for k in delta}, "eval.eager": 1, "eval.eager.first": 1,
                     "eval.captures": 1, "eval.replays": 3}
    before = dict(graph_counters)
    second = tester.test(1)
    delta = _delta(before)
    assert delta == {**{k: 0 for k in delta}, "eval.replays": 4}
    tester._eval_step = make_eval_step(d.model, ds.target_regressor(), device="cuda",
                                       graph=False)
    want = tester.test(0)
    assert first.keys() == want.keys() and set(second) == {"joint_err", "mesh_err"}
    for got in (first, second):
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-6), k


@pytest.mark.cuda
def test_eval_capture_beside_a_producer_thread():
    """A thread pinning host batches, copying them to the card on a stream of
    its own and synchronizing it, as `data.loader.BatchLoader`'s producer
    does, while the eval step captures: the capture holds and the replays
    give the eager answers."""
    dev = _cuda()
    d = _deploy("mano", torch.bfloat16)
    eager = make_eval_step(d.model, d.j_regressor, device="cuda", graph=False)
    reqs = _requests(d, n=4)
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
        got = [d.eval_step(d.art_compute, x) for x in reqs]
    finally:
        stop.set()
        t.join()
    delta = _delta(before)
    assert delta == {**{k: 0 for k in delta}, "eval.eager": 1, "eval.eager.first": 1,
                     "eval.captures": 1, "eval.replays": 3}
    assert copied
    for i, x in enumerate(reqs):
        _assert_as_eager(got[i], eager(d.art_compute, x), eager(d.art_compute, x),
                         f"request {i}")
