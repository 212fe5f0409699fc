"""PyTorch port: the training slice against the JAX package (CPU, f32).

Losses (values and gradients, degenerate triangles included), metrics,
optimizer steps against optax, and the cascade's train step against JAX
`make_train_step(use_pallas=False)` on a small cascade and at full SMPL
width; the training MeshNet alone is in test_torch_train_meshnet.py.
Dropout cannot match across frameworks: the JAX side runs with
`flax.linen.Dropout` replaced by the identity, the port with dropout 0.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.synthetic import uv_sphere as jax_uv_sphere
from pose2mesh_release_tpu.core import losses as jl
from pose2mesh_release_tpu.core import metrics as jm
from pose2mesh_release_tpu.core.optim import make_preconditioner as jax_preconditioner
from pose2mesh_release_tpu.core.train import TrainState as JaxTrainState
from pose2mesh_release_tpu.core.train import make_eval_step as jax_make_eval_step
from pose2mesh_release_tpu.core.train import make_posenet_steps as jax_posenet_steps
from pose2mesh_release_tpu.core.train import make_train_step as jax_make_train_step
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh as JaxPose2Mesh
from pose2mesh_release_tpu.models.posenet import PoseNet as JaxPoseNet
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.core import losses as tl
from pose2mesh_release_tpu_torch.core import metrics as tm
from pose2mesh_release_tpu_torch.core.optim import make_preconditioner, set_lr
from pose2mesh_release_tpu_torch.core.train import (
    TrainState, make_eval_step, make_multi_train_step, make_posenet_steps, make_train_step,
)
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.models.posenet import PoseNet
from pose2mesh_release_tpu_torch.parity.from_jax import (
    posenet_state_dict, state_dict_from_flax,
)
from pose2mesh_release_tpu_torch.train_setup import synthetic_batch

from test_torch_artifact import seeded_eigsh  # noqa: F401
from test_torch_models import randomize_bn, to_numpy

J = 7
SKEL = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]
# 3-conv blocks so the fold chain engages (tests/test_pallas.py:549-550)
FOLD_BLOCKS = ((5, 16, 16), (16, 16, 16), (16, 16, 16), (16, 16, 16), (16, 8, 3))


class _NoDropout:
    """Stands in for flax.linen.Dropout: the identity."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, x, *args, **kwargs):
        return x


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


def _close_state(got, want):
    """Every parameter and running statistic after the steps."""
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)


# ---- losses and metrics ------------------------------------------------------

def _loss_inputs(seed=0, V=110):
    _, faces = jax_uv_sphere(V)
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((2, V, 3)).astype(np.float32)
    gt = rng.standard_normal((2, V, 3)).astype(np.float32)
    valid = (rng.random((2, V, 3)) > 0.3).astype(np.float32)
    return faces, pred, gt, valid


LOSSES = {
    "coord_l1": (lambda p, g, f, v: jl.coord_l1(p, g, v),
                 lambda p, g, f, v: tl.coord_l1(p, g, v)),
    "normal": (lambda p, g, f, v: jl.normal_vector_loss(p, g, f),
               lambda p, g, f, v: tl.normal_vector_loss(p, g, f)),
    "edge": (lambda p, g, f, v: jl.edge_length_loss(p, g, f),
             lambda p, g, f, v: tl.edge_length_loss(p, g, f)),
}


def _value_and_grad_both(jfn, tfn, pred, gt, faces, valid):
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(gt), jnp.asarray(faces),
                                                jnp.asarray(valid)))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    tv = tfn(p, torch.from_numpy(gt), torch.from_numpy(faces), torch.from_numpy(valid))
    (tg,) = torch.autograd.grad(tv, p)
    return (float(tv.detach()), tg.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    faces, pred, gt, valid = _loss_inputs()
    (tv, tg), (jv, jg) = _value_and_grad_both(*LOSSES[name], pred, gt, faces, valid)
    _close(tv, jv, rtol=1e-5)
    _close(tg, jg, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("kind", ["coincident_edge", "coincident_face", "colinear"])
def test_degenerate_triangles_match_jax(kind):
    """tests/test_train.py::test_degenerate_triangle_grads_finite: a
    bf16-quantized prediction with a zero-length edge, a collapsed triangle
    or a colinear triangle; the port's values and gradients are finite and
    equal the JAX package's, both ways round (degenerate prediction and
    degenerate ground truth)."""
    faces, pred, gt, _ = _loss_inputs(seed=1)
    v0, v1, v2 = faces[0]
    if kind == "coincident_edge":
        pred[:, v1] = pred[:, v0]
    elif kind == "coincident_face":
        pred[:, v1] = pred[:, v0]
        pred[:, v2] = pred[:, v0]
    else:
        pred[:, v2] = 2.0 * pred[:, v1] - pred[:, v0]
    pred = torch.from_numpy(pred).bfloat16().float().numpy()

    def jtotal(p, g, f, v):
        return jl.normal_vector_loss(p, g, f) + jl.edge_length_loss(p, g, f) \
            + jl.coord_l1(p, g)

    def ttotal(p, g, f, v):
        return tl.normal_vector_loss(p, g, f) + tl.edge_length_loss(p, g, f) \
            + tl.coord_l1(p, g)

    for a, b in ((pred, gt), (gt, pred)):
        (tv, tg), (jv, jg) = _value_and_grad_both(jtotal, ttotal, a, b, faces,
                                                  np.ones_like(a))
        assert np.isfinite(tv) and np.isfinite(tg).all(), kind
        _close(tv, jv, rtol=1e-5)
        _close(tg, jg, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_edge", [False, True])
def test_pose2mesh_loss_and_laplacian_match_jax(use_edge):
    faces, pred, gt, valid = _loss_inputs(seed=2)
    rng = np.random.default_rng(3)
    pose = {k: (rng.standard_normal((2, J, 3)) * 100).astype(np.float32)
            for k in ("lift", "reg", "lift_t", "reg_t")}
    targets = {"mesh": gt, "mesh_valid": valid,
               "reg_pose3d": pose["reg_t"], "reg_pose3d_valid": np.ones((2, J, 3), np.float32),
               "lift_pose3d": pose["lift_t"], "lift_pose3d_valid": np.ones((2, J, 3), np.float32)}
    want = jl.pose2mesh_loss(jnp.asarray(pred), jnp.asarray(pose["lift"]),
                             jnp.asarray(pose["reg"]),
                             {k: jnp.asarray(v) for k, v in targets.items()},
                             jnp.asarray(faces), use_edge_loss=jnp.bool_(use_edge))
    got = tl.pose2mesh_loss(torch.from_numpy(pred), torch.from_numpy(pose["lift"]),
                            torch.from_numpy(pose["reg"]),
                            {k: torch.from_numpy(v) for k, v in targets.items()},
                            torch.from_numpy(faces), use_edge_loss=use_edge)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-5, err_msg=k)
    for average in (False, True):
        _close(tl.make_laplacian_loss(faces)(torch.from_numpy(pred), average=average),
               jl.make_laplacian_loss(faces)(jnp.asarray(pred), average=average),
               rtol=1e-5)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((4, 17, 3)).astype(np.float32)
    gt = rng.standard_normal((4, 17, 3)).astype(np.float32)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    for name in ("mpjpe", "pa_mpjpe", "mpvpe", "accel_error"):
        _close(getattr(tm, name)(tp, tg), getattr(jm, name)(jp, jg), rtol=1e-4,
               err_msg=name)
    _close(tm.rigid_align(tp[0], tg[0]), jm.rigid_align(jp[0], jg[0]), rtol=1e-4,
           atol=1e-5)


@pytest.mark.parametrize("name", ["rmsprop", "adam", "sgd"])
def test_optimizer_steps_match_optax(name):
    """Two steps of the torch optimizer == the optax preconditioner followed
    by -lr * update (the JAX train step's update)."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((6, 4)).astype(np.float32)
    grads = [rng.standard_normal((6, 4)).astype(np.float32) for _ in range(2)]
    lrs = (1e-3, 3e-3)
    tx = jax_preconditioner(name)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_preconditioner(name, [param])
    for g, lr in zip(grads, lrs):
        u, st = tx.update(jnp.asarray(g), st, p)
        p = p - lr * u
        param.grad = torch.from_numpy(g)
        set_lr(opt, lr)
        opt.step()
    _close(param.detach(), p, rtol=1e-6, atol=1e-7)


def test_stand_in_template_matches_jax():
    """The port's stand-in rest mesh (the train batch's base) == the JAX
    package's synthetic body template."""
    from pose2mesh_release_tpu.body.synthetic import synthetic_body_params
    want = np.asarray(synthetic_body_params().v_template, np.float32)
    np.testing.assert_array_equal(SMPL().v_template, want)


def test_lr_schedules_match_jax():
    """multistep_lr and ReduceLROnPlateau (copies) give the JAX package's
    learning rates."""
    from pose2mesh_release_tpu.core.optim import ReduceLROnPlateau as JaxPlateau
    from pose2mesh_release_tpu.core.optim import multistep_lr as jax_multistep_lr
    from pose2mesh_release_tpu_torch.core.optim import ReduceLROnPlateau, multistep_lr
    got, want = multistep_lr(1e-3, [3, 12], 0.1), jax_multistep_lr(1e-3, [3, 12], 0.1)
    assert [got(e) for e in range(16)] == [want(e) for e in range(16)]
    metrics = [5.0, 4.0, 4.5, 4.2, 4.1, 3.0, 3.5, 3.6, 3.7, 3.8] * 3
    got, want = ReduceLROnPlateau(1e-3, patience=1), JaxPlateau(1e-3, patience=1)
    assert [got.step(m) for m in metrics] == [want.step(m) for m in metrics]


# ---- the cascade's train step ------------------------------------------------

def _jax_and_port_cascade(art_j, art_t, blocks, hidden, pose2d, seed):
    jmodel = JaxPose2Mesh(num_joint=pose2d.shape[1], posenet_hidden=hidden,
                          blocks=blocks, use_pallas=False)
    v = to_numpy(jax.jit(jmodel.init, static_argnums=3)(
        jax.random.PRNGKey(seed), art_j, jnp.asarray(pose2d), False))
    randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(seed))
    port = Pose2Mesh(pose2d.shape[1], art_t.mesh_ops[-1].num_vertices,
                     posenet_hidden=hidden, blocks=blocks, inference_fused=False,
                     dropout=0.0, device="cpu")
    port.load_state_dict(state_dict_from_flax(v))
    return jmodel, v, port


def _run_steps(monkeypatch, art_j, art_t, blocks, hidden, batch, jreg, n_steps,
               lrs=(1e-2, 2e-2), use_edge_loss=True):
    """n_steps JAX and port train steps from the same variables; returns the
    per-step losses, the final state dicts of both sides, the initial one,
    and (port model, JAX model, JAX state) after the steps.  The optimizer
    is SGD: RMSprop and Adam divide by the gradient's own scale, so where the
    exact gradient is zero (a bias feeding only a BatchNorm) they turn both
    frameworks' rounding noise into steps of the learning rate's size; their
    update rules are held against optax by test_optimizer_steps_match_optax."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jmodel, v, port = _jax_and_port_cascade(art_j, art_t, blocks, hidden,
                                            batch["pose2d"], seed=7)
    tx = jax_preconditioner("sgd")
    jstate = JaxTrainState.create({"params": v["params"],
                                   "batch_stats": v["batch_stats"]}, tx)
    jstep = jax.jit(jax_make_train_step(jmodel, tx, jnp.asarray(jreg)))
    opt = make_preconditioner("sgd", port.parameters())
    state = TrainState(port, opt)
    step = make_train_step(port, opt, jreg, device="cpu")
    jbatch = {k: jnp.asarray(b) for k, b in batch.items()}
    tbatch = {k: torch.from_numpy(b) for k, b in batch.items()}
    losses = []
    for i in range(n_steps):
        jstate, jl_ = jstep(jstate, art_j, jbatch, jnp.float32(lrs[i]),
                            jnp.bool_(use_edge_loss), jax.random.PRNGKey(0))
        state, tl_ = step(state, art_t, tbatch, lrs[i], use_edge_loss, None)
        losses.append((tl_, jl_))
    assert state.step == n_steps
    want = state_dict_from_flax(to_numpy({"params": jstate.params,
                                          "batch_stats": jstate.batch_stats}))
    return losses, port.state_dict(), want, state_dict_from_flax(v), (port, jmodel, jstate)


def test_train_steps_match_jax(seeded_eigsh, monkeypatch):  # noqa: F811
    """Two steps of the port's make_train_step on a small cascade
    (band levels with the fold chain, a dense level, edge loss on) == JAX
    make_train_step(use_pallas=False): every loss of both steps, every
    parameter and every BatchNorm running statistic after them."""
    _, faces = jax_uv_sphere(770)
    pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=4)
    art_j = jax_pack_pyramid(pyr, faces, dense_threshold=300)
    art_t = pack_pyramid(pyr, faces, dense_threshold=300, device="cpu")
    assert [op.kind for op in art_t.mesh_ops] == ["band", "band", "dense"]
    rng = np.random.default_rng(8)
    jreg = rng.random((J, 770)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    template = (jax_uv_sphere(770)[0] * np.array([0.3, 0.2, 0.9])).astype(np.float32)
    batch = synthetic_batch(template, 4, jreg, rng)
    losses, got, want, _, (port, jmodel, jstate) = _run_steps(
        monkeypatch, art_j, art_t, FOLD_BLOCKS, 32, batch, jreg, 2)
    for i, (t, j) in enumerate(losses):
        for k in j:
            _close(t[k], j[k], rtol=1e-4, atol=1e-7, err_msg=f"step {i} {k}")
    _close_state(got, want)
    # the trained (unfolded) cascade through make_eval_step: running statistics
    want_ev = jax.jit(jax_make_eval_step(jmodel, jnp.asarray(jreg)))(
        jstate, art_j, jnp.asarray(batch["pose2d"]))
    got_ev = make_eval_step(port, jreg, device="cpu")(art_t,
                                                      torch.from_numpy(batch["pose2d"]))
    for name, g, w in zip(("mesh mm", "reg_pose mm", "pose3d mm"), got_ev, want_ev):
        _close(g, w, rtol=1e-3, atol=1e-2, err_msg=name)


def test_train_step_full_smpl_width_matches_jax(seeded_eigsh, monkeypatch):  # noqa: F811
    """One step at full SMPL width (stand-in mesh, 9 levels, SMPL_BLOCKS,
    PoseNet 4096, 17 joints), batch 2, f32, against JAX use_pallas=False."""
    smpl = SMPL()
    pyr = build_pyramid(smpl.face, joint_num=17, skeleton=HUMAN36.skeleton,
                        flip_pairs=HUMAN36.flip_pairs, levels=9)
    art_j = jax_pack_pyramid(pyr, smpl.face)
    art_t = pack_pyramid(pyr, smpl.face, device="cpu")
    rng = np.random.default_rng(9)
    jreg = rng.random((17, 6890)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    batch = synthetic_batch(smpl.v_template, 2, jreg, rng)
    # lr 1: the step is the gradient itself, well above the float32 rounding
    # of the parameters it is read back from
    losses, got, want, init, _ = _run_steps(monkeypatch, art_j, art_t, None, 4096,
                                            batch, jreg, 1, lrs=(1.0,))
    t, j = losses[0]
    for k in j:
        # reg_joint is 1e-3 x an L1 in mm of two near-equal poses: atol 1e-5
        # is 1e-2 mm, the mesh tolerance of the full-width eval-step test
        _close(t[k], j[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # The steps (each tensor's change over the step).  At this width and
    # batch the gradient is ill-conditioned: nudging the 2D input by one part
    # in 1e6 moves the port's own MeshNet gradients by 1e-2 to 5e-2 (rel L2),
    # so the two frameworks' steps are held to that sensitivity, measured in
    # this run, and not to float32 rounding.  The running statistics (forward
    # only) are held tightly.  PoseNet's steps are not compared: its
    # BatchNorms see two rows, whose normalized values are +-1 whatever the
    # input, so its gradient is what rounding leaves (its train step is
    # compared at batch 4 and 8 above and below).
    assert_step_within_sensitivity(art_t, batch, jreg, got, want, init)


def assert_step_within_sensitivity(art_t, batch, jreg, got, want, init):
    """The port's step (state dict `got` from `init`, lr 1) against the JAX
    step (`want`): MeshNet's parameter changes within twice their measured
    sensitivity to a 1e-6 relative nudge of the 2D input, the running
    statistics within rtol 1e-3 (see the full-width test)."""
    assert sorted(got) == sorted(want)
    nudged = _port_sgd_step(art_t, init, dict(batch, pose2d=batch["pose2d"] * np.float32(1 + 1e-6)),
                            jreg, 1.0)
    steps = {"port": [], "jax": [], "nudged": []}
    for k in want:
        if k.endswith("num_batches_tracked") or k.startswith("pose_lifter."):
            continue
        if k.endswith(("running_mean", "running_var")):
            _close(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
            continue
        for side, sd in (("port", got), ("jax", want), ("nudged", nudged)):
            steps[side].append((sd[k] - init[k]).flatten())
    port, jax_, nudge = (torch.cat(steps[s]) for s in ("port", "jax", "nudged"))
    sensitivity = float((nudge - port).norm() / port.norm())
    cross = float((port - jax_).norm() / jax_.norm())
    assert 0.0 < sensitivity < 0.1, sensitivity
    assert cross <= 2.0 * sensitivity, (cross, sensitivity)


def _port_sgd_step(art_t, state_dict, batch, jreg, lr):
    """One port train step at full SMPL width (dropout off, SGD) from
    state_dict on batch; returns the state dict after it."""
    port = Pose2Mesh(art_t.joint_num, art_t.mesh_ops[-1].num_vertices, posenet_hidden=4096,
                     inference_fused=False, dropout=0.0, device="cpu")
    port.load_state_dict(state_dict)
    opt = make_preconditioner("sgd", port.parameters())
    step = make_train_step(port, opt, jreg, device="cpu")
    step(TrainState(port, opt), art_t, {k: torch.from_numpy(b) for k, b in batch.items()},
         lr, True, None)
    return port.state_dict()


def test_multi_train_step_equals_single_steps():
    """make_multi_train_step over a stacked batch == the same steps one by
    one (the port's own semantics; the JAX version is a lax.scan)."""
    _, faces = jax_uv_sphere(110)
    pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=2)
    art = pack_pyramid(pyr, faces, device="cpu")
    blocks = ((5, 8), (8, 8), (8, 3))
    rng = np.random.default_rng(10)
    jreg = rng.random((J, 110)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    template = (jax_uv_sphere(110)[0] * np.array([0.3, 0.2, 0.9])).astype(np.float32)
    batches = [synthetic_batch(template, 2, jreg, rng) for _ in range(2)]
    results = []
    for multi in (False, True):
        model = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=16,
                          blocks=blocks, inference_fused=False, device="cpu")
        opt = make_preconditioner("rmsprop", model.parameters())
        step = make_train_step(model, opt, jreg, device="cpu")
        state, gen = TrainState(model, opt), torch.Generator().manual_seed(0)
        if multi:
            stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
                       for k in batches[0]}
            state, losses = make_multi_train_step(step)(state, art, stacked, 1e-3,
                                                        True, gen)
            totals = losses["total"]
        else:
            totals = []
            for b in batches:
                state, losses = step(state, art, {k: torch.from_numpy(v)
                                                  for k, v in b.items()}, 1e-3, True, gen)
                totals.append(losses["total"])
            totals = torch.stack(totals)
        assert state.step == 2
        results.append((totals, model.state_dict()))
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=0)
    for k, v in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], v, rtol=0, atol=0)


def test_posenet_steps_match_jax(monkeypatch):
    """Three steps of make_posenet_steps (the lifter's trainer) == the JAX
    ones, then the eval step (SGD, for the reason given in _run_steps)."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    rng = np.random.default_rng(11)
    batch = {"pose2d": rng.standard_normal((8, J, 2)).astype(np.float32),
             "pose3d": (rng.standard_normal((8, J, 3)) * 50).astype(np.float32),
             "pose3d_valid": np.ones((8, J, 3), np.float32)}
    jnet = JaxPoseNet(num_joint=J, hidden=64)
    v = to_numpy(jnet.init(jax.random.PRNGKey(0), jnp.asarray(batch["pose2d"]), False))
    randomize_bn(v["params"], v["batch_stats"], rng)
    tx = jax_preconditioner("sgd")
    jstate = JaxTrainState.create(v, tx)
    jtrain, jeval = jax_posenet_steps(jnet, tx)
    net = PoseNet(J, hidden=64, dropout=0.0)
    net.load_state_dict(posenet_state_dict(v["params"], v["batch_stats"]))
    opt = make_preconditioner("sgd", net.parameters())
    train, evaluate = make_posenet_steps(net, opt)
    state = TrainState(net, opt)
    jb = {k: jnp.asarray(b) for k, b in batch.items()}
    tb = {k: torch.from_numpy(b) for k, b in batch.items()}
    for i in range(3):
        jstate, jloss = jax.jit(jtrain)(jstate, jb, jnp.float32(1e-2),
                                        jax.random.PRNGKey(1))
        state, tloss = train(state, tb, 1e-2, None)
        _close(tloss, jloss, rtol=1e-4, err_msg=f"step {i}")
    want = posenet_state_dict(to_numpy(jstate.params), to_numpy(jstate.batch_stats))
    _close_state(net.state_dict(), want)
    _close(evaluate(state, tb["pose2d"]), jeval(jstate, jb["pose2d"]),
           rtol=1e-3, atol=1e-3)
