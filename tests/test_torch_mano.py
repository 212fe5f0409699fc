"""PyTorch port: the MANO hand family end to end against the JAX package
(CPU, float32).

The MANO stand-in (778 vertices, 6 levels, 21 joints, MANO_BLOCKS, PoseNet
hidden 4096) packed at dense_threshold 768 has one band level (778 rows,
padded to 1024): its four convs run the band kernels' plain versions.
  * The deploy forward (BatchNorm folded) against the JAX eval step at
    rtol 1e-4 (atol 1e-2 mm), as the SMPL full-width test, with the route
    of each band conv counted: 2 basis + 2 commuted per forward, 4 strip,
    4 window, 8 hops on the further paths; each further path also against
    the JAX eval step under its switch (P2M_FLAT_IMPL, P2M_FUSED).
  * The train step's batch (LBS GT synthesised from seeded numpy inputs)
    against the same recipe through the JAX package's LBS, then one train
    step (SGD, dropout off, edge loss on, both on the banded face-corner
    backward): its losses against the JAX step at rtol 1e-4, each tensor's
    step against the JAX step computed in float64 (rel L2 5e-3; see the
    test), the running statistics as tests/test_torch_train.py holds them;
    4 K1 and 4 K2 calls per step.
  * The entry points raise without CUDA unless device="cpu" is passed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.mano import MANO as JaxMANO
from pose2mesh_release_tpu.core.train import TrainState as JaxTrainState
from pose2mesh_release_tpu.core.train import make_eval_step as jax_make_eval_step
from pose2mesh_release_tpu.data import gt_synth as jax_gt
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.models.fold import fold_bn_variables as jax_fold
from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh as JaxPose2Mesh
from pose2mesh_release_tpu_torch import deploy
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.core.train import make_eval_step
from pose2mesh_release_tpu_torch.data import gt_synth
from pose2mesh_release_tpu_torch.data.joint_sets import MANO_SET
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models import meshnet as port_meshnet
from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
from pose2mesh_release_tpu_torch.models.meshnet import MANO_BLOCKS
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as port_ft
from pose2mesh_release_tpu_torch.ops import hop as port_hop
from pose2mesh_release_tpu_torch.parity.from_jax import state_dict_from_flax
from pose2mesh_release_tpu_torch.train_setup import (
    mano_gt_inputs, mano_train_setup,
)

from test_torch_artifact import fixed_eigsh_start
from test_torch_models import _jax_unfolded_cascade, to_numpy
from test_torch_train import (
    _close, _jax_and_port_cascade, _run_steps, jax_make_train_step,
    jax_preconditioner,
)

COUNTED = ("fused_cheby_conv", "fused_cheby_conv_commuted", "strip_cheby_conv",
           "window_cheby_conv")


@pytest.fixture(scope="module")
def mano_arts():
    """The MANO pyramid packed by both packages at dense_threshold 768."""
    face = MANO().face
    with fixed_eigsh_start():
        pyr = build_pyramid(face, joint_num=21, skeleton=MANO_SET.skeleton,
                            flip_pairs=MANO_SET.flip_pairs, levels=6,
                            extra_joint_edges=MANO_SET.extra_edges)
        art_j = jax_pack_pyramid(pyr, face, dense_threshold=768)
        art_t = pack_pyramid(pyr, face, dense_threshold=768, device="cpu")
    return art_j, art_t


def _counter(calls, name, fn):
    def wrapper(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    return wrapper


def test_mano_artifact_levels(mano_arts):
    """One band level of 778 rows padded to nt 8 (Vp 1024), strip width 480
    at 128-row strip tiles, four dense levels; the face tables built."""
    _, art = mano_arts
    assert [(op.kind, op.num_vertices, op.padded_vertices) for op in art.mesh_ops] == [
        ("band", 778, 1024), ("dense", 395, 395), ("dense", 208, 208),
        ("dense", 108, 108), ("dense", 76, 76)]
    band = art.mesh_ops[0]
    assert band.band_val.shape == (3, 8, 128, 128) and band.band_k == 1
    assert tuple(band.strip_val.shape) == (1024, 480) and band.strip_h == 128
    assert art.face_sel.shape == (7, 128, 896) and len(art.face_inv) == 3


def test_mano_deploy_forward_matches_jax(mano_arts, monkeypatch):
    art_j, art_t = mano_arts
    jreg = MANO().joint_regressor_mano
    pose2d = np.random.default_rng(3).standard_normal((2, 21, 2)).astype(np.float32)
    v = _jax_unfolded_cascade(art_j, MANO_BLOCKS, 4096, pose2d, seed=3)
    fv = to_numpy(jax_fold(v))
    jmodel = JaxPose2Mesh(num_joint=21, mano=True, use_pallas=False, inference_fused=True)
    state = JaxTrainState(params=fv["params"], batch_stats=fv["batch_stats"],
                          opt_state=None, step=jnp.zeros((), jnp.int32))
    ref = jax.jit(jax_make_eval_step(jmodel, jnp.asarray(jreg)))(
        state, art_j, jnp.asarray(pose2d))

    calls = {}
    for name in ("fused_cheby_conv", "fused_cheby_conv_commuted"):
        monkeypatch.setattr(port_meshnet, name,
                            _counter(calls, name, getattr(port_meshnet, name)))
    model = Pose2Mesh(21, art_t.mesh_ops[-1].num_vertices, mano=True, device="cpu")
    model.load_state_dict(fold_bn_variables(state_dict_from_flax(v)))
    got = make_eval_step(model, jreg, device="cpu")(art_t, torch.from_numpy(pose2d))
    assert calls == {"fused_cheby_conv": 2, "fused_cheby_conv_commuted": 2}
    shapes = ((2, 778, 3), (2, 21, 3), (2, 21, 3))
    for name, shape, g, r in zip(("mesh_mm", "reg_pose", "pose3d"), shapes, got, ref):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-2,
                                   err_msg=name)


# the further deploy paths: the JAX switch, the port's Pose2Mesh arguments,
# the band-conv calls of one forward
MANO_PATHS = {
    "strip": ({"P2M_FLAT_IMPL": "strip"}, {"flat_impl": "strip"}, {"strip_cheby_conv": 4}),
    "window": ({"P2M_FLAT_IMPL": "window"}, {"flat_impl": "window"},
               {"window_cheby_conv": 4}),
    "unfused": ({"P2M_FUSED": "0"}, {"fused": False}, {"banded_hop": 8}),
}


@pytest.mark.parametrize("path", sorted(MANO_PATHS))
def test_mano_deploy_path_matches_jax(path, mano_arts, monkeypatch):
    """The float32 deploy forward on the strip, window or unfused path against
    the JAX eval step under the same switch (P2M_FLAT_IMPL, P2M_FUSED; its
    Pallas kernels in interpret mode) at rtol 1e-4, with the path's calls of
    one forward counted."""
    art_j, art_t = mano_arts
    env, kw, counts = MANO_PATHS[path]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jax.clear_caches()  # the switches are read when the forward is traced
    jreg = MANO().joint_regressor_mano
    pose2d = np.random.default_rng(4).standard_normal((2, 21, 2)).astype(np.float32)
    v = _jax_unfolded_cascade(art_j, MANO_BLOCKS, 4096, pose2d, seed=4)
    fv = to_numpy(jax_fold(v))
    jmodel = JaxPose2Mesh(num_joint=21, mano=True, inference_fused=True)
    state = JaxTrainState(params=fv["params"], batch_stats=fv["batch_stats"],
                          opt_state=None, step=jnp.zeros((), jnp.int32))
    ref = jax.jit(jax_make_eval_step(jmodel, jnp.asarray(jreg)))(
        state, art_j, jnp.asarray(pose2d))

    calls = {}
    for name in COUNTED:
        monkeypatch.setattr(port_meshnet, name,
                            _counter(calls, name, getattr(port_meshnet, name)))
    monkeypatch.setattr(port_hop, "hop", _counter(calls, "banded_hop", port_hop.hop))
    model = Pose2Mesh(21, art_t.mesh_ops[-1].num_vertices, mano=True, device="cpu", **kw)
    model.load_state_dict(fold_bn_variables(state_dict_from_flax(v)))
    got = make_eval_step(model, jreg, device="cpu")(art_t, torch.from_numpy(pose2d))
    assert calls == counts
    shapes = ((2, 778, 3), (2, 21, 3), (2, 21, 3))
    for name, shape, g, r in zip(("mesh_mm", "reg_pose", "pose3d"), shapes, got, ref):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-2,
                                   err_msg=name)


def test_mano_paths_route_every_band_conv(monkeypatch):
    """mano_deploy_forward on each path (`deploy.on_path`): 2 + 2 group
    convs, 4 strip convs, 4 window convs, or 8 hops and no fused conv, and
    the same mesh and joints as the group path."""
    d = deploy.mano_deploy_forward(dtype=torch.float32, device="cpu", seed=0)
    assert d.j_regressor.shape == (21, 778)
    calls = {}
    for name in COUNTED:
        monkeypatch.setattr(port_meshnet, name,
                            _counter(calls, name, getattr(port_meshnet, name)))
    monkeypatch.setattr(port_hop, "hop", _counter(calls, "banded_hop", port_hop.hop))
    pose2d = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 21, 2))
                              .astype(np.float32))
    want = {"group": ({}, {"fused_cheby_conv": 2, "fused_cheby_conv_commuted": 2}),
            "strip": ({"flat_impl": "strip"}, {"strip_cheby_conv": 4}),
            "window": ({"flat_impl": "window"}, {"window_cheby_conv": 4}),
            "unfused": ({"fused": False}, {"banded_hop": 8})}
    outs = {}
    for path, (kw, counts) in want.items():
        step = deploy.on_path(d, **kw).eval_step if kw else d.eval_step
        calls.clear()
        outs[path] = step(d.art_compute, pose2d)
        assert calls == counts, path
        assert [tuple(t.shape) for t in outs[path]] == [(2, 778, 3), (2, 21, 3), (2, 21, 3)]
    for path, out in outs.items():
        for name, got, ref in zip(("mesh", "reg_pose"), out, outs["group"]):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3, msg=f"{path} {name}")


def _jax_mano_batch(pose, shape):
    """The mano_train_setup batch through the JAX package's LBS (float64
    recipe steps in numpy)."""
    jm = JaxMANO()
    B = pose.shape[0]
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3))
    t = np.broadcast_to(np.array([0.0, 0.0, 500.0], np.float32), (B, 3))
    mesh_mm, _ = jax_gt.posed_mesh_rotated(jm.params, jnp.asarray(pose), jnp.asarray(shape),
                                           jnp.asarray(R), jnp.asarray(t))
    reg = jnp.asarray(jm.joint_regressor_mano)
    root = jax_gt.regress_joints(reg, mesh_mm)[:, :1]
    mesh = (mesh_mm - root) / 1000.0
    joints = jax_gt.regress_joints(reg, mesh) * 1000.0
    return np.asarray(mesh), np.asarray(joints)


def _jax_step_f64(jmodel_kw, v, art_j, batch, jreg, lr):
    """One JAX make_train_step (SGD, edge loss on) computed in float64 from
    the float32 variables v; returns the state dict after it."""
    jax.config.update("jax_enable_x64", True)
    try:
        jm = JaxPose2Mesh(**jmodel_kw, dtype=jnp.float64)
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        tx = jax_preconditioner("sgd")
        st = JaxTrainState.create({"params": f64(v["params"]),
                                   "batch_stats": f64(v["batch_stats"])}, tx)
        step = jax.jit(jax_make_train_step(jm, tx, jnp.asarray(jreg, jnp.float64)))
        st, _ = step(st, art_j, {k: jnp.asarray(b, jnp.float64) for k, b in batch.items()},
                     jnp.float64(lr), jnp.bool_(True), jax.random.PRNGKey(0))
        return state_dict_from_flax(to_numpy({"params": st.params,
                                              "batch_stats": st.batch_stats}))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_mano_train_step_matches_jax(mano_arts, monkeypatch):
    art_j, art_t = mano_arts
    setup = mano_train_setup(dtype=torch.float32, device="cpu", batch=4, seed=3)
    batch = {k: v.numpy() for k, v in setup.batch.items()}
    # the batch: LBS GT from the same numpy inputs through the JAX package
    pose, shape = mano_gt_inputs(4, np.random.default_rng(3))
    mesh, joints = _jax_mano_batch(pose, shape)
    np.testing.assert_allclose(batch["mesh"], mesh, rtol=0, atol=1e-6)  # 1e-3 mm
    np.testing.assert_allclose(batch["reg_pose3d"], joints, rtol=0, atol=1e-3)
    np.testing.assert_allclose(batch["pose2d"], joints[..., :2] / 500.0, rtol=0, atol=1e-5)
    assert batch["mesh"].shape == (4, 778, 3) and batch["pose2d"].shape == (4, 21, 2)
    np.testing.assert_array_equal(setup.j_regressor, MANO().joint_regressor_mano)

    calls = {}
    for name in ("fused_cheby_conv_train", "fused_cheby_conv_bwd"):
        monkeypatch.setattr(port_ft, name, _counter(calls, name, getattr(port_ft, name)))
    lr = 1e-2
    losses, got, want, _, _ = _run_steps(
        monkeypatch, art_j, art_t, MANO_BLOCKS, 4096, batch, setup.j_regressor, 1,
        lrs=(lr,))
    assert calls == {"fused_cheby_conv_train": 4, "fused_cheby_conv_bwd": 4}
    for k, w in losses[0][1].items():
        _close(losses[0][0][k], w, rtol=1e-4, atol=1e-7, err_msg=k)
    # The step against the JAX step computed in float64.  In float32 this
    # random-init step is ill-conditioned: the edge loss's gradient (its
    # weight 20, its vertex sum zero) crossing the BatchNorms of the MANO
    # levels moves the JAX package's float32 MeshNet gradients 1-3% from its
    # own float64 ones, and the port's by at most 0.13%; the two float64
    # steps agree to 3e-7.  So each tensor's step (its change) is held to
    # 5e-3 relative L2 of the float64 step (+1e-6 for the biases that feed a
    # BatchNorm, whose exact gradient is zero), the running statistics as in
    # the SMPL step tests.
    v = _jax_and_port_cascade(art_j, art_t, MANO_BLOCKS, 4096, batch["pose2d"], seed=7)[1]
    init = state_dict_from_flax(v)
    want64 = _jax_step_f64(dict(num_joint=21, posenet_hidden=4096, blocks=MANO_BLOCKS,
                                use_pallas=False), v, art_j, batch, setup.j_regressor, lr)
    assert sorted(got) == sorted(want64) == sorted(want)
    for k, w in want64.items():
        if k.endswith("num_batches_tracked"):
            continue
        w = torch.from_numpy(np.asarray(w, np.float64))
        if k.endswith(("running_mean", "running_var")):
            _close(got[k], w.float(), rtol=1e-3, atol=1e-5, err_msg=k)
            continue
        step, exact = (got[k].double() - init[k].double()), (w - init[k].double())
        err = float((step - exact).norm())
        assert err <= 5e-3 * float(exact.norm()) + 1e-6, (k, err, float(exact.norm()))


@pytest.mark.parametrize("entry", ["mano_deploy_forward", "mano_train_setup", "batched_gt"])
def test_mano_entry_points_need_cuda_unless_cpu_is_asked(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    calls = {
        "mano_deploy_forward": lambda **kw: deploy.mano_deploy_forward(**kw),
        "mano_train_setup": lambda **kw: mano_train_setup(batch=2, **kw),
        "batched_gt": lambda **kw: gt_synth.batched_gt(
            lambda x: x, (np.zeros((3, 2), np.float32),), batch=2, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None
