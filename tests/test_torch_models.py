"""PyTorch port: PoseNet, BatchNorm folding, the deploy MeshNet and the full
SMPL-width cascade with make_eval_step, against the JAX package (CPU, f32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pose2mesh_release_tpu.core.train import TrainState
from pose2mesh_release_tpu.core.train import make_eval_step as jax_make_eval_step
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.models.fold import fold_bn_variables as jax_fold
from pose2mesh_release_tpu.models.meshnet import MeshNet as JaxMeshNet
from pose2mesh_release_tpu.models.meshnet import extract_mesh as jax_extract_mesh
from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh as JaxPose2Mesh
from pose2mesh_release_tpu.models.posenet import PoseNet as JaxPoseNet
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.core.train import make_eval_step
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models import meshnet as port_meshnet
from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
from pose2mesh_release_tpu_torch.models.meshnet import MeshNet, extract_mesh
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.models.posenet import PoseNet
from pose2mesh_release_tpu_torch.parity.from_jax import (
    meshnet_state_dict, posenet_state_dict, state_dict_from_flax,
)

from test_torch_artifact import fixed_eigsh_start, grid_faces, seeded_eigsh  # noqa: F401

J = 7
SKEL = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]
# tests/test_models.py::test_flat_deploy_path_matches_3d blocks
GRID_BLOCKS = ((5, 16, 16), (16, 32), (32, 32), (32, 16), (16, 8, 3))


def to_numpy(tree):
    """Flax variables -> nested dicts of numpy arrays (fresh, mutable)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def randomize_bn(params, stats, rng):
    """Non-identity BatchNorm scale/bias and running statistics, in place."""
    for name, p in params.items():
        if name.startswith("BatchNorm"):
            n = p["scale"].shape
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
            stats[name]["mean"] = rng.normal(0.0, 0.1, n).astype(np.float32)
            stats[name]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif isinstance(p, dict):
            randomize_bn(p, stats.get(name, {}), rng)


def test_posenet_eval_parity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, J * 2)).astype(np.float32)
    net = JaxPoseNet(num_joint=J, hidden=64)
    v = to_numpy(net.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    randomize_bn(v["params"], v["batch_stats"], rng)
    ref = np.asarray(net.apply(v, jnp.asarray(x), False))

    port = PoseNet(J, hidden=64).eval()
    port.load_state_dict(posenet_state_dict(v["params"], v["batch_stats"]))
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def grid_art():
    faces = grid_faces(6, 260)
    with fixed_eigsh_start():
        pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=4)
        return (jax_pack_pyramid(pyr, faces, dense_threshold=100),
                pack_pyramid(pyr, faces, dense_threshold=100, device="cpu"))


def _jax_unfolded_cascade(art, blocks, hidden, x, seed):
    model = JaxPose2Mesh(num_joint=x.shape[1], posenet_hidden=hidden,
                         blocks=blocks, use_pallas=False)
    v = to_numpy(jax.jit(model.init, static_argnums=3)(
        jax.random.PRNGKey(seed), art, jnp.asarray(x), False))
    randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(seed))
    return v


def test_fold_matches_jax(grid_art):
    art_j, _ = grid_art
    x = np.random.default_rng(1).standard_normal((2, J, 2)).astype(np.float32)
    v = _jax_unfolded_cascade(art_j, GRID_BLOCKS, 32, x, seed=1)
    sd = state_dict_from_flax(v)
    assert any(k.startswith("pose2mesh.bn.") for k in sd)
    want = state_dict_from_flax(to_numpy(jax_fold(v)))
    got = fold_bn_variables(sd)
    assert sorted(got) == sorted(want)
    assert not any(k.startswith("pose2mesh.bn.") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_deploy_meshnet_parity(grid_art):
    """Port MeshNet (plain band convs) == JAX MeshNet(inference_fused=True)
    on its flat Pallas path (interpret mode), compared after extract_mesh."""
    art_j, art_t = grid_art
    assert all(op.kind == "band" for op in art_t.mesh_ops)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, J, 5)).astype(np.float32)
    net = JaxMeshNet(blocks=GRID_BLOCKS)
    v = to_numpy(jax.jit(net.init, static_argnums=3)(
        jax.random.PRNGKey(2), art_j, jnp.asarray(x), False))
    randomize_bn(v["params"], v["batch_stats"], rng)
    folded = to_numpy(jax_fold({"params": {"pose2mesh": v["params"]},
                                "batch_stats": {"pose2mesh": v["batch_stats"]}}))
    fp = folded["params"]["pose2mesh"]
    netf = JaxMeshNet(blocks=GRID_BLOCKS, inference_fused=True)
    ref = np.asarray(jax_extract_mesh(
        art_j, netf.apply({"params": fp}, art_j, jnp.asarray(x), False)))

    port = MeshNet(J, art_t.mesh_ops[-1].num_vertices, blocks=GRID_BLOCKS)
    port.load_state_dict(meshnet_state_dict(fp, {}))
    with torch.inference_mode():
        got = extract_mesh(art_t, port(art_t, torch.from_numpy(x)))
    assert got.shape == ref.shape == (4, 1560, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_deploy_meshnet_follows_reloaded_weights(grid_art):
    """The band convs derive their kernels' weights from the parameters on
    every forward: after a new state dict is loaded a reused net matches a
    fresh one."""
    _, art_t = grid_art
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, J, 5)).astype(np.float32))
    nv = art_t.mesh_ops[-1].num_vertices
    torch.manual_seed(4)
    net, other = MeshNet(J, nv, blocks=GRID_BLOCKS), MeshNet(J, nv, blocks=GRID_BLOCKS)
    with torch.inference_mode():
        first = net(art_t, x)
        assert torch.equal(net(art_t, x), first)
        net.load_state_dict(other.state_dict())
        got, want = net(art_t, x), other(art_t, x)
    assert not torch.allclose(got, first)
    assert torch.equal(got, want)


@pytest.mark.parametrize("commuted", [False, True], ids=["basis", "commuted"])
def test_conv_weights_match_the_old_layout(commuted):
    """`MeshNet._conv_weights` is bit-equal, in float32 and bf16, to the
    layout the deploy form once built and kept apart from the parameters
    (its expression inlined here)."""
    for dtype in (torch.float32, torch.bfloat16):
        net = MeshNet(J, 10, blocks=GRID_BLOCKS, dtype=dtype)
        for lin in net.cl:
            w, bias = lin.weight, lin.bias
            fout, fin = w.shape[0], w.shape[1] // 3
            W = w.detach().to(dtype).t().reshape(fin, 3, fout).permute(1, 0, 2)
            if commuted:
                W = torch.stack([W[0] - W[2], W[1], W[2]])
            want = (W.reshape(3 * fin, fout).contiguous(), bias.detach().to(dtype).contiguous())
            got = net._conv_weights(lin, commuted)
            for g, o in zip(got, want):
                assert g.dtype == dtype and g.is_contiguous() and torch.equal(g, o)


def test_cascade_eval_step_full_smpl_width(seeded_eigsh, monkeypatch):  # noqa: F811
    """SMPL stand-in, 9 levels, SMPL_BLOCKS, PoseNet hidden 4096, B=2, f32:
    the port's make_eval_step == the JAX one on Pose2Mesh(use_pallas=False,
    inference_fused=True) with folded weights, and the band convs route to
    8 basis-form and 2 commuted-form kernel calls per forward."""
    smpl = SMPL()
    pyr = build_pyramid(smpl.face, joint_num=17, skeleton=HUMAN36.skeleton,
                        flip_pairs=HUMAN36.flip_pairs, levels=9)
    art_j = jax_pack_pyramid(pyr, smpl.face)
    art_t = pack_pyramid(pyr, smpl.face, device="cpu")
    assert [op.padded_vertices for op in art_t.mesh_ops[:4]] == \
        [7168, 3584, 2048, 1024]
    jreg = smpl.joint_regressor_h36m
    pose2d = np.random.default_rng(3).standard_normal((2, 17, 2)).astype(np.float32)

    v = _jax_unfolded_cascade(art_j, None, 4096, pose2d, seed=3)
    fv = to_numpy(jax_fold(v))
    jmodel = JaxPose2Mesh(num_joint=17, use_pallas=False, inference_fused=True)
    state = TrainState(params=fv["params"], batch_stats=fv["batch_stats"],
                       opt_state=None, step=jnp.zeros((), jnp.int32))
    ref = jax.jit(jax_make_eval_step(jmodel, jnp.asarray(jreg)))(
        state, art_j, jnp.asarray(pose2d))

    calls = {"basis": 0, "commuted": 0}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(port_meshnet, "fused_cheby_conv",
                        counted("basis", port_meshnet.fused_cheby_conv))
    monkeypatch.setattr(port_meshnet, "fused_cheby_conv_commuted",
                        counted("commuted", port_meshnet.fused_cheby_conv_commuted))

    model = Pose2Mesh(17, art_t.mesh_ops[-1].num_vertices, device="cpu")
    model.load_state_dict(fold_bn_variables(state_dict_from_flax(v)))
    got = make_eval_step(model, jreg, device="cpu")(art_t, torch.from_numpy(pose2d))
    assert calls == {"basis": 8, "commuted": 2}
    names = ("mesh_mm", "reg_pose", "pose3d")
    shapes = ((2, 6890, 3), (2, 17, 3), (2, 17, 3))
    for name, shape, g, r in zip(names, shapes, got, ref):
        assert g.shape == shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-2, err_msg=name)
