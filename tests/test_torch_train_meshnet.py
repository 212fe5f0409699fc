"""PyTorch port: the training MeshNet against the JAX MeshNet on its Pallas
path (default env: the BatchNorm fold chain with kernel statistics, Pallas
in interpret mode, jitted), CPU f32: output, gradients and updated running
statistics of a training forward, and the eval forward of the same net.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.synthetic import uv_sphere as jax_uv_sphere
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.models.meshnet import MeshNet as JaxMeshNet
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.meshnet import MeshNet
from pose2mesh_release_tpu_torch.parity.from_jax import meshnet_state_dict

from test_torch_artifact import fixed_eigsh_start
from test_torch_models import randomize_bn, to_numpy
from test_torch_train import FOLD_BLOCKS, J, SKEL, _close


@pytest.fixture(scope="module")
def fold_net():
    """uv_sphere(770), 4 levels, all band (tests/test_pallas.py:543-550), the
    JAX MeshNet's variables with random BatchNorm, and the same port net."""
    _, faces = jax_uv_sphere(770)
    with fixed_eigsh_start():
        pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=4)
        art_j = jax_pack_pyramid(pyr, faces, dense_threshold=128)
        art_t = pack_pyramid(pyr, faces, dense_threshold=128, device="cpu")
    assert all(op.kind == "band" for op in art_t.mesh_ops)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, J, 5)).astype(np.float32)
    net = JaxMeshNet(blocks=FOLD_BLOCKS)
    v = to_numpy(jax.jit(net.init, static_argnums=3)(
        jax.random.PRNGKey(0), art_j, jnp.asarray(x), True))
    randomize_bn(v["params"], v["batch_stats"], rng)
    port = MeshNet(J, art_t.mesh_ops[-1].num_vertices, blocks=FOLD_BLOCKS,
                   inference_fused=False)
    port.load_state_dict(meshnet_state_dict(v["params"], v["batch_stats"]))
    return art_j, art_t, x, net, v, port


def test_training_meshnet_matches_pallas_fold_chain(fold_net, monkeypatch):
    """Output, gradients wrt every parameter and the updated batch_stats of
    one training forward (tolerances of tests/test_pallas.py:574-580)."""
    monkeypatch.delenv("P2M_FOLD_BN", raising=False)
    monkeypatch.delenv("P2M_KERNEL_BN", raising=False)
    art_j, art_t, x, net, v, port = fold_net
    port.load_state_dict(meshnet_state_dict(v["params"], v["batch_stats"]))

    def loss(params):
        out, mut = net.apply({"params": params, "batch_stats": v["batch_stats"]},
                             art_j, jnp.asarray(x), True, mutable=["batch_stats"])
        return (out ** 2).mean(), (out, mut["batch_stats"])

    (l_j, (out_j, bs_j)), g_j = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        v["params"])
    port.zero_grad()
    out_t = port(art_t, torch.from_numpy(x), train=True)
    l_t = (out_t ** 2).mean()
    l_t.backward()

    _close(l_t.detach(), l_j, rtol=1e-4)
    _close(out_t.detach(), out_j, rtol=1e-3, atol=1e-4)
    stats = meshnet_state_dict(to_numpy(g_j), to_numpy(bs_j))
    got = port.state_dict()
    grads = dict(port.named_parameters())
    for k, want in stats.items():
        if k.endswith(("running_mean", "running_var")):
            _close(got[k], want, rtol=2e-3, atol=1e-3, err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            _close(grads[k].grad, want, rtol=2e-2, atol=2e-3, err_msg=k)


def test_training_meshnet_eval_forward_matches_jax(fold_net):
    """The unfolded eval forward (running statistics, the fold chain without
    statistics) == JAX MeshNet(train=False)."""
    art_j, art_t, x, net, v, port = fold_net
    port.load_state_dict(meshnet_state_dict(v["params"], v["batch_stats"]))
    want = jax.jit(lambda vv, xx: net.apply(vv, art_j, xx, False))(v, jnp.asarray(x))
    with torch.inference_mode():
        got = port(art_t, torch.from_numpy(x), train=False)
    _close(got, want, rtol=1e-4, atol=1e-5)
