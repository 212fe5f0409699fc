"""PyTorch port: the training MeshNet against the JAX MeshNet on its Pallas
path (default env: the BatchNorm fold chain with kernel statistics, Pallas
in interpret mode, jitted), CPU f32: output, gradients and updated running
statistics of a training forward, and the eval forward of the same net (also
with fused=False against P2M_FUSED=0, where the first conv of each band
block takes the unfused form).
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


def test_training_meshnet_unfused_eval_matches_jax(fold_net, monkeypatch):
    """fused=False == P2M_FUSED=0 on the eval forward: the convs the JAX
    MeshNet sends through `fused_cheby_project` (the first of each band
    block) run as two hops and three projections."""
    from pose2mesh_release_tpu_torch.ops import hop as port_hop
    art_j, art_t, x, net, v, _ = fold_net
    port = MeshNet(J, art_t.mesh_ops[-1].num_vertices, blocks=FOLD_BLOCKS,
                   inference_fused=False, fused=False)
    port.load_state_dict(meshnet_state_dict(v["params"], v["batch_stats"]))
    monkeypatch.setenv("P2M_FUSED", "0")
    jax.clear_caches()  # the switch is read when the forward is traced
    want = jax.jit(lambda vv, xx: net.apply(vv, art_j, xx, False))(v, jnp.asarray(x))
    before = port_hop.launches["banded_hop"]
    hops = []

    def counted_hop(band, x):
        hops.append(x.shape)
        return port_hop.hop_plain(band, x)
    monkeypatch.setattr(port_hop, "hop", counted_hop)
    with torch.inference_mode():
        got = port(art_t, torch.from_numpy(x), train=False)
    _close(got, want, rtol=1e-4, atol=1e-5)
    n_band_blocks = sum(op.kind == "band" for op in port._ops(art_t))
    assert len(hops) == 2 * n_band_blocks and port_hop.launches["banded_hop"] == before
