"""PyTorch port: the deploy MeshNet on its three further paths against the JAX
MeshNet under the switch each mirrors (Pallas in interpret mode, CPU f32,
compared after extract_mesh):

  flat_impl="strip"   <->  P2M_FLAT_IMPL=strip  (strip convs)
  flat_impl="window"  <->  P2M_FLAT_IMPL=window (window convs)
  fused=False         <->  P2M_FUSED=0          (two hops per conv, skip after
                                                 the block)

on the grid pyramid of tests/test_models.py::test_flat_deploy_path_matches_3d,
with the band convs' routes counted.  Tolerance rtol 1e-4, atol 1e-5, as the
group path's test_torch_models.py::test_deploy_meshnet_parity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.models.fold import fold_bn_variables as jax_fold
from pose2mesh_release_tpu.models.meshnet import MeshNet as JaxMeshNet
from pose2mesh_release_tpu.models.meshnet import extract_mesh as jax_extract_mesh
from pose2mesh_release_tpu_torch.graphs.artifact import load_artifact, save_artifact, window_cat
from pose2mesh_release_tpu_torch.models import meshnet as port_meshnet
from pose2mesh_release_tpu_torch.models.meshnet import MeshNet, extract_mesh, flat_route
from pose2mesh_release_tpu_torch.ops import hop as port_hop
from pose2mesh_release_tpu_torch.parity.from_jax import meshnet_state_dict

from test_torch_models import GRID_BLOCKS, J, grid_art, randomize_bn, to_numpy  # noqa: F401

PATHS = {
    "strip": ({"P2M_FLAT_IMPL": "strip"}, {"flat_impl": "strip"}),
    "window": ({"P2M_FLAT_IMPL": "window"}, {"flat_impl": "window"}),
    "unfused": ({"P2M_FUSED": "0"}, {"fused": False}),
}
COUNTED = ("fused_cheby_conv", "fused_cheby_conv_commuted", "strip_cheby_conv",
           "window_cheby_conv")


@pytest.fixture(scope="module")
def folded(grid_art):  # noqa: F811
    """Folded deploy weights of a JAX MeshNet with random BatchNorm."""
    art_j, _ = grid_art
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, J, 5)).astype(np.float32)
    net = JaxMeshNet(blocks=GRID_BLOCKS)
    v = to_numpy(jax.jit(net.init, static_argnums=3)(
        jax.random.PRNGKey(7), art_j, jnp.asarray(x), False))
    randomize_bn(v["params"], v["batch_stats"], rng)
    fv = to_numpy(jax_fold({"params": {"pose2mesh": v["params"]},
                            "batch_stats": {"pose2mesh": v["batch_stats"]}}))
    return x, fv["params"]["pose2mesh"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_deploy_meshnet_path_matches_jax(path, grid_art, folded, monkeypatch):  # noqa: F811
    art_j, art_t = grid_art
    x, fp = folded
    env, kw = PATHS[path]
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jax.clear_caches()  # the switches are read when the forward is traced
    netf = JaxMeshNet(blocks=GRID_BLOCKS, inference_fused=True)
    ref = np.asarray(jax.jit(lambda p, xx: jax_extract_mesh(
        art_j, netf.apply({"params": p}, art_j, xx, False)))(fp, jnp.asarray(x)))

    calls = dict.fromkeys(COUNTED + ("banded_hop",), 0)

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper
    for name in COUNTED:
        monkeypatch.setattr(port_meshnet, name, counted(name, getattr(port_meshnet, name)))
    monkeypatch.setattr(port_hop, "hop", counted("banded_hop", port_hop.hop))

    port = MeshNet(J, art_t.mesh_ops[-1].num_vertices, blocks=GRID_BLOCKS, **kw)
    port.load_state_dict(meshnet_state_dict(fp, {}))
    with torch.inference_mode():
        got = extract_mesh(art_t, port(art_t, torch.from_numpy(x)))
    assert got.shape == ref.shape == (4, 1560, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)

    levels = port._ops(art_t)
    band_convs = sum(len(c) - 1 for op, c in zip(levels, GRID_BLOCKS) if op.kind == "band")
    assert band_convs > 0
    if path == "unfused":
        want = dict.fromkeys(COUNTED, 0) | {"banded_hop": 2 * band_convs}
    else:
        assert all(flat_route(op, path) == path for op in levels if op.kind == "band")
        want = dict.fromkeys(COUNTED + ("banded_hop",), 0) | {
            f"{path}_cheby_conv": band_convs}
    assert calls == want


def test_paths_agree_on_the_same_weights(grid_art):  # noqa: F811
    """A module built for each path, loaded with the group module's weights,
    gives the group module's output."""
    _, art_t = grid_art
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, J, 5))
                         .astype(np.float32))
    nv = art_t.mesh_ops[-1].num_vertices
    net = MeshNet(J, nv, blocks=GRID_BLOCKS)
    with torch.inference_mode():
        base = net(art_t, x)
    for kw in ({"flat_impl": "strip"}, {"flat_impl": "window"}, {"fused": False}):
        other = MeshNet(J, nv, blocks=GRID_BLOCKS, **kw)
        other.load_state_dict(net.state_dict())
        with torch.inference_mode():
            got = other(art_t, x)
        torch.testing.assert_close(got, base, rtol=1e-4, atol=1e-5)


def test_artifact_carries_the_window_form(grid_art, tmp_path):  # noqa: F811
    """Each band level of nt >= 2k+1 row tiles carries `window_cat` of its
    band; `.to(dtype)` casts it (its offsets stay int32) and `load_artifact`
    rebuilds it (it is not saved)."""
    _, art_t = grid_art
    band = [op for op in art_t.mesh_ops if op.kind == "band"]
    assert any(op.window_val.numel() for op in band)
    for op in band:
        if op.band_val.shape[1] < 2 * op.band_k + 1:
            assert op.window_val.numel() == op.window_off.numel() == 0
            continue
        win, woff = window_cat(op.band_val)
        assert torch.equal(op.window_val, win) and torch.equal(op.window_off, woff)
        assert op.window_off.dtype == torch.int32
    half = art_t.to("cpu", torch.bfloat16)
    for op, h in zip(art_t.mesh_ops, half.mesh_ops):
        assert h.window_val.dtype == torch.bfloat16 and h.window_off.dtype == torch.int32
        assert torch.equal(h.window_val, op.window_val.to(torch.bfloat16))
        assert torch.equal(h.window_off, op.window_off)
    path = str(tmp_path / "art.npz")
    save_artifact(path, art_t)
    assert not [k for k in np.load(path).files if "window" in k]
    for op, back in zip(art_t.mesh_ops, load_artifact(path, device="cpu").mesh_ops):
        assert torch.equal(back.window_val, op.window_val)
        assert torch.equal(back.window_off, op.window_off)


def test_unknown_paths_raise(grid_art):  # noqa: F811
    _, art_t = grid_art
    nv = art_t.mesh_ops[-1].num_vertices
    with pytest.raises(ValueError):
        MeshNet(J, nv, blocks=GRID_BLOCKS, flat_impl="band")
    with pytest.raises(ValueError):  # flat_impl picks fused kernels
        MeshNet(J, nv, blocks=GRID_BLOCKS, flat_impl="strip", fused=False)
    with pytest.raises(ValueError):
        MeshNet(J, nv, blocks=GRID_BLOCKS, fused=0)
    with pytest.raises(ValueError):
        flat_route(art_t.mesh_ops[0], "windows")


def test_full_smpl_width_paths_route_every_band_conv(monkeypatch):
    """The SMPL deploy forward (stand-in mesh, 9 levels, batch 2, f32 on the
    CPU) on each path (`deploy.on_path`): 8 + 2 group convs, 10 strip
    convs, 10 window convs, or 20 hops and no fused conv, and the same
    mesh and joints as the group path."""
    from pose2mesh_release_tpu_torch.deploy import on_path, smpl_deploy_forward

    d = smpl_deploy_forward(dtype=torch.float32, device="cpu", seed=0)
    assert [tuple(op.strip_val.shape) for op in d.art.mesh_ops[:4]] == \
        [(7168, 320), (3584, 336), (2048, 384), (1024, 320)]
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper
    for name in COUNTED:
        monkeypatch.setattr(port_meshnet, name, counted(name, getattr(port_meshnet, name)))
    monkeypatch.setattr(port_hop, "hop", counted("banded_hop", port_hop.hop))
    pose2d = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 17, 2))
                              .astype(np.float32))
    want = {"group": {"fused_cheby_conv": 8, "fused_cheby_conv_commuted": 2},
            "strip": {"strip_cheby_conv": 10}, "window": {"window_cheby_conv": 10},
            "unfused": {"banded_hop": 20}}
    outs = {}
    for path, counts in want.items():
        step = on_path(d, **PATHS[path][1]).eval_step if path in PATHS else d.eval_step
        calls.clear()
        outs[path] = step(d.art_compute, pose2d)
        assert calls == counts, path
    for path, out in outs.items():
        for name, got, ref in zip(("mesh", "reg_pose"), out, outs["group"]):
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3, msg=f"{path} {name}")
