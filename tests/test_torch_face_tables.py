"""PyTorch port: the artifact's face tables and the face corners' backward
against the JAX package (CPU, float32).

Bit-equal: `face_band_tables` and `face_inverse_tables` (the
tests/test_train.py::test_face_band_scatter_parity mesh), the tables
`pack_pyramid` packs, `pack_pyramid(ordering="tree")` and
`sparse_kind="bcsr"`, and the npz face fields in both directions.  The
three backwards of the face corners (`face_take3_band`, `face_take`, the
index gathers) against the JAX ones: forward equal, the gradient of the
normal + edge losses at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.core import losses as jl
from pose2mesh_release_tpu.graphs import artifact as jax_artifact
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.core import losses as tl
from pose2mesh_release_tpu_torch.graphs import artifact
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid

from test_torch_artifact import SKEL, assert_artifacts_equal, fixed_eigsh_start

V = 770


@pytest.fixture(scope="module")
def sphere():
    """uv_sphere(770) faces and a non-identity device order."""
    faces = uv_sphere(V)[1].astype(np.int32)
    vg = np.random.default_rng(21).permutation(V)
    return faces, vg


def test_face_tables_bit_equal(sphere):
    faces, vg = sphere
    perm, sel = artifact.face_band_tables(faces, vg, V, T=128)
    want_perm, want_sel = jax_artifact.face_band_tables(faces, vg.astype(np.int32), V, T=128)
    assert sel.size and perm.dtype == np.int64 and sel.dtype == np.float32
    np.testing.assert_array_equal(perm, np.asarray(want_perm))
    np.testing.assert_array_equal(sel, np.asarray(want_sel))
    got_inv = artifact.face_inverse_tables(faces, V)
    want_inv = jax_artifact.face_inverse_tables(faces, V)
    assert len(got_inv) == 3
    for g, w in zip(got_inv, want_inv):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, np.asarray(w))


def test_face_tables_grid_and_refusal(sphere):
    """The tile grid covers the largest device position (tree-ordered
    artifacts keep fake slots past num_v); a tile needing W > max_w gives
    empty tables, as no faces do."""
    faces, vg = sphere
    spread = vg + 300  # positions up to V + 299
    perm, sel = artifact.face_band_tables(faces, spread, V, T=128)
    want_perm, want_sel = jax_artifact.face_band_tables(faces, spread.astype(np.int32), V)
    assert sel.shape[0] == -(-(V + 300) // 128)
    np.testing.assert_array_equal(perm, np.asarray(want_perm))
    np.testing.assert_array_equal(sel, np.asarray(want_sel))
    with pytest.warns(UserWarning, match="W >"):
        perm, sel = artifact.face_band_tables(faces, vg, V, T=128, max_w=128)
    assert perm.shape == (0,) and sel.shape == (0, 0, 0)
    perm, sel = artifact.face_band_tables(np.zeros((0, 3), np.int64), vg, V)
    assert perm.shape == (0,) and sel.shape == (0, 0, 0)
    assert artifact.face_inverse_tables(np.zeros((0, 3), np.int64), V) == ()


def _face_fields_equal(art, ref):
    assert len(art.face_inv) == len(ref.face_inv) == 3
    for g, w in zip(art.face_inv, ref.face_inv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(art.face_perm.numpy(), np.asarray(ref.face_perm))
    np.testing.assert_array_equal(art.face_sel.numpy(), np.asarray(ref.face_sel))


@pytest.fixture(scope="module")
def packed():
    """The uv_sphere(770) pyramid packed by both packages: default (rcm,
    band), tree order, and rcm with BCSR levels."""
    faces = uv_sphere(V)[1]
    out = {}
    with fixed_eigsh_start():
        pyr = build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4)
        for name, kw in {"rcm": {}, "tree": {"ordering": "tree"},
                         "bcsr": {"sparse_kind": "bcsr"}}.items():
            out[name] = (jax_artifact.pack_pyramid(pyr, faces, dense_threshold=300, **kw),
                         artifact.pack_pyramid(pyr, faces, dense_threshold=300,
                                               device="cpu", **kw))
    return out


@pytest.mark.parametrize("kind", ["rcm", "tree", "bcsr"])
def test_packed_artifact_bit_equal(packed, kind):
    ref, art = packed[kind]
    assert_artifacts_equal(art, ref)
    _face_fields_equal(art, ref)
    kinds = [op.kind for op in art.mesh_ops]
    if kind == "rcm":
        assert kinds[:2] == ["band", "band"]
    else:
        assert kinds[:2] == ["bcsr", "bcsr"]
    if kind == "tree":
        # fake slots kept: the finest level holds the padded tree
        assert art.mesh_ops[0].num_vertices > V
        assert int(art.vertex_gather.max()) >= V
        assert art.face_sel.shape[0] * 128 >= int(art.vertex_gather.max()) + 1


def test_pack_options_refused():
    faces = uv_sphere(110)[1]
    pyr = build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=2)
    with pytest.raises(ValueError, match="ordering"):
        artifact.pack_pyramid(pyr, faces, ordering="bfs", device="cpu")
    with pytest.raises(ValueError, match="sparse_kind"):
        artifact.pack_pyramid(pyr, faces, sparse_kind="ell", device="cpu")


def test_artifact_to_keeps_face_sel_float32(packed):
    _, art = packed["rcm"]
    half = art.to("cpu", torch.bfloat16)
    assert half.face_sel.dtype == torch.float32
    assert half.face_perm.dtype == torch.int64
    assert all(t.dtype == torch.int64 for t in half.face_inv)
    assert half.mesh_ops[0].band_val.dtype == torch.bfloat16


def test_npz_face_fields_both_ways(packed, tmp_path):
    ref, art = packed["tree"]
    path = str(tmp_path / "jax.npz")
    jax_artifact.save_artifact(path, ref)
    _face_fields_equal(artifact.load_artifact(path, device="cpu"), ref)
    path = str(tmp_path / "port.npz")
    artifact.save_artifact(path, art)
    got = jax_artifact.load_artifact(path)
    _face_fields_equal(art, got)
    assert np.asarray(got.face_perm).dtype == np.int32
    assert np.asarray(got.face_sel).dtype == np.float32
    assert all(np.asarray(t).dtype == np.int32 for t in got.face_inv)


# ---- the face corners' backward -------------------------------------------

def _losses_both(sphere, mode):
    """(value, gradient) of normal + edge through `mode`'s corners, port
    and JAX."""
    faces, vg = sphere
    rng = np.random.default_rng(22)
    pred = rng.standard_normal((3, V, 3)).astype(np.float32)
    gt = rng.standard_normal((3, V, 3)).astype(np.float32)
    perm, sel = artifact.face_band_tables(faces, vg, V)
    inv = artifact.face_inverse_tables(faces, V)
    ft = torch.from_numpy(faces.astype(np.int64))
    fj = jnp.asarray(faces)
    t_kw = {"band": dict(face_band=(torch.from_numpy(perm), torch.from_numpy(sel),
                                    torch.from_numpy(vg))),
            "inv": dict(face_inv=tuple(torch.from_numpy(t) for t in inv)),
            "gather": {}}[mode]
    j_kw = {"band": dict(face_band=(jnp.asarray(perm.astype(np.int32)), jnp.asarray(sel),
                                    jnp.asarray(vg.astype(np.int32)))),
            "inv": dict(face_inv=tuple(jnp.asarray(t.astype(np.int32)) for t in inv)),
            "gather": {}}[mode]

    def port(p):
        c = tl._face_corners(p, ft, **t_kw)
        g = torch.from_numpy(gt)
        return (tl.normal_vector_loss(p, g, ft, corners=c)
                + tl.edge_length_loss(p, g, ft, corners=c)), c

    def ref(p):
        c = jl._face_corners(p, fj, **j_kw)
        g = jnp.asarray(gt)
        return (jl.normal_vector_loss(p, g, fj, corners=c)
                + jl.edge_length_loss(p, g, fj, corners=c))

    p = torch.from_numpy(pred).requires_grad_()
    value, corners = port(p)
    (grad,) = torch.autograd.grad(value, p)
    jv, jg = jax.value_and_grad(ref)(jnp.asarray(pred))
    return pred, faces, corners, (float(value.detach()), grad.numpy()), (float(jv), np.asarray(jg))


@pytest.mark.parametrize("mode", ["band", "inv", "gather"])
def test_face_corner_backward_matches_jax(sphere, mode):
    pred, faces, corners, (tv, tg), (jv, jg) = _losses_both(sphere, mode)
    for c in range(3):
        np.testing.assert_array_equal(corners[c].detach().numpy(), pred[:, faces[:, c]])
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)


def test_face_take3_band_forward_and_shape_check(sphere):
    faces, vg = sphere
    perm, sel = (torch.from_numpy(a) for a in artifact.face_band_tables(faces, vg, V))
    pred = torch.randn(2, V, 3, generator=torch.Generator().manual_seed(0))
    ft = torch.from_numpy(faces.astype(np.int64))
    out = tl.face_take3_band(pred, ft, perm, sel, torch.from_numpy(vg))
    assert out.shape == (2, faces.shape[0], 3, 3)
    torch.testing.assert_close(out, pred[:, ft], rtol=0, atol=0)
    # a vertex map of another mesh size refuses the backward
    p = pred.clone().requires_grad_()
    out = tl.face_take3_band(p, ft, perm, sel, torch.from_numpy(vg[:700]))
    with pytest.raises(ValueError, match="face_sel"):
        out.sum().backward()
