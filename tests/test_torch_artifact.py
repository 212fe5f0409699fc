"""PyTorch port: the packed pyramid equals the JAX package's (every level
form: dense, band, strip, ELL, BCSR), the npz artifact round-trips between
the two packages in both directions, spmm's strategies agree with the JAX
ones, and the port imports no JAX."""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

import jax.numpy as jnp

from pose2mesh_release_tpu.graphs import artifact as jax_artifact
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.graphs.build import build_pyramid as jax_build_pyramid
from pose2mesh_release_tpu.ops import spmm as jax_spmm
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.graphs import artifact
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.ops import spmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKEL = [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]


def grid_faces(w: int, h: int) -> np.ndarray:
    """Long thin triangulated strip (tests/test_models.py::_grid_faces): every
    band level is block-tridiagonal."""
    idx = lambda r, c: r * w + c
    faces = []
    for r in range(h - 1):
        for c in range(w - 1):
            faces.append((idx(r, c), idx(r, c + 1), idx(r + 1, c)))
            faces.append((idx(r, c + 1), idx(r + 1, c + 1), idx(r + 1, c)))
    return np.asarray(faces, np.int32)


@contextlib.contextmanager
def fixed_eigsh_start():
    """eigsh calls without a start vector get the port's fixed one.  The JAX
    packer leaves ARPACK its own start vector, which depends on earlier
    calls in the process, so its Fiedler ordering is reproducible only with
    this."""
    orig = scipy.sparse.linalg.eigsh

    def eigsh(A, *args, v0=None, **kw):
        if v0 is None:
            v0 = np.random.default_rng(0).uniform(-1.0, 1.0, A.shape[0])
        return orig(A, *args, v0=v0, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scipy.sparse.linalg, "eigsh", eigsh)
        yield


@pytest.fixture
def seeded_eigsh():
    with fixed_eigsh_start():
        yield


CASES = {
    # tests/test_models.py `art` fixture
    "uv_sphere770": (lambda: uv_sphere(770)[1], 300),
    # tests/test_models.py::test_flat_deploy_path_matches_3d
    "grid6x260": (lambda: grid_faces(6, 260), 100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_pyramid_bit_equal_to_jax(case, seeded_eigsh):
    make_faces, dense_threshold = CASES[case]
    faces = make_faces()
    pyr_j = jax_build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4)
    pyr_t = build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4)
    for a, b in zip(pyr_j.mesh_laplacians, pyr_t.mesh_laplacians):
        assert (a != b).nnz == 0
    ref = jax_pack_pyramid(pyr_j, faces, dense_threshold=dense_threshold)
    art = pack_pyramid(pyr_t, faces, dense_threshold=dense_threshold,
                       device="cpu")

    assert "band" in [op.kind for op in art.mesh_ops]
    for op, r in zip(art.mesh_ops + (art.joint_op,),
                     ref.mesh_ops + (ref.joint_op,)):
        assert (op.kind, op.num_vertices, op.band_k) == (r.kind, r.num_vertices,
                                                         r.band_k)
        if op.kind == "band":
            assert op.band_val.dtype == torch.float32
            np.testing.assert_array_equal(op.band_val.numpy(),
                                          np.asarray(r.band_val))
            assert op.padded_vertices == r.padded_vertices
        else:
            np.testing.assert_array_equal(op.dense.numpy(), np.asarray(r.dense))
    assert len(art.up_idx) == len(ref.up_idx)
    for u, r in zip(art.up_idx, ref.up_idx):
        np.testing.assert_array_equal(u.numpy(), np.asarray(r))
    np.testing.assert_array_equal(art.vertex_gather.numpy(),
                                  np.asarray(ref.vertex_gather))
    np.testing.assert_array_equal(art.faces.numpy(), np.asarray(ref.faces))


def test_artifact_to_casts_operators_only():
    faces = grid_faces(6, 260)
    art = pack_pyramid(build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4),
                       faces, dense_threshold=100, device="cpu")
    half = art.to("cpu", torch.bfloat16)
    band = [op for op in half.mesh_ops if op.kind == "band"]
    assert band and all(op.band_val.dtype == torch.bfloat16 for op in band)
    assert half.joint_op.dense.dtype == torch.bfloat16
    assert half.vertex_gather.dtype == torch.int64
    assert all(u.dtype == torch.int64 for u in half.up_idx)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pose2mesh_release_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "ops = {'hop', 'strip_cheby', 'window_cheby', 'fused_cheby', 'fused_cheby_train'}\n"
        "assert ops <= {n.rsplit('.', 1)[-1] for n in names}, names\n"
        "mods = {p.__name__ + '.' + m for m in ('body.model', 'body.loader',\n"
        "        'body.synthetic', 'body.smpl', 'body.mano', 'data.gt_synth')}\n"
        "assert mods <= set(names), names\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pose2mesh_release_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


OP_FIELDS = ("dense", "band_val", "blk_col", "blk_val", "ell_idx", "ell_w", "strip_val")
OP_META = ("kind", "num_vertices", "block_size", "band_k", "strip_h", "band_bw")


def assert_ops_equal(op, ref, strip_offsets=True):
    """Port LevelOperator == JAX LevelOperator, field for field."""
    for f in OP_META:
        assert getattr(op, f) == getattr(ref, f), f
    for f in OP_FIELDS:
        np.testing.assert_array_equal(getattr(op, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    if strip_offsets and ref.strip_h:
        Vp, W = op.strip_val.shape
        want = [jax_artifact.strip_offset(t, ref.strip_h, W, Vp)
                for t in range(Vp // ref.strip_h)]
        np.testing.assert_array_equal(op.strip_off.numpy(), want)


def assert_artifacts_equal(art, ref):
    for op, r in zip(art.mesh_ops + (art.joint_op,), ref.mesh_ops + (ref.joint_op,)):
        assert_ops_equal(op, r)
    assert len(art.up_idx) == len(ref.up_idx)
    for u, r in zip(art.up_idx, ref.up_idx):
        np.testing.assert_array_equal(u.numpy(), np.asarray(r))
    for f in ("vertex_gather", "faces"):
        np.testing.assert_array_equal(getattr(art, f).numpy(), np.asarray(getattr(ref, f)))
    assert (art.joint_num, art.num_vertices) == (ref.joint_num, ref.num_vertices)


@pytest.fixture(scope="module")
def sphere_pyramids():
    """uv_sphere(770) pyramid (two band levels) packed by both packages at
    strip_h 64."""
    faces = uv_sphere(770)[1]
    with fixed_eigsh_start():
        pyr = build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4)
        ref = jax_pack_pyramid(pyr, faces, dense_threshold=300, strip_h=64)
        art = pack_pyramid(pyr, faces, dense_threshold=300, strip_h=64, device="cpu")
    return pyr, ref, art


def test_level_forms_equal_to_jax(sphere_pyramids):
    """Dense, band, strip (values, width, offsets), ELL and the scalar
    bandwidth of every level, and BCSR at two tile sizes."""
    pyr, ref, art = sphere_pyramids
    assert [op.kind for op in art.mesh_ops][:2] == ["band", "band"]
    assert all(op.strip_h == 64 for op in art.mesh_ops if op.kind == "band")
    assert_artifacts_equal(art, ref)
    import scipy.sparse as sp
    L = sp.csr_matrix(pyr.mesh_laplacians[0])
    for T in (128, 64):
        assert_ops_equal(artifact._make_level_op(L, "bcsr", T),
                         jax_artifact._make_level_op(L, "bcsr", T))


def test_npz_from_jax_loads_into_the_port(sphere_pyramids, tmp_path):
    _, ref, art = sphere_pyramids
    path = str(tmp_path / "jax_art.npz")
    jax_artifact.save_artifact(path, ref)
    got = artifact.load_artifact(path, device="cpu")
    assert_artifacts_equal(got, ref)
    assert got.vertex_gather.dtype == torch.int64 and got.up_idx[0].dtype == torch.int64
    assert got.mesh_ops[0].strip_off.dtype == torch.int32


def test_npz_from_the_port_loads_into_jax(sphere_pyramids, tmp_path):
    _, ref, art = sphere_pyramids
    path = str(tmp_path / "port_art.npz")
    artifact.save_artifact(path, art)
    got = jax_artifact.load_artifact(path)
    assert_artifacts_equal(art, got)
    for op, r in zip(got.mesh_ops, ref.mesh_ops):
        for f in OP_FIELDS:
            assert np.asarray(getattr(op, f)).dtype == np.asarray(getattr(r, f)).dtype, f
    # the face tables too (tests/test_torch_face_tables.py holds their values)
    assert len(got.face_inv) == 3 and np.asarray(got.face_sel).size
    np.testing.assert_array_equal(np.asarray(got.face_perm), np.asarray(ref.face_perm))
    # and back into the port
    artifact.save_artifact(path, artifact.load_artifact(path, device="cpu"))
    assert_artifacts_equal(artifact.load_artifact(path, device="cpu"), ref)


@pytest.mark.parametrize("strategy", ["dense", "band", "bcsr", "ell"])
def test_spmm_strategies_match_jax(sphere_pyramids, strategy):
    """spmm(op, x, strategy=...) == the JAX spmm on the same level form."""
    import scipy.sparse as sp
    pyr, _, _ = sphere_pyramids
    L = sp.csr_matrix(pyr.mesh_laplacians[0])
    kind = "dense" if strategy in ("dense", "ell") else strategy
    op_j = jax_artifact._make_level_op(L, kind, 128)
    op_t = artifact._make_level_op(L, kind, 128)
    x = np.random.default_rng(4).standard_normal((L.shape[0], 2, 3)).astype(np.float32)
    want = jax_spmm.spmm(op_j, jnp.asarray(x), strategy=strategy)
    got = spmm.spmm(op_t, torch.from_numpy(x), strategy=strategy)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        spmm.spmm(op_t, torch.from_numpy(x), strategy="csr")
