"""PyTorch port: the packed pyramid equals the JAX package's, and the port
imports no JAX."""
import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.graphs.build import build_pyramid as jax_build_pyramid
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid

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
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'pose2mesh_release_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
