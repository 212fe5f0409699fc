"""PyTorch port: the reference-architecture model `parity/torch_ref.py` (CPU).

The port's copy against the JAX package's on one state dict (bit for bit);
the port's cascade against `RefCascade` / `RefPoseNet` as
tests/test_parity.py holds the JAX cascade (tree ordering through the dense
path, the banded RCM packing through the band convs' plain versions; rtol
1e-3, atol 1e-4), each from a reference-layout `.pth.tar` (DataParallel
`module.` prefixes, the unused top-level PoseNet `batch_norm1`) through
`load_checkpoint`; then such a checkpoint through `cli.test` on the CPU
against RefCascade's own evaluation.
"""
import json

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.parity import torch_ref as jax_torch_ref
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.core import engine
from pose2mesh_release_tpu_torch.core.checkpoint import load_checkpoint
from pose2mesh_release_tpu_torch.core.train import make_eval_step
from pose2mesh_release_tpu_torch.data.joint_sets import MANO_SET
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.fold import fold_bn_variables
from pose2mesh_release_tpu_torch.models.meshnet import MANO_BLOCKS
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.models.posenet import PoseNet
from pose2mesh_release_tpu_torch.parity import torch_ref

import chip_smoke
from torch_mesh_helpers import TinyDataset

J = 7
SKEL = ((0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6))
BLOCKS = ((5, 8, 8), (8, 16), (16, 16), (16, 16), (16, 8, 3))


@pytest.fixture(scope="module")
def pyramid():
    _, faces = uv_sphere(770)
    return build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=4), faces


def _laplacians(pyr):
    return list(pyr.mesh_laplacians) + [pyr.joint_laplacian]


def _save_reference(path, ref):
    """The reference's checkpoint layout: DataParallel prefixes."""
    torch.save({"epoch": 3, "model_state_dict": {f"module.{k}": v for k, v in
                                                 ref.state_dict().items()}}, path)


def test_torch_ref_equals_the_jax_package_copy(pyramid):
    """The port's RefCascade and the JAX package's on one state dict: the
    same keys, the same outputs bit for bit."""
    pyr, _ = pyramid
    torch.manual_seed(0)
    ref = torch_ref.RefCascade(J, BLOCKS, _laplacians(pyr), hidden=32)
    chip_smoke._randomize_batch_norms(ref, torch.Generator().manual_seed(1))
    theirs = jax_torch_ref.RefCascade(J, BLOCKS, _laplacians(pyr), hidden=32)
    assert list(ref.state_dict()) == list(theirs.state_dict())
    theirs.load_state_dict(ref.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, J, 2)).astype(np.float32))
    for train in (False, True):
        ref.train(train)
        theirs.train(train)
        torch.manual_seed(5)
        got = ref(x)
        torch.manual_seed(5)
        want = theirs(x)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_posenet_matches_ref_posenet(tmp_path):
    """The port's PoseNet from a RefPoseNet .pth.tar == RefPoseNet at eval."""
    torch.manual_seed(0)
    ref = torch_ref.RefPoseNet(J, hidden=32)
    chip_smoke._randomize_batch_norms(ref, torch.Generator().manual_seed(2))
    ref.eval()
    path = str(tmp_path / "posenet.pth.tar")
    _save_reference(path, ref)
    payload = load_checkpoint(path, device="cpu")
    assert payload["family"] == "posenet"
    model = PoseNet(J, hidden=32)
    model.load_state_dict(payload["model_state_dict"])
    x = np.random.default_rng(0).standard_normal((4, J * 2)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   ref(torch.from_numpy(x)).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ordering, dense_threshold, deploy", [
    ("tree", 10_000, False), ("rcm", 300, False), ("rcm", 300, True)])
def test_cascade_matches_ref_cascade(pyramid, tmp_path, ordering, dense_threshold, deploy):
    """The port's cascade from a RefCascade .pth.tar == RefCascade (tests/
    test_parity.py's cases: tree ordering, all levels dense; the banded RCM
    packing, its band levels through the plain versions, in the training
    form and the deploy form with BatchNorm folded at load)."""
    pyr, faces = pyramid
    torch.manual_seed(2)
    ref = torch_ref.RefCascade(J, BLOCKS, _laplacians(pyr), hidden=32)
    chip_smoke._randomize_batch_norms(ref, torch.Generator().manual_seed(3))
    ref.eval()
    path = str(tmp_path / "final.pth.tar")
    _save_reference(path, ref)
    sd = load_checkpoint(path, device="cpu")["model_state_dict"]
    assert not any("batch_norm1" in k and "linear_stages" not in k for k in sd)
    art = pack_pyramid(pyr, faces, ordering=ordering, dense_threshold=dense_threshold,
                       device="cpu")
    if ordering == "rcm":
        assert "band" in [op.kind for op in art.mesh_ops]
    model = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=32, blocks=BLOCKS,
                      inference_fused=deploy, device="cpu")
    model.load_state_dict(fold_bn_variables(sd) if deploy else sd)
    x = np.random.default_rng(1).standard_normal((2, J, 2)).astype(np.float32)
    jreg = np.eye(J, 770, dtype=np.float32)
    mesh_mm, _, pose3d = make_eval_step(model, jreg, device="cpu")(art, torch.from_numpy(x))
    with torch.no_grad():
        t_mesh, t_pose = ref(torch.from_numpy(x))
    np.testing.assert_allclose(pose3d.numpy(), t_pose.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(mesh_mm.numpy() / 1000.0, t_mesh.numpy()[:, pyr.vertex_slot],
                               rtol=1e-3, atol=1e-4)


def test_reference_checkpoint_through_cli_test(tmp_path, monkeypatch):
    """A reference-layout .pth.tar of a MANO RefCascade (MANO_BLOCKS,
    PoseNet 32) through cli.test --device cpu (the deploy Tester) on a
    MANO-graph dataset == the same evaluation of RefCascade (rtol 1e-3)."""
    mano = MANO()
    pyr = build_pyramid(mano.face, joint_num=21, skeleton=MANO_SET.skeleton,
                        flip_pairs=MANO_SET.flip_pairs, levels=6,
                        extra_joint_edges=MANO_SET.extra_edges)
    art = pack_pyramid(pyr, mano.face, dense_threshold=300, device="cpu")
    assert [op.kind for op in art.mesh_ops][:2] == ["band", "band"]
    torch.manual_seed(4)
    ref = torch_ref.RefCascade(21, MANO_BLOCKS, _laplacians(pyr), hidden=32)
    chip_smoke._randomize_batch_norms(ref, torch.Generator().manual_seed(5))
    ref.eval()
    ckpt = str(tmp_path / "final.pth.tar")
    _save_reference(ckpt, ref)
    ds = TinyDataset(6, art, mano.face, joint_num=21, seed=2)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump({"DATASET": {"input_joint_set": "mano", "workers": 1},
                   "TEST": {"batch_size": 4}, "TPU": {"compute_dtype": "f32"},
                   "MODEL": {"posenet_hidden": 32}, "output_dir": str(tmp_path / "out")}, f)
    monkeypatch.setattr(engine, "build_datasets", lambda *a, **k: [ds])
    monkeypatch.setattr(engine, "_mesh_model_for", lambda *a: ds.mesh_model)
    from pose2mesh_release_tpu_torch.cli import test as cli_test
    got = cli_test.main(["--cfg", cfg_path, "--weights", ckpt, "--device", "cpu"])
    want = _ref_evaluation(ref, pyr, ds, batch=4)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def _ref_evaluation(ref, pyr, ds, batch):
    """Tester.test's metrics of RefCascade on `ds` (every batch, the tail
    unpadded: the forward is per row at eval)."""
    j_errs, v_errs, meshes, targets = [], [], [], []
    for s in range(0, len(ds), batch):
        rows = [ds[i] for i in range(s, min(s + batch, len(ds)))]
        pose2d = torch.from_numpy(np.stack([r[0]["pose2d"] for r in rows]))
        with torch.no_grad():
            mesh, _ = ref(pose2d)
        mesh_mm = mesh.numpy()[:, pyr.vertex_slot] * 1000.0
        reg = np.einsum("jv,bvc->bjc", ds.target_regressor(), mesh_mm)
        gt_mesh = np.stack([r[1]["mesh"] for r in rows]) * 1000.0
        gt_reg = np.stack([r[1]["reg_pose3d"] for r in rows])
        j, v = ds.compute_both_err(mesh_mm, gt_mesh, reg, gt_reg)
        j_errs.append(j)
        v_errs.append(v)
        meshes.append(mesh_mm)
        targets.append(gt_mesh)
    out = {"joint_err": float(np.mean(j_errs)), "mesh_err": float(np.mean(v_errs))}
    out.update(ds.evaluate({"mesh_coord": np.concatenate(meshes),
                            "mesh_coord_target": np.concatenate(targets)}))
    return out
