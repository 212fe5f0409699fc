"""PyTorch port: the batch pipeline, `get_batch`, the loader, the mixer and
the datasets' graph against the JAX package (CPU).

  * `batch_pipeline` (torch ops, CPU) against the JAX `batch_pipeline` on
    both of its routes (the host C++ of `native/`, skipped without g++,
    and numpy), augmented (is_train) or not, from the same Generator seed:
    relative L2 <= 1e-6 per output, the draws identical;
  * `get_batch` against the JAX `get_batch` from the same seed, and (eval,
    no draws) against the port's own stacked `__getitem__`;
  * `mesh_dtype=torch.float16` within 1 mm of float32;
  * `BatchLoader` with num_workers=1 against the JAX loader, on the
    `get_batch` path (one dataset) and the per-sample path (a mix), with
    host sharding; a failing producer raises in the consumer;
  * `MultipleDatasets` index semantics and `stack_samples`;
  * `pyramid_for`: its default dense_threshold 1024, its cache, its level
    kinds at SMPL and MANO width;
  * the entry points raise without CUDA unless device="cpu" is given.
"""
import inspect
import threading

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu import native as jax_native
from pose2mesh_release_tpu.data import pipeline as jax_pipeline
from pose2mesh_release_tpu.data.loader import BatchLoader as JaxBatchLoader
from pose2mesh_release_tpu.data.loader import stack_samples as jax_stack_samples
from pose2mesh_release_tpu.data.mixer import MultipleDatasets as JaxMultipleDatasets
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data import base, pipeline
from pose2mesh_release_tpu_torch.data.joint_sets import COCO, HUMAN36, MANO_SET
from pose2mesh_release_tpu_torch.data.loader import BatchLoader, stack_samples
from pose2mesh_release_tpu_torch.data.mixer import MultipleDatasets

from test_torch_datasets import (  # noqa: F401
    body_models, built, rel_l2, roots,
)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _pipeline_inputs(seed=0, B=8):
    rng = np.random.default_rng(seed)
    joint_img = (rng.standard_normal((B, 19, 2)) * 80 + 300).astype(np.float32)
    joint_cam = (rng.standard_normal((B, 19, 3)) * 300).astype(np.float32)
    mesh = (rng.standard_normal((B, 500, 3)) * 400).astype(np.float32)
    reg3d = (rng.standard_normal((B, 17, 3)) * 300).astype(np.float32)
    return joint_img, joint_cam, mesh, reg3d


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_batch_pipeline_matches_jax(route, is_train, monkeypatch):
    if route == "native" and not jax_native.available():
        pytest.skip("no g++ toolchain for the JAX package's native route")
    if route == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
    joint_img, joint_cam, mesh, reg3d = _pipeline_inputs()
    kw = dict(is_train=is_train, mesh_cam=mesh, reg3d=reg3d,
              target_flip_pairs=HUMAN36.flip_pairs)
    want = jax_pipeline.batch_pipeline(joint_img, joint_cam, (384, 288), COCO.flip_pairs,
                                       rng=np.random.default_rng(3), **kw)
    rng = np.random.default_rng(3)
    got = pipeline.batch_pipeline(joint_img, joint_cam, (384, 288), COCO.flip_pairs,
                                  rng=rng, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape, k
        assert rel_l2(_np(got[k]), want[k]) <= 1e-6, (k, rel_l2(_np(got[k]), want[k]))
    # the same draws: both Generators end in the same state
    ref = np.random.default_rng(3)
    pipeline.draw_augmentation(8, ref, is_train=is_train)
    assert rng.bit_generator.state == ref.bit_generator.state
    if is_train:  # the seed's draws flip some samples and rotate some
        flip, rot = pipeline.draw_augmentation(8, np.random.default_rng(3), is_train=True)
        assert 0 < flip.sum() < 8 and 0 < (rot != 0).sum() < 8


def test_pipeline_ops_match_per_sample_augment():
    """flip_2d / rot_flip_3d on a batch == utils.augment per sample."""
    from pose2mesh_release_tpu_torch.utils import augment
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((6, 17, 3)) * 100).astype(np.float32)
    rot = rng.uniform(-60, 60, 6)
    flip = np.array([1, 0, 1, 1, 0, 0], bool)
    got = pipeline.rot_flip_3d(torch.from_numpy(pts), torch.from_numpy(rot),
                               torch.from_numpy(flip), HUMAN36.flip_pairs)
    p2d = pipeline.flip_2d(torch.from_numpy(pts[..., :2].copy()), torch.from_numpy(flip),
                           288, HUMAN36.flip_pairs)
    for b in range(6):
        want = augment.j3d_processing(pts[b], float(rot[b]), int(flip[b]), HUMAN36.flip_pairs)
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-6, atol=1e-4)
        want2 = (augment.flip_2d_joint(pts[b, :, :2], 288, HUMAN36.flip_pairs)
                 if flip[b] else pts[b, :, :2])
        np.testing.assert_array_equal(p2d[b].numpy(), want2)


def _batch_dict(batch):
    inputs, targets, meta = batch
    return {**inputs, **targets, **meta}


def _assert_batches_close(got, want, tol=1e-5):
    got, want = _batch_dict(got), _batch_dict(want)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _np(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert rel_l2(g, w) <= tol, (k, rel_l2(g, w))


@pytest.mark.parametrize("case", ["h36m_train_human36", "h36m_train_coco", "h36m_test"])
def test_get_batch_matches_jax(case, built):
    jds, tds = built(case)
    assert tds.supports_batch() and jds.supports_batch()
    idx = list(range(len(jds)))[::-1]
    jds.rng, tds.rng = np.random.default_rng(9), np.random.default_rng(9)
    got = tds.get_batch(idx)
    want = jds.get_batch(idx)
    _assert_batches_close(got, want)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in _batch_dict(got).values())


def test_get_batch_matches_stacked_getitem(built):
    """Eval (no draws): the fused batch == the stacked per-sample path."""
    _, tds = built("h36m_test")
    idx = list(range(len(tds)))
    batch = tds.get_batch(idx)
    stacked = stack_samples([tds[i] for i in idx])
    _assert_batches_close(batch, stacked, tol=1e-6)


def test_get_batch_float16_mesh_within_1mm(roots, body_models):
    """mesh_dtype=torch.float16: the mesh is rounded in meters before the
    rotation (float32) and reaches the batch as float32, within 1 mm of the
    float32 path; every other tensor is the same."""
    from pose2mesh_release_tpu_torch.data.human36m import Human36M
    _, smpl = body_models["smpl"]
    out = []
    for dtype in (torch.float32, torch.float16):
        ds = Human36M("train", data_dir=str(roots["Human36M"]), mesh_model=smpl, debug=True,
                      build_graph=False, input_joint_name="human36", device="cpu",
                      mesh_dtype=dtype, seed=4)
        out.append(_batch_dict(ds.get_batch(list(range(len(ds))))))
    f32, f16 = out
    assert f16["mesh"].dtype == torch.float32
    err = float((f16["mesh"] - f32["mesh"]).abs().max())
    assert 0.0 < err <= 1e-3, err
    for k in f32:
        if k != "mesh":
            assert torch.equal(f16[k], f32[k]), k
    with pytest.raises(ValueError, match="mesh_dtype"):
        Human36M("train", data_dir=str(roots["Human36M"]), mesh_model=smpl, debug=True,
                 build_graph=False, device="cpu", mesh_dtype=torch.bfloat16)


def _mix(built, which):
    cases = ("h36m_train_coco", "coco_train", "muco_train")
    dbs = [built(c)[which] for c in cases]
    return dbs


@pytest.mark.parametrize("path", ["get_batch", "per_sample"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_matches_jax(path, shuffle, built):
    """num_workers=1 (the datasets' Generator is shared by the loader's
    threads, so only one worker is reproducible): every batch of two epochs
    equals the JAX loader's."""
    if path == "get_batch":
        jds, tds = built("h36m_train_human36")
        assert tds.supports_batch()
    else:
        jds = JaxMultipleDatasets(_mix(built, 0), make_same_len=True, seed=2)
        tds = MultipleDatasets(_mix(built, 1), make_same_len=True, seed=2)
        assert not hasattr(tds, "supports_batch")
    for ds in (jds.dbs if path == "per_sample" else [jds]) + \
            (tds.dbs if path == "per_sample" else [tds]):
        ds.rng = np.random.default_rng(6)
    kw = dict(shuffle=shuffle, drop_last=True, num_workers=1, seed=5)
    jl, tl = JaxBatchLoader(jds, 2, **kw), BatchLoader(tds, 2, device="cpu", **kw)
    # len() draws a shuffle of its own in both packages: call it alike
    n = len(tl)
    assert n == len(jl) > 1
    for epoch in range(2):
        np.random.seed(epoch)
        want = list(jl)
        np.random.seed(epoch)
        got = list(tl)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            _assert_batches_close(g, w)


def test_loader_host_sharding_matches_jax(built):
    _, tds = built("h36m_train_human36")
    shards = []
    for host in range(2):
        t = BatchLoader(tds, 1, shuffle=True, host_id=host, host_count=2, seed=3,
                        device="cpu")
        j = JaxBatchLoader(tds, 1, shuffle=True, host_id=host, host_count=2, seed=3)
        i_t, i_j = t._epoch_indices(), j._epoch_indices()
        np.testing.assert_array_equal(i_t, i_j)
        shards.append(i_t)
    assert len(set(shards[0]) & set(shards[1])) == 0
    assert len(shards[0]) == len(shards[1]) == len(tds) // 2


class _Tagged:
    """A dataset of n samples, each its (tag, index) as arrays."""

    def __init__(self, n, tag, fail_at=None):
        self.n, self.tag, self.fail_at = n, tag, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"sample {i}")
        return {"tag": np.array([self.tag]), "index": np.array([i])}


def test_loader_failure_raises_in_consumer():
    loader = BatchLoader(_Tagged(8, 0, fail_at=5), 2, num_workers=2, device="cpu")
    seen = []
    with pytest.raises(RuntimeError, match="producer") as info:
        for batch in loader:
            seen.append(batch)
    assert isinstance(info.value.__cause__, KeyError)
    assert len(seen) == 2


def test_loader_stress_many_threads():
    """More threads than cores, a short switch interval: every epoch yields
    every index once, in order, in whole batches (time-bounded)."""
    import sys
    import time
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        loader = BatchLoader(_Tagged(203, 0), 4, num_workers=32, prefetch=1, device="cpu")
        for _ in range(3):
            got = [b["index"][:, 0] for b in loader]
            assert len(got) == len(loader) == 51
            np.testing.assert_array_equal(torch.cat(got).numpy(), np.arange(203))
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(interval)


def test_loader_stops_its_thread_on_early_exit():
    before = threading.active_count()
    loader = BatchLoader(_Tagged(40, 0), 2, num_workers=3, prefetch=1, device="cpu")
    for i, batch in enumerate(loader):
        assert torch.is_tensor(batch["index"]) and batch["index"].shape == (2, 1)
        if i == 1:
            break
    del batch
    assert threading.active_count() == before


@pytest.mark.parametrize("lens,same_len", [((4, 10), True), ((5, 10, 3), True),
                                           ((4, 10), False), ((7, 2, 7), False)])
def test_mixer_index_semantics_match_jax(lens, same_len):
    got = MultipleDatasets([_Tagged(n, t) for t, n in enumerate(lens)],
                           make_same_len=same_len, seed=1)
    want = JaxMultipleDatasets([_Tagged(n, t) for t, n in enumerate(lens)],
                               make_same_len=same_len, seed=1)
    assert len(got) == len(want) == (max(lens) * len(lens) if same_len else sum(lens))
    seq = [(int(s["tag"][0]), int(s["index"][0])) for s in (got[i] for i in range(len(got)))]
    assert seq == [(int(s["tag"][0]), int(s["index"][0]))
                   for s in (want[i] for i in range(len(want)))]
    tags = [t for t, _ in seq]
    if same_len:  # every dataset max(len) times
        assert all(tags.count(t) == max(lens) for t in range(len(lens)))


def test_stack_samples_matches_jax():
    rng = np.random.default_rng(2)
    samples = [({"a": rng.random((3, 2))}, {"b": rng.random(4)}, [rng.random(1)])
               for _ in range(5)]
    got, want = stack_samples(samples), jax_stack_samples(samples)
    np.testing.assert_array_equal(got[0]["a"], want[0]["a"])
    np.testing.assert_array_equal(got[1]["b"], want[1]["b"])
    np.testing.assert_array_equal(got[2][0], want[2][0])


def test_pyramid_for_default_and_cache():
    assert inspect.signature(base.pyramid_for).parameters["dense_threshold"].default == 1024
    base.clear_pyramid_cache()
    mano = MANO()
    art = base.pyramid_for(mano.face, MANO_SET, 6)
    assert base.pyramid_for(mano.face, MANO_SET, 6) is art
    assert base.pyramid_for(mano.face, MANO_SET, 6, dense_threshold=768) is not art
    assert art.vertex_gather.device.type == "cpu"
    # MANO at 1024: every level dense, so the hand runs no band kernel
    assert [(op.kind, op.num_vertices) for op in art.mesh_ops] == [
        ("dense", 778), ("dense", 395), ("dense", 208), ("dense", 108), ("dense", 76)]
    base.clear_pyramid_cache()


def test_pyramid_for_smpl_levels():
    """SMPL, COCO 19-joint set, 9 levels at 1024: 6890 / 3475 / 1849 band,
    981 and below dense."""
    base.clear_pyramid_cache()
    art = base.pyramid_for(SMPL().face, COCO, 9)
    kinds = [(op.kind, op.num_vertices) for op in art.mesh_ops]
    assert kinds[:5] == [("band", 6890), ("band", 3475), ("band", 1849), ("dense", 981),
                         ("dense", 520)]
    assert all(k == "dense" for k, _ in kinds[3:]) and len(kinds) == 8
    assert art.joint_num == 19
    base.clear_pyramid_cache()


@pytest.mark.parametrize("entry", ["dataset", "loader", "get_batch", "batch_pipeline"])
def test_data_entry_points_need_cuda_unless_cpu_is_asked(entry, roots, body_models, built):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from pose2mesh_release_tpu_torch.data.coco import COCO as CocoDS
    _, smpl = body_models["smpl"]
    _, tds = built("h36m_train_human36")
    joint_img, joint_cam, _, _ = _pipeline_inputs(B=2)
    calls = {
        "dataset": lambda **kw: CocoDS("train", data_dir=str(roots["COCO"]), mesh_model=smpl,
                                       build_graph=False, **kw),
        "loader": lambda **kw: BatchLoader(tds, 2, **kw),
        "get_batch": lambda **kw: tds.get_batch([0, 1], **kw),
        "batch_pipeline": lambda **kw: pipeline.batch_pipeline(
            joint_img, joint_cam, (384, 288), COCO.flip_pairs, is_train=False, **kw),
    }
    if entry != "get_batch":  # get_batch defaults to its dataset's device
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry](device="cuda")
    assert calls[entry](device="cpu") is not None
