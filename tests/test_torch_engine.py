"""PyTorch port: the engine, checkpoints and the train / test CLIs against the
JAX package (CPU).

On the tiny sphere setup of tests/test_engine.py (770 vertices, 4 levels:
two band levels and a dense one, TEST_BLOCKS, PoseNet hidden 32, 7 joints):
`Trainer.train_epoch` against the JAX `Trainer` from the same weights
(float32, SGD, dropout off on both sides: the JAX side with
`flax.linen.Dropout` replaced by the identity, the port's cascade built
with dropout 0), `fit` and its files, resume, `steps_per_dispatch`; on the
MANO graph (778 vertices, 6 levels, the first two banded at dense_threshold
300, MANO_BLOCKS) the deploy `Tester` on a reference-schema `.pth.tar`
against the JAX one; `LiftTrainer` / `LiftTester` against the JAX ones; the
refusals; the CLIs' flags.
"""
import json
import os.path as osp

import flax.linen
import jax
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.synthetic import uv_sphere
from pose2mesh_release_tpu.config import default_config as jax_default_config
from pose2mesh_release_tpu.core import engine as jax_engine
from pose2mesh_release_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh as JaxPose2Mesh
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.config import default_config
from pose2mesh_release_tpu_torch.core import engine
from pose2mesh_release_tpu_torch.core import train as core_train
from pose2mesh_release_tpu_torch.core.checkpoint import load_checkpoint, model_family
from pose2mesh_release_tpu_torch.data.joint_sets import MANO_SET
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.parity.from_jax import posenet_state_dict, state_dict_from_flax

from pose2mesh_release_tpu_torch.parallel.mesh import Mesh

from test_torch_models import to_numpy
from test_torch_train import _NoDropout
from torch_mesh_helpers import J, TEST_BLOCKS, LiftDataset, TinyDataset, engine_cfg

V = 770
SKEL = ((0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6))


@pytest.fixture(scope="module")
def tiny():
    _, faces = uv_sphere(V)
    pyr = build_pyramid(faces, joint_num=J, skeleton=SKEL, levels=4)
    art_t = pack_pyramid(pyr, faces, dense_threshold=300, device="cpu")
    assert [op.kind for op in art_t.mesh_ops] == ["band", "band", "dense"]
    return jax_pack_pyramid(pyr, faces, dense_threshold=300), art_t, faces


def _cfg(tmpdir, make=default_config):
    return engine_cfg(make, tmpdir)


def _port_cascade(art_t, seed=0, dropout=0.0):
    return Pose2Mesh(J, art_t.mesh_ops[-1].num_vertices, posenet_hidden=32,
                     blocks=TEST_BLOCKS, inference_fused=False, dropout=dropout,
                     device="cpu", generator=torch.Generator().manual_seed(seed))


def _jax_state_dict(state):
    return state_dict_from_flax(to_numpy({"params": state.params,
                                          "batch_stats": state.batch_stats}))


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=err_msg, **tol)


def test_trainer_epoch_matches_jax(tiny, tmp_path, monkeypatch):
    """One epoch (8 samples, batch 4: two steps, edge loss on, SGD lr 2e-2)
    of the port's Trainer == the JAX Trainer's from the same weights: the
    epoch's mean loss, every parameter and running statistic after it,
    then the in-epoch eval of both."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    art_j, art_t, faces = tiny
    cfgs = {}
    for side, make in (("jax", jax_default_config), ("port", default_config)):
        cfgs[side] = cfg = _cfg(tmp_path / side, make)
        cfg.TRAIN.optimizer = "sgd"
        cfg.TRAIN.lr = 2e-2
        cfg.TRAIN.shuffle = False
    jtr = jax_engine.Trainer(
        cfgs["jax"], datasets=[TinyDataset(8, art_j, faces)],
        test_dataset=TinyDataset(6, art_j, faces, seed=1),
        model=JaxPose2Mesh(num_joint=J, posenet_hidden=32, blocks=TEST_BLOCKS,
                           use_pallas=False))
    port = _port_cascade(art_t)
    port.load_state_dict(_jax_state_dict(jax.device_get(jtr.state)))
    tr = engine.Trainer(cfgs["port"], datasets=[TinyDataset(8, art_t, faces)],
                        test_dataset=TinyDataset(6, art_t, faces, seed=1), model=port,
                        device="cpu")
    _close(tr.train_epoch(1), jtr.train_epoch(1), rtol=1e-4, err_msg="epoch mean loss")
    want = _jax_state_dict(jax.device_get(jtr.state))
    got = port.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    ev_t = tr.tester.test(1, art=tr.art_dev, full_eval=True)
    ev_j = jtr.tester.test(1, state=jtr.state, art=jtr.art_dev, full_eval=True)
    for k in ("joint_err", "mesh_err", "mpvpe"):
        _close(ev_t[k], ev_j[k], rtol=1e-4, err_msg=k)


def test_fit_writes_checkpoints_logs_and_plots(tiny, tmp_path):
    """Trainer.fit for 2 epochs: checkpoint{1,2}, best, final (the
    reference's payload), metrics.jsonl (a line per epoch with its seconds)
    and the loss and error plots (one-page PDFs)."""
    _, art_t, faces = tiny
    cfg = _cfg(tmp_path)
    tr = engine.Trainer(cfg, datasets=[TinyDataset(8, art_t, faces)],
                        test_dataset=TinyDataset(6, art_t, faces, seed=1),
                        model=_port_cascade(art_t, dropout=0.5), device="cpu")
    result = tr.fit()
    assert np.isfinite(result["joint_err"]) and np.isfinite(result["mpvpe"])
    ck = cfg.checkpoint_dir
    for name in ("checkpoint1", "checkpoint2", "best", "final"):
        assert osp.exists(osp.join(ck, f"{name}.pth.tar")), name
    payload = torch.load(osp.join(ck, "final.pth.tar"), weights_only=True)
    assert sorted(payload) == ["epoch", "model_state_dict", "optim_state_dict", "step",
                               "test_log", "train_log"]
    assert payload["epoch"] == 2 and payload["step"] == 4
    assert payload["train_log"] == tr.train_log and len(tr.train_log) == 2
    lines = [json.loads(l) for l in open(osp.join(cfg.output_dir, "metrics.jsonl"))]
    assert [l["epoch"] for l in lines] == [1, 2]
    assert all(l["train_s"] > 0 and l["epoch_s"] >= l["train_s"] for l in lines)
    for title in ("train_loss", "test_joint_err"):
        blob = open(osp.join(cfg.graph_dir, f"{title}.pdf"), "rb").read()
        assert_pdf_well_formed(blob)


def assert_pdf_well_formed(blob: bytes):
    """Header, trailer, and every xref offset at its `N 0 obj`."""
    assert blob.startswith(b"%PDF-1.4\n") and blob.endswith(b"%%EOF\n")
    xref = int(blob.rsplit(b"startxref\n", 1)[1].split(b"\n")[0])
    lines = blob[xref:].split(b"\n")
    assert lines[0] == b"xref"
    count = int(lines[1].split()[1])
    for i in range(1, count):
        off = int(lines[2 + i][:10])
        assert blob[off:].startswith(b"%d 0 obj" % i), i


def test_resume_equals_uninterrupted(tiny, tmp_path):
    """RMSprop, dropout 0.5: 2 epochs, then a resumed Trainer (another
    model's weights, replaced by the checkpoint's) for a third == 3 epochs
    in one run, exactly: parameters, running statistics, optimizer state,
    logs."""
    _, art_t, faces = tiny

    def trainer(out, end_epoch, resume=False, seed=0):
        cfg = _cfg(tmp_path / out)
        cfg.TRAIN.end_epoch = end_epoch
        cfg.TRAIN.shuffle = False
        return engine.Trainer(cfg, resume=resume, datasets=[TinyDataset(8, art_t, faces)],
                              test_dataset=TinyDataset(6, art_t, faces, seed=1),
                              model=_port_cascade(art_t, seed=seed, dropout=0.5),
                              device="cpu")

    trainer("split", 2).fit()
    resumed = trainer("split", 3, resume=True, seed=5)
    assert resumed.begin_epoch == 3 and resumed.state.step == 4
    saved = torch.load(osp.join(tmp_path, "split", "checkpoint", "checkpoint2.pth.tar"),
                       weights_only=True)
    for k, v in saved["model_state_dict"].items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    resumed.fit()
    whole = trainer("whole", 3)
    whole.fit()
    assert resumed.train_log == whole.train_log
    assert resumed.test_log == whole.test_log
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    got, want = resumed.optimizer.state_dict(), whole.optimizer.state_dict()
    for i, s in want["state"].items():
        for name, v in s.items():
            assert torch.equal(got["state"][i][name], v), (i, name)


def test_steps_per_dispatch_matches_single_steps(tiny, tmp_path):
    """cfg.TPU.steps_per_dispatch 2 (two stacked batches per call, and the
    one-batch tail) == one step per batch (the JAX test's case: 12 samples,
    batch 4)."""
    _, art_t, faces = tiny
    results = {}
    for k in (1, 2):
        cfg = _cfg(tmp_path / f"k{k}")
        cfg.TRAIN.shuffle = False
        cfg.TPU.steps_per_dispatch = k
        tr = engine.Trainer(cfg, datasets=[TinyDataset(12, art_t, faces)],
                            test_dataset=TinyDataset(4, art_t, faces, seed=1),
                            model=_port_cascade(art_t, dropout=0.5), device="cpu")
        assert (tr._multi_step is not None) == (k == 2)
        results[k] = (tr.train_epoch(1), tr.model.state_dict(), tr.state.step)
    assert results[1][0] == results[2][0] and results[1][2] == results[2][2] == 3
    for name, v in results[1][1].items():
        assert torch.equal(results[2][1][name], v), name


@pytest.fixture(scope="module")
def mano_graph():
    mano = MANO()
    pyr = build_pyramid(mano.face, joint_num=21, skeleton=MANO_SET.skeleton,
                        flip_pairs=MANO_SET.flip_pairs, levels=6,
                        extra_joint_edges=MANO_SET.extra_edges)
    art_t = pack_pyramid(pyr, mano.face, dense_threshold=300, device="cpu")
    assert [op.kind for op in art_t.mesh_ops][:2] == ["band", "band"]
    return jax_pack_pyramid(pyr, mano.face, dense_threshold=300), art_t, mano.face


def _reference_checkpoint(path, art_t):
    """A reference-schema .pth.tar (DataParallel `module.` prefixes, the
    reference's payload keys) of a MANO cascade, PoseNet hidden 32, with
    random BatchNorm affine and running statistics."""
    model = Pose2Mesh(21, art_t.mesh_ops[-1].num_vertices, mano=True, posenet_hidden=32,
                      inference_fused=False, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    sd = model.state_dict()
    for k, v in sd.items():
        if (".bn." not in k and "batch_norm" not in k) or k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("weight", "running_var")):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        else:  # bias, running_mean
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    torch.save({"epoch": 7, "model_state_dict": {f"module.{k}": v for k, v in sd.items()},
                "optim_state_dict": {}, "train_log": [3.0, 2.0],
                "test_log": [90.0, 80.0]}, path)
    return sd


def test_deploy_tester_on_reference_checkpoint_matches_jax(mano_graph, tmp_path):
    """The JAX Tester and the port's deploy Tester (BatchNorm folded, the
    band levels through the group convs' plain versions) on one
    reference-schema checkpoint: the same joint_err / mesh_err / evaluate()
    at rtol 1e-4 in float32 (6 samples at batch 4: the tail padded)."""
    art_j, art_t, faces = mano_graph
    path = str(tmp_path / "ref.pth.tar")
    sd = _reference_checkpoint(path, art_t)
    payload = load_checkpoint(path, device="cpu")
    assert payload["family"] == "cascade" and payload["epoch"] == 7
    assert payload["test_log"] == {"joint": [90.0, 80.0]}
    for k, v in sd.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    out = {}
    for side, make, art, tester in (("jax", jax_default_config, art_j, jax_engine.Tester),
                                    ("port", default_config, art_t, engine.Tester)):
        cfg = _cfg(tmp_path / side, make)
        cfg.DATASET.input_joint_set = "mano"
        kw = {"device": "cpu"} if side == "port" else {}
        if side == "jax":
            cfg.TPU.use_pallas = False
        ds = TinyDataset(6, art, faces, joint_num=21, seed=2)
        out[side] = tester(cfg, load_path=path, dataset=ds, mesh_model=ds.mesh_model,
                           **kw).test(0)
    assert sorted(out["port"]) == sorted(out["jax"])
    for k in out["jax"]:
        _close(out["port"][k], out["jax"][k], rtol=1e-4, err_msg=k)


def test_lift_trainer_and_tester_match_jax(tmp_path, monkeypatch):
    """LiftTrainer (PoseNet at the reference's width 4096, SGD lr 1e-2,
    dropout off) for one epoch of 8 samples at batch 4 == the JAX one from
    the same weights, its save(); LiftTester on the trained lifter and on
    the saved checkpoint == the JAX LiftTester."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    cfgs = {}
    for side, make in (("jax", jax_default_config), ("port", default_config)):
        cfgs[side] = cfg = _cfg(tmp_path / side, make)
        cfg.MODEL.name = "posenet"
        cfg.TRAIN.optimizer = "sgd"
        cfg.TRAIN.lr = 1e-2
    _, faces = uv_sphere(110)
    train, test = LiftDataset(8, None, faces), LiftDataset(6, None, faces, seed=1)
    jtr = jax_engine.LiftTrainer(cfgs["jax"], datasets=[train])
    tr = engine.LiftTrainer(cfgs["port"], datasets=[train], device="cpu")
    tr.model.load_state_dict(posenet_state_dict(to_numpy(jtr.state.params),
                                                to_numpy(jtr.state.batch_stats)))
    tr.model.dropout = 0.0
    _close(tr.train_epoch(1), jtr.train_epoch(1), rtol=1e-4, err_msg="epoch mean loss")
    want = posenet_state_dict(to_numpy(jtr.state.params), to_numpy(jtr.state.batch_stats))
    for k, v in tr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            _close(v, want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    ev_j = jax_engine.LiftTester(cfgs["jax"], dataset=test).test(1, state=jtr.state)
    ev_t = engine.LiftTester(cfgs["port"], dataset=test, device="cpu").test(1, state=tr.state)
    _close(ev_t["mpjpe"], ev_j["mpjpe"], rtol=1e-4)
    tr.save(1, is_best=True)
    best = osp.join(cfgs["port"].checkpoint_dir, "best.pth.tar")
    assert model_family(load_checkpoint(best, device="cpu")["model_state_dict"]) == "posenet"
    ev_ck = engine.LiftTester(cfgs["port"], load_path=best, dataset=test, device="cpu").test(1)
    assert ev_ck == ev_t


def test_refusals(tiny, tmp_path, monkeypatch):
    """A JAX .ckpt of neither a cascade nor a PoseNet raises (naming the
    trees it reads), as does a file that is not a JAX package checkpoint;
    without CUDA the default
    device raises; a mesh larger than the processes running raises (naming
    torchrun), as does steps_per_dispatch > 1 on a mesh; on a CUDA request
    (CUDA reported available) a card index beyond the device count and
    use_pallas false raise before any work on the card, while f32 on a
    graph with band levels gets past the checks to the first tensor sent to
    the card on every path: the training form (Trainer, training-form
    Tester), the group deploy path (the deploy Tester), the unfused training
    form and the unfused, strip and window deploy paths; on the CPU they all
    run."""
    art_j, art_t, faces = tiny
    ck = tmp_path / "jaxck"
    jax_save_checkpoint(str(ck), 1, {"params": {"w": np.ones(3, np.float32)}})
    with pytest.raises(ValueError, match="neither a Pose2Mesh nor a PoseNet"):
        load_checkpoint(str(ck / "checkpoint1.ckpt"), device="cpu")
    with pytest.raises(ValueError, match="neither a Pose2Mesh nor a PoseNet"):
        load_checkpoint(str(ck), device="cpu")  # the directory's latest
    (ck / "checkpoint2.ckpt").write_bytes(b"\x81\xa5epoch\x02")  # msgpack {"epoch": 2}
    with pytest.raises(ValueError, match="not a JAX package checkpoint"):
        load_checkpoint(str(ck), device="cpu")

    def build(cfg, device, **path):
        model = _port_cascade(art_t)
        if path:  # the same weights on another path
            model = Pose2Mesh(J, art_t.mesh_ops[-1].num_vertices, posenet_hidden=32,
                              blocks=TEST_BLOCKS, device="cpu", **path)
        return engine.Trainer(cfg, datasets=[TinyDataset(8, art_t, faces)],
                              test_dataset=TinyDataset(4, art_t, faces, seed=1),
                              model=model, device=device)

    def tester(cfg, device, **path):
        model = None if not path else Pose2Mesh(
            J, art_t.mesh_ops[-1].num_vertices, posenet_hidden=32, blocks=TEST_BLOCKS,
            device="cpu", **path)
        return engine.Tester(cfg, dataset=TinyDataset(4, art_t, faces), model=model,
                             device=device)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.Trainer(_cfg(tmp_path), datasets=[TinyDataset(8, art_t, faces)])
    cfg = _cfg(tmp_path)
    cfg.TPU.use_pallas = False
    build(cfg, "cpu")
    build(_cfg(tmp_path), "cpu")  # f32
    # the further paths: the unfused training form (Trainer, Tester), the
    # unfused, strip and window deploy paths (Tester)
    unfused_train = {"fused": False, "inference_fused": False}
    others = ((build, unfused_train), (tester, unfused_train), (tester, {"fused": False}),
              (tester, {"flat_impl": "strip"}), (tester, {"flat_impl": "window"}))
    for make, path in others:
        make(_cfg(tmp_path), "cpu", **path)
    # a mesh larger than the processes running; steps_per_dispatch > 1 on a
    # mesh (a 2 x 1 mesh stands in for the one a launcher's processes build)
    cfg = _cfg(tmp_path)
    cfg.TPU.data_axis = 2
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        build(cfg, "cpu")
    cfg.TPU.steps_per_dispatch = 2
    with monkeypatch.context() as mp:
        mp.setattr(engine, "_mesh_for", lambda cfg, mesh: Mesh(2, 1, 0, "gloo", {}, {}))
        with pytest.raises(ValueError, match="steps_per_dispatch > 1 requires a 1x1 mesh"):
            build(cfg, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # a card the machine does not have
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="cuda:1: this machine has 1 CUDA device"):
        build(_cfg(tmp_path), "cuda:1")
    cfg = _cfg(tmp_path)
    cfg.TPU.use_pallas = False
    with pytest.raises(ValueError, match="use_pallas"):
        build(cfg, "cuda")
    train_form = _cfg(tmp_path)
    train_form.TEST.deploy = False
    # a caller model on the card cannot be built without CUDA: its device
    # check is taken as passed, so those cases also run to the first tensor
    # sent to the card
    monkeypatch.setattr(core_train, "_model_device",
                        lambda model, device: torch.device(device))
    for make in (lambda: build(_cfg(tmp_path), "cuda"),  # the training form
                 lambda: tester(_cfg(tmp_path), "cuda"),  # the group deploy path
                 lambda: tester(train_form, "cuda"),
                 *(lambda m=m, p=p: m(_cfg(tmp_path), "cuda", **p) for m, p in others)):
        # this torch has no CUDA: the first tensor sent to the card raises
        with pytest.raises(AssertionError, match="not compiled with CUDA"):
            make()


def test_cli_flags_match_jax():
    """The train / test / demo CLIs take the JAX package's flags with the
    same defaults, plus --device (default cuda)."""
    from pose2mesh_release_tpu.cli import demo as jdemo, test as jtest, train as jtrain
    from pose2mesh_release_tpu_torch.cli import demo, test, train
    cases = ((train, jtrain, ["--cfg", "x.yml", "--resume_training", "--seed", "7",
                              "--debug", "--gpu", "0"]),
             (test, jtest, ["--cfg", "x.yml", "--weights", "w.pth.tar", "--gpu", "0,1"]),
             (demo, jdemo, ["--input_pose", "p.json", "--joint_set", "coco",
                            "--cam_steps", "50", "--weights", "w.pth.tar"]))
    for port, ref, argv in cases:
        for args in (argv, argv[:2]):
            got, want = vars(port.parse_args(args)), vars(ref.parse_args(args))
            assert got.pop("device") == "cuda"
            assert got == want, (port.__name__, args)
        assert port.parse_args(argv + ["--device", "cpu"]).device == "cpu"
