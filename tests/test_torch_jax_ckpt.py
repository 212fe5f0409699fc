"""PyTorch port: the JAX package's `.ckpt` checkpoints read without JAX (CPU).

`core.flax_msgpack` against `flax.serialization.msgpack_restore` (bitwise,
every leaf type flax writes, chunked arrays, refusals); the committed
fixture tests/data/jax_ckpt/ against a fresh one from the JAX package, and
its forward and resumed step in the port (chip_smoke phase 16 (b)'s checks,
on the CPU); `load_checkpoint` of JAX cascade and `LiftTrainer` files;
`Tester`, `LiftTester`, `Trainer._load_posenet`, `Trainer(resume=True)`
and `cli.demo --weights x.ckpt` on files that the JAX package writes in the
test, against the JAX package; a `.pth.tar` the port saved, read by the JAX
package.

Resumed steps are held as chip_smoke phase 16 (b) holds them
(`chip_smoke.hold_step`, FIXTURE_STEP_TOLS): every parameter and running
statistic at rtol 1e-3, atol 1e-2 (test_torch_train.py's tolerances for the
trained cascade's outputs) and each one's step, the change over the step,
within 1e-2 relative L2 of the JAX step; the biases whose exact gradient is
zero (`chip_smoke.cancelling_biases`) within RMSprop's 1 / sqrt(1 - 0.99) =
10 learning rates on both sides.  RMSprop and Adam divide a gradient by its
own scale, so where it is rounding (those biases, single elements elsewhere)
each framework steps by up to that bound.
"""
import os.path as osp
import struct

import flax.linen
import flax.serialization
import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.config import default_config as jax_default_config
from pose2mesh_release_tpu.core import engine as jax_engine
from pose2mesh_release_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from pose2mesh_release_tpu.core.checkpoint import save_checkpoint as jax_save_checkpoint
from pose2mesh_release_tpu.core.train import make_eval_step as jax_make_eval_step
from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh as JaxPose2Mesh
from pose2mesh_release_tpu.models.posenet import PoseNet as JaxPoseNet
from pose2mesh_release_tpu.parity.convert import convert_cascade_state_dict
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.config import default_config
from pose2mesh_release_tpu_torch.core import engine
from pose2mesh_release_tpu_torch.core import flax_msgpack
from pose2mesh_release_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
from pose2mesh_release_tpu_torch.core.train import make_eval_step
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.parity.from_jax import (
    optim_state_from_flax, posenet_state_dict, state_dict_from_flax,
)

import chip_smoke
from jax_ckpt_fixture import FIXTURE_DIR, regenerate
from test_torch_engine import _cfg, _port_cascade, tiny  # noqa: F401
from test_torch_models import randomize_bn, to_numpy
from test_torch_train import _NoDropout
from torch_mesh_helpers import J, TEST_BLOCKS, LiftDataset, TinyDataset

# ---- the decoder ------------------------------------------------------------

def _bf16(values):
    return np.asarray(values, np.float32).astype(ml_dtypes.bfloat16)


TREES = {
    "float32": lambda: {"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7},
    "bfloat16": lambda: {"w": _bf16([[1.5, -2.25], [3e-3, 7e4]]),
                         "jax": jnp.full((2, 3), 0.1, jnp.bfloat16)},
    "int32_int64": lambda: {"i": np.array([-1, 2**31 - 1], np.int32),
                            "j": np.array([[-2**62, 5]], np.int64)},
    "bool": lambda: {"mask": np.array([True, False, True])},
    "zero_d": lambda: {"x": np.array(3.5, np.float32), "n": np.array(-4, np.int64),
                       "empty": np.zeros((0, 4), np.float32)},
    "numpy_scalars": lambda: {"f": np.float32(1.5), "d": np.float64(-2.5),
                              "i": np.int32(-3), "u": np.uint8(200), "b": np.bool_(True),
                              "h": ml_dtypes.bfloat16(2.0)},
    "complex": lambda: {"c": 3 + 4j, "a": np.array([1 + 2j, -1j], np.complex64)},
    "python_leaves": lambda: {"s": "héllo", "long": "x" * 300, "none": None, "t": True,
                              "f": False, "i": [0, 127, 128, -32, -33, 2**40, -2**40, 2**64 - 1],
                              "x": 1.25, "raw": b"\x00\xff" * 200},
    "nested_and_empty": lambda: {"a": {"b": {"c": [np.ones(2, np.float32), [], {}]}},
                                 "e": {}, "l": [], "wide": {str(i): i for i in range(20)},
                                 "long": list(range(70000))},
    "train_state": lambda: flax_msgpack.restore(
        open(osp.join(FIXTURE_DIR, "checkpoint1.ckpt"), "rb").read()),
}


def _same(got, want, path="."):
    """Bitwise equality of two decoded trees: types, keys, dtypes, shapes,
    bytes (a bfloat16 array or scalar is a torch bfloat16 tensor in the
    port)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, (path, type(got))
        assert np.shape(got) == np.shape(want) and got.tobytes() == want.tobytes(), path
    elif isinstance(want, float):
        assert type(got) is float and struct.pack(">d", got) == struct.pack(">d", want), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", sorted(TREES))
def test_decoder_matches_flax_restore(name):
    """flax_msgpack.restore == flax's msgpack_restore, bit for bit, on trees
    that flax's msgpack_serialize writes."""
    blob = flax.serialization.msgpack_serialize(TREES[name]())
    _same(flax_msgpack.restore(blob), flax.serialization.msgpack_restore(blob))


def test_decoder_joins_chunked_arrays(monkeypatch):
    """Arrays above flax's MAX_CHUNK_SIZE are written in chunks (here with
    the limit lowered to 64 bytes) and joined as flax joins them, at the
    top level and nested."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "sub": {"big": np.arange(50, dtype=np.int64), "small": np.ones(3, np.float32)},
            "bf": _bf16(np.linspace(-1, 1, 70))}
    blob = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _same(flax_msgpack.restore(blob), flax.serialization.msgpack_restore(blob))


def _bad_blobs():
    good = flax.serialization.msgpack_serialize({"w": np.ones((2, 2), np.float32), "s": "ab"})
    return {
        "truncated_tail": good[:-1],
        "truncated_half": good[:len(good) // 2],
        "truncated_header": good[:1],
        "empty": b"",
        "unknown_ext": msgpack.packb({"w": msgpack.ExtType(9, b"xyz")}),
        "timestamp_ext": b"\xd6\xff" + b"\x00" * 4,  # fixext 4, type -1
        "reserved_byte": b"\xc1",
        "trailing_bytes": good + b"\x00",
        "int_map_key": msgpack.packb({1: 2}, strict_types=False),
    }


@pytest.mark.parametrize("name", sorted(_bad_blobs()))
def test_decoder_refuses(name):
    """Truncated input, an ext code flax does not write, a reserved byte,
    bytes after the object and a non-string map key raise ValueError."""
    with pytest.raises(ValueError):
        flax_msgpack.restore(_bad_blobs()[name])


# ---- the committed fixture --------------------------------------------------

def _close_tree(got, want, path="."):
    """Regenerated against committed: structure and integers exactly,
    floats within float32 rounding of a re-run."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic, float)) and \
            np.asarray(want).dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=path)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), path
    else:
        assert got == want, path


def test_fixture_is_what_the_jax_package_writes(tmp_path):
    """tests/data/jax_ckpt/ regenerated by the JAX package (the JAX
    save_checkpoint, make_train_step, make_eval_step; in a fresh process on
    one CPU under the fixture's pinned thread counts) decodes to the
    committed files' arrays, and stays under 1 MB."""
    regenerate(str(tmp_path))
    sizes = 0
    for name in ("checkpoint1.ckpt", "fixture.npz"):
        sizes += osp.getsize(osp.join(FIXTURE_DIR, name))
    assert sizes < 1 << 20
    read = lambda d: flax_msgpack.restore(open(osp.join(d, "checkpoint1.ckpt"), "rb").read())
    _close_tree(read(FIXTURE_DIR), read(str(tmp_path)))
    got = dict(np.load(osp.join(FIXTURE_DIR, "fixture.npz")))
    want = dict(np.load(osp.join(tmp_path, "fixture.npz")))
    assert sorted(got) == sorted(want)
    assert str(got.pop("config")) == str(want.pop("config"))
    _close_tree(got, want)


def test_fixture_forward_and_resumed_step():
    """Phase 16 (b) on the CPU: the committed .ckpt through load_checkpoint,
    the deploy forward (BatchNorm folded) against the JAX eval outputs
    (float32, 1e-4 relative L2), then a resumed RMSprop step against the JAX
    package's second step (losses rtol 1e-4; parameters and statistics as
    the module docstring says)."""
    fx = chip_smoke.read_jax_fixture(FIXTURE_DIR, device="cpu")
    c, art, payload = fx["config"], fx["art"], fx["payload"]
    assert [op.kind for op in art.mesh_ops] == ["band", "band", "dense", "dense"]
    assert payload["epoch"] == 1 and payload["step"] == 1 and payload["family"] == "cascade"
    assert payload["test_log"] == {"joint": [123.5]} and len(payload["train_log"]) == 1
    errs = chip_smoke.jax_fixture_forward(fx, torch.float32, "cpu")
    assert max(errs.values()) <= 1e-4, errs
    res = chip_smoke.jax_fixture_step(fx, "cpu")
    assert res["ok"], res


# ---- load_checkpoint of files the JAX package writes -------------------------

def _jax_run(tmp_path, tiny, optimizer, steps_per_epoch=1):  # noqa: F811
    """A JAX Trainer (dropout off) for one epoch, saved as its engine saves
    (checkpoint1.ckpt, best.ckpt) with a test log; returns (JAX trainer,
    its cfg)."""
    art_j, art_t, faces = tiny
    cfg = _cfg(tmp_path / "run", jax_default_config)
    cfg.TRAIN.optimizer = optimizer
    cfg.TRAIN.shuffle = False
    jtr = jax_engine.Trainer(
        cfg, datasets=[TinyDataset(4 * steps_per_epoch, art_j, faces)],
        test_dataset=TinyDataset(6, art_j, faces, seed=1),
        model=JaxPose2Mesh(num_joint=J, posenet_hidden=32, blocks=TEST_BLOCKS,
                           use_pallas=False))
    jtr.train_epoch(1)
    jtr.test_log.append(50.25)
    jtr._save(1, is_best=True, final=False)
    return jtr, cfg


def _port_names(model):
    return [n for n, _ in model.named_parameters()]


def test_load_checkpoint_of_jax_cascade(tiny, tmp_path, monkeypatch):  # noqa: F811
    """A JAX Trainer's checkpoint1.ckpt: the payload keys of a .pth.tar, the
    state dict of the JAX variables (bit for bit), the optimizer state in
    the order of model.parameters() (square_avg = the JAX nu, bit for bit),
    step, epoch and logs; a directory resolves to best.ckpt."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    jtr, cfg = _jax_run(tmp_path, tiny, "rmsprop", steps_per_epoch=2)
    path = osp.join(cfg.checkpoint_dir, "checkpoint1.ckpt")
    payload = load_checkpoint(path, device="cpu")
    assert sorted(payload) == ["epoch", "family", "model_state_dict", "optim_state_dict",
                               "step", "test_log", "train_log"]
    assert payload["family"] == "cascade" and payload["epoch"] == 1 and payload["step"] == 2
    assert payload["train_log"] == jtr.train_log
    assert payload["test_log"] == {"joint": [50.25]}
    state = jax.device_get(jtr.state)
    want = state_dict_from_flax(to_numpy({"params": state.params,
                                          "batch_stats": state.batch_stats}))
    assert list(payload["model_state_dict"]) == list(want)
    for k, v in want.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    model = _port_cascade(tiny[1])
    model.load_state_dict(payload["model_state_dict"])
    nu = state_dict_from_flax({"params": to_numpy(state.opt_state.nu),
                               "batch_stats": to_numpy(state.batch_stats)})
    opt = payload["optim_state_dict"]
    assert opt["param_groups"][0]["params"] == list(range(len(_port_names(model))))
    for i, name in enumerate(_port_names(model)):
        assert torch.equal(opt["state"][i]["square_avg"], nu[name]), name
        assert float(opt["state"][i]["step"]) == 2.0
    best = load_checkpoint(cfg.checkpoint_dir, pick_best=True, device="cpu")
    assert best["epoch"] == 1 and list(best["model_state_dict"]) == list(want)


def _jax_posenet_ckpt(ckpt_dir, joint_num, hidden, seed, with_opt=True):
    """A LiftTrainer-layout checkpoint (a PoseNet tree alone, as best.ckpt),
    written by the JAX package's save_checkpoint; returns its variables."""
    model = JaxPoseNet(joint_num, hidden=hidden)
    v = to_numpy(model.init(jax.random.PRNGKey(seed), jnp.zeros((2, joint_num * 2)), False))
    randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(seed))
    state = {"params": v["params"], "batch_stats": v["batch_stats"], "step": np.int32(3)}
    if with_opt:
        import optax
        state["opt_state"] = flax.serialization.to_state_dict(
            optax.scale_by_rms(0.99, 1e-8, eps_in_sqrt=False).init(v["params"]))
    jax_save_checkpoint(str(ckpt_dir), 4, state, train_log=[2.5], is_best=True)
    return v


def test_load_checkpoint_of_jax_lift_trainer(tmp_path):
    """A LiftTrainer-layout .ckpt (PoseNet alone): family posenet, PoseNet's
    names, its optimizer state in PoseNet.parameters()' order."""
    v = _jax_posenet_ckpt(tmp_path, J, 32, seed=1)
    payload = load_checkpoint(osp.join(tmp_path, "checkpoint4.ckpt"), device="cpu")
    assert payload["family"] == "posenet" and payload["epoch"] == 4 and payload["step"] == 3
    want = posenet_state_dict(v["params"], v["batch_stats"])
    assert list(payload["model_state_dict"]) == list(want)
    for k, t in want.items():
        assert torch.equal(payload["model_state_dict"][k], t), k
    from pose2mesh_release_tpu_torch.models.posenet import PoseNet
    model = PoseNet(J, hidden=32)
    model.load_state_dict(payload["model_state_dict"])
    opt = make_preconditioner("rmsprop", model.parameters())
    opt.load_state_dict(payload["optim_state_dict"])
    assert len(opt.state) == len(_port_names(model))


def test_optim_state_refuses_other_trees():
    """An optimizer tree that is none of the JAX package's three, or whose
    moments do not match the params, raises: the optimizer is never reset
    silently."""
    params = {"Dense_0": {"kernel": np.ones((2, 3), np.float32), "bias": np.ones(3, np.float32)},
              "Dense_1": {"kernel": np.ones((3, 2), np.float32), "bias": np.ones(2, np.float32)}}
    with pytest.raises(ValueError, match="optimizer state with keys"):
        optim_state_from_flax({"trace": params}, params, 1)
    bad = {"Dense_0": params["Dense_0"], "Dense_1": {"kernel": np.ones((2, 2), np.float32),
                                                     "bias": np.ones(2, np.float32)}}
    with pytest.raises(ValueError, match="does not match"):
        optim_state_from_flax({"nu": bad}, params, 1)
    with pytest.raises(ValueError, match="does not match"):
        optim_state_from_flax({"nu": {"Dense_0": params["Dense_0"]}}, params, 1)
    for name, state in (("sgd", {}), ("rmsprop", {"nu": params}),
                        ("adam", {"count": np.int32(2), "mu": params, "nu": params})):
        sd = optim_state_from_flax(state, params, 2)
        opt = make_preconditioner(name, [torch.zeros(3, 2), torch.zeros(3),
                                         torch.zeros(2, 3), torch.zeros(2)])
        opt.load_state_dict(sd)
        assert sd["param_groups"][0] == dict(opt.state_dict()["param_groups"][0])


# ---- the entry points on JAX .ckpt files -----------------------------------

def test_tester_and_lift_tester_serve_jax_ckpt(tiny, tmp_path, monkeypatch):  # noqa: F811
    """The deploy Tester (BatchNorm folded at load) on a JAX Trainer's
    .ckpt == the JAX Tester on the same file (rtol 1e-4, float32); the
    LiftTester on a JAX LiftTrainer-layout best.ckpt (PoseNet 4096) == the
    JAX LiftTester on it."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    art_j, art_t, faces = tiny
    jtr, cfg = _jax_run(tmp_path, tiny, "rmsprop")
    path = osp.join(cfg.checkpoint_dir, "checkpoint1.ckpt")
    out = {}
    for side, make, art, tester in (("jax", jax_default_config, art_j, jax_engine.Tester),
                                    ("port", default_config, art_t, engine.Tester)):
        tcfg = _cfg(tmp_path / side, make)
        kw = {"device": "cpu"} if side == "port" else {}
        if side == "jax":
            tcfg.TPU.use_pallas = False
            monkeypatch.setattr(jax_engine.Tester, "_build_cascade",
                                lambda self, j, mano, deploy=False: JaxPose2Mesh(
                                    num_joint=j, posenet_hidden=32, blocks=TEST_BLOCKS,
                                    use_pallas=False, inference_fused=deploy))
        else:
            monkeypatch.setattr(engine.Tester, "_build_cascade", lambda self, j, art, mano,
                                deploy=False: Pose2Mesh(
                                    j, art.mesh_ops[-1].num_vertices, posenet_hidden=32,
                                    blocks=TEST_BLOCKS, inference_fused=deploy,
                                    device="cpu"))
        ds = TinyDataset(6, art, faces, seed=2)
        t = tester(tcfg, load_path=path, dataset=ds, mesh_model=ds.mesh_model, **kw)
        out[side] = t.test(0)
        if side == "port":
            assert t._deploy
    assert sorted(out["port"]) == sorted(out["jax"])
    for k in out["jax"]:
        np.testing.assert_allclose(out["port"][k], out["jax"][k], rtol=1e-4, err_msg=k)

    _, faces = uv_sphere(110)
    test = LiftDataset(6, None, faces, seed=1)
    ck = tmp_path / "lift"
    _jax_posenet_ckpt(ck, J, 4096, seed=2, with_opt=False)
    lcfg = {side: _cfg(tmp_path / f"lift_{side}", make)
            for side, make in (("jax", jax_default_config), ("port", default_config))}
    want = jax_engine.LiftTester(lcfg["jax"], load_path=str(ck), dataset=test).test(1)
    got = engine.LiftTester(lcfg["port"], load_path=str(ck), dataset=test,
                            device="cpu").test(1)
    np.testing.assert_allclose(got["mpjpe"], want["mpjpe"], rtol=1e-4)


def test_load_posenet_from_jax_best_ckpt(tiny, tmp_path):  # noqa: F811
    """cfg.MODEL.posenet_pretrained with posenet_path a JAX LiftTrainer's
    directory: Trainer._load_posenet takes its best.ckpt into the cascade's
    lifter (every weight and running statistic bit for bit)."""
    _, art_t, faces = tiny
    v = _jax_posenet_ckpt(tmp_path / "lift", J, 32, seed=5)
    cfg = _cfg(tmp_path / "run")
    cfg.MODEL.posenet_pretrained = True
    cfg.MODEL.posenet_path = str(tmp_path / "lift")
    tr = engine.Trainer(cfg, datasets=[TinyDataset(4, art_t, faces)],
                        test_dataset=TinyDataset(4, art_t, faces, seed=1),
                        model=_port_cascade(art_t), device="cpu")
    got = tr.model.pose_lifter.state_dict()
    for k, t in posenet_state_dict(v["params"], v["batch_stats"]).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], t), k


@pytest.mark.parametrize("optimizer", ["rmsprop", "adam"])
def test_trainer_resumes_a_jax_run(optimizer, tiny, tmp_path, monkeypatch):  # noqa: F811
    """Trainer(resume=True) in the directory of a JAX run (one epoch of one
    step, saved by the JAX engine): epoch, logs, step, weights, running
    statistics and the optimizer's state; then its next epoch (one step)
    == the JAX Trainer's next epoch (loss rtol 1e-4; the state as the
    module docstring says)."""
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    art_j, art_t, faces = tiny
    jtr, jcfg = _jax_run(tmp_path, tiny, optimizer)
    cfg = _cfg(tmp_path / "run")  # the JAX run's directory
    cfg.TRAIN.optimizer = optimizer
    cfg.TRAIN.shuffle = False
    tr = engine.Trainer(cfg, resume=True, datasets=[TinyDataset(4, art_t, faces)],
                        test_dataset=TinyDataset(6, art_t, faces, seed=1),
                        model=_port_cascade(art_t, seed=9), device="cpu")
    assert tr.begin_epoch == 2 and tr.state.step == 1
    assert tr.train_log == jtr.train_log and tr.test_log == [50.25]
    jstate = jax.device_get(jtr.state)
    before = state_dict_from_flax(to_numpy({"params": jstate.params,
                                            "batch_stats": jstate.batch_stats}))
    for k, v in before.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(tr.model.state_dict()[k], v), k
    ostate = tr.optimizer.state_dict()["state"]
    moments = {"rmsprop": {"square_avg": "nu"},
               "adam": {"exp_avg": "mu", "exp_avg_sq": "nu"}}[optimizer]
    for torch_key, jax_key in moments.items():
        m = state_dict_from_flax({"params": to_numpy(getattr(jstate.opt_state, jax_key)),
                                  "batch_stats": to_numpy(jstate.batch_stats)})
        for i, name in enumerate(_port_names(tr.model)):
            assert torch.equal(ostate[i][torch_key], m[name]), (torch_key, name)
            assert float(ostate[i]["step"]) == 1.0
    np.testing.assert_allclose(tr.train_epoch(2), jtr.train_epoch(2), rtol=1e-4)
    after = jax.device_get(jtr.state)
    want = state_dict_from_flax(to_numpy({"params": after.params,
                                          "batch_stats": after.batch_stats}))
    bad = chip_smoke.hold_step(tr.model.state_dict(), want, before, tr.lr_at(2),
                               chip_smoke.cancelling_biases(tr.model),
                               **chip_smoke.FIXTURE_STEP_TOLS)
    assert not bad, bad


def test_demo_takes_jax_ckpt(tmp_path):
    """cli.demo --weights x.ckpt (a JAX save_checkpoint of a MANO cascade,
    PoseNet 4096) on the CPU == cli.demo --weights x.pth.tar of the same
    weights, bit for bit (the .pth.tar path is held against the JAX demo by
    test_torch_demo.py)."""
    from pose2mesh_release_tpu_torch.body.mano import MANO
    from pose2mesh_release_tpu_torch.cli import demo
    from pose2mesh_release_tpu_torch.data.base import pyramid_for
    from pose2mesh_release_tpu_torch.data.joint_sets import MANO_SET
    mano = MANO()
    art = pyramid_for(np.asarray(mano.face), MANO_SET, 6)
    model = Pose2Mesh(21, art.mesh_ops[-1].num_vertices, mano=True, inference_fused=False,
                      device="cpu", generator=torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_cascade_state_dict(sd)
    jax_save_checkpoint(str(tmp_path / "jax"), 1, {**variables, "step": np.int32(0)},
                        is_final=True)
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()}, tmp_path / "w.pth.tar")
    joints = mano.joint_regressor_mano @ mano.params.v_template
    np.save(tmp_path / "pose.npy", np.float32(joints[:, :2] * 2000.0 + 300.0))
    meshes = {}
    for name, weights in (("ckpt", str(tmp_path / "jax" / "final.ckpt")),
                          ("pth", str(tmp_path / "w.pth.tar"))):
        out = str(tmp_path / name)
        res = demo.main(["--input_pose", str(tmp_path / "pose.npy"), "--joint_set", "mano",
                         "--weights", weights, "--cam_steps", "10", "--out_dir", out,
                         "--device", "cpu"])
        meshes[name] = open(res["people"][0]["obj"]).read()
    assert meshes["ckpt"] == meshes["pth"]


def test_port_pth_tar_read_by_the_jax_package(tiny, tmp_path):  # noqa: F811
    """A .pth.tar that the port's save_checkpoint wrote, read by the JAX
    package's load_checkpoint: the JAX eval forward of it == the port's
    (rtol 1e-4, float32)."""
    art_j, art_t, _ = tiny
    g = torch.Generator().manual_seed(6)
    model = _port_cascade(art_t, seed=6)
    with torch.no_grad():  # non-identity BatchNorms
        for name, t in model.state_dict().items():
            if "running_var" in name:
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif "running_mean" in name:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    opt = make_preconditioner("rmsprop", model.parameters())
    path = save_checkpoint(str(tmp_path), 3, model, opt, step=5)
    payload = jax_load_checkpoint(path)
    jmodel = JaxPose2Mesh(num_joint=J, posenet_hidden=32, blocks=TEST_BLOCKS, use_pallas=False)
    from pose2mesh_release_tpu.core.train import TrainState as JaxTrainState
    st = payload["state"]
    jstate = JaxTrainState(params=st["params"], batch_stats=st["batch_stats"],
                           opt_state=None, step=jnp.asarray(0))
    rng = np.random.default_rng(2)
    pose2d = rng.standard_normal((3, J, 2)).astype(np.float32)
    jreg = rng.random((J, 770)).astype(np.float32)
    want = jax.jit(jax_make_eval_step(jmodel, jnp.asarray(jreg)))(jstate, art_j,
                                                                  jnp.asarray(pose2d))
    got = make_eval_step(model, jreg, device="cpu")(art_t, torch.from_numpy(pose2d))
    for name, t, w in zip(("mesh", "reg_pose", "pose3d"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
