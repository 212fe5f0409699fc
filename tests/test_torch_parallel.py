"""PyTorch port: multi-device training and evaluation on a ('data', 'graph')
mesh of gloo CPU ranks, against the JAX package and the one-device port.

Ranks are spawned processes (`parallel.distributed.spawn_ranks`, a file
rendezvous in a temporary directory, one thread each) running the functions
of tests/torch_mesh_helpers.py; every spawn has a deadline of TIMEOUT
seconds after which its ranks are killed and the test fails.  Each spawn
runs once per module (a fixture) and its cases are checked by the tests.

  * `init_distributed` without a launcher; the rank layout of `make_mesh`
    against the JAX `make_mesh`;
  * `_local_band_hop` against the JAX one (k 1 and 2, float32 and bf16);
  * `halo_banded_hop` on 4 graph ranks against the JAX `halo_banded_hop` on
    a (1, 4) mesh of the virtual CPU devices (the uv_sphere 770 band level at
    block 32; tests/test_sharding.py's random band_k 2 band in float32 and
    bf16), its VJP against the one-device hop of the cotangent;
  * `masked_batch_norm` on 2 ranks against the JAX `_MaskedBatchNorm` on the
    whole padded tensor;
  * one SGD step on (2, 1) and (2, 2) meshes against the port's one-device
    step and the JAX one-device step from the same weights (the artifact
    and MeshNet schedule of `__graft_entry__._build_small`, PoseNet hidden
    32 in place of its 4096, float32, dropout off): loss rtol 1e-5,
    parameters atol 2e-5, as tests/test_sharding.py holds the JAX sharded
    step; the census of the (2, 2) step (no band-sized gather outside the
    level transitions);
  * dropout 0.5 on a (2, 2) mesh: graph ranks of one data index draw the
    same mask, data ranks different ones, and every rank's state stays equal;
  * `Trainer.fit` for one epoch of tests/test_torch_engine.py's TinyDataset
    on a 2 x 2 mesh against 1 x 1 (loss rtol 1e-5, parameters atol 2e-5, the
    Tester's metrics rtol 1e-5, then a deploy Tester's); only rank 0 writes
    files; `LiftTrainer` / `LiftTester` on the same mesh against 1 x 1.
"""
import os
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import Mesh as JaxMesh

from pose2mesh_release_tpu.body.synthetic import uv_sphere as jax_uv_sphere
from pose2mesh_release_tpu.core.optim import make_preconditioner as jax_preconditioner
from pose2mesh_release_tpu.core.train import TrainState as JaxTrainState
from pose2mesh_release_tpu.core.train import make_train_step as jax_make_train_step
from pose2mesh_release_tpu.graphs import artifact as jax_artifact
from pose2mesh_release_tpu.graphs.build import build_pyramid as jax_build_pyramid
from pose2mesh_release_tpu.models.meshnet import _MaskedBatchNorm
from pose2mesh_release_tpu.parallel import halo as jax_halo
from pose2mesh_release_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pose2mesh_release_tpu_torch.config import default_config
from pose2mesh_release_tpu_torch.core import engine
from pose2mesh_release_tpu_torch.graphs.artifact import load_artifact
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
from pose2mesh_release_tpu_torch.ops.hop import hop_plain
from pose2mesh_release_tpu_torch.parallel import halo
from pose2mesh_release_tpu_torch.parallel.audit import (
    LEVEL_ENTRY, Census, assert_no_large_gather, band_threshold,
)
from pose2mesh_release_tpu_torch.parallel.collectives import backward_site
from pose2mesh_release_tpu_torch.parallel.distributed import (
    host_shard, init_distributed, is_primary, local_rank, spawn_ranks,
)
from pose2mesh_release_tpu_torch.parallel.mesh import layout
from pose2mesh_release_tpu_torch.parity.from_jax import state_dict_from_flax
from pose2mesh_release_tpu_torch.train_setup import synthetic_batch

import torch_mesh_helpers as H
from test_torch_models import randomize_bn, to_numpy
from test_torch_train import _NoDropout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
F32_TOL, BF16_TOL = 1e-5, 2e-2  # tests/test_sharding.py's halo tolerances


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=err_msg, **tol)


# ---- the mesh ---------------------------------------------------------------

def test_init_distributed_without_a_launcher(monkeypatch):
    """No launcher environment and no arguments: (0, 1) and nothing joined,
    as the JAX init_distributed's no-op; one process, the primary one."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() == (0, 1) and not torch.distributed.is_initialized()
    assert host_shard() == (0, 1) and is_primary() and local_rank() == 0


@pytest.mark.parametrize("world,graph_axis", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2),
                                              (4, 4), (6, 3), (8, 2)])
def test_mesh_layout_matches_jax(world, graph_axis):
    """Rank r sits at (r // g, r % g), where the JAX make_mesh puts device r."""
    data, graph = layout(world, graph_axis)
    ids = np.vectorize(lambda d: d.id)(
        jax_make_mesh(jax.devices()[:world], graph_axis=graph_axis).devices)
    assert graph == ids.tolist()
    assert data == ids.T.tolist()


@pytest.mark.parametrize("world,graph_axis", [(3, 2), (4, 3), (8, 3)])
def test_mesh_layout_indivisible_raises(world, graph_axis):
    with pytest.raises(ValueError, match="not divisible"):
        jax_make_mesh(jax.devices()[:world], graph_axis=graph_axis)
    with pytest.raises(ValueError, match="not divisible"):
        layout(world, graph_axis)


# ---- the halo hop -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2])
def test_local_band_hop_matches_jax(k, dtype):
    rng = np.random.default_rng(k)
    T, nt, C = 16, 5, 12
    band, xt = rng.standard_normal((2 * k + 1, nt, T, T)), rng.standard_normal((nt, T, C))
    left, right = rng.standard_normal((2, k, T, C))
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax_halo._local_band_hop(*(jnp.asarray(a, jt) for a in (band, xt, left, right)))
    tt = getattr(torch, dtype)
    got = halo._local_band_hop(*(torch.from_numpy(a).to(tt) for a in (band, xt, left, right)))
    assert got.dtype == tt and got.shape == (nt, T, C)
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    _close(got.float(), np.asarray(want, np.float32), rtol=tol, atol=tol)


def _random_k2_op():
    """tests/test_sharding.py::test_halo_banded_hop_k2_and_bf16's operator."""
    T, nt = 16, 16
    V = T * nt
    rng = np.random.default_rng(3)
    bw = 2 * T - 3
    rows, cols, vals = [], [], []
    for i in range(V):
        for j in range(max(0, i - bw), min(V, i + bw + 1)):
            if abs(i - j) <= bw and rng.random() < 0.2:
                rows.append(i); cols.append(j); vals.append(rng.standard_normal())
    L = sp.coo_matrix((vals, (rows, cols)), shape=(V, V))
    op = jax_artifact._make_level_op(((L + L.T) * 0.5).tocsr(), "band", T)
    assert op.band_k == 2
    return op, rng


def _sphere_op():
    """tests/test_sharding.py::test_halo_banded_hop_matches_local's operator."""
    _, faces = jax_uv_sphere(770)
    pyr = jax_build_pyramid(faces, joint_num=7,
                            skeleton=((0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)),
                            levels=4)
    art = jax_artifact.pack_pyramid(pyr, faces, dense_threshold=64, block_size=32)
    return next(o for o in art.mesh_ops if o.kind == "band"), np.random.default_rng(0)


HALO_CASES = {"uv_sphere770_f32": (_sphere_op, "float32"),
              "random_k2_f32": (_random_k2_op, "float32"),
              "random_k2_bf16": (_random_k2_op, "bfloat16")}


@pytest.fixture(scope="module")
def halo_runs():
    """Each case: (JAX op, x, g, dtype) and the 4 ranks' results."""
    cases = {}
    for name, (make, dt) in HALO_CASES.items():
        op, rng = make()
        x = rng.standard_normal((op.num_vertices, 2, 8)).astype(np.float32)
        g = rng.standard_normal(x.shape).astype(np.float32)
        cases[name] = (op, x, g, dt)
    args = [(np.asarray(op.band_val, np.float32), x, g, dt) for op, x, g, dt in cases.values()]
    ranks = spawn_ranks(H.halo_hops, 4, (args,), timeout=TIMEOUT)
    return {name: (case, [r[i] for r in ranks]) for i, (name, case) in enumerate(cases.items())}


@pytest.mark.parametrize("case", sorted(HALO_CASES))
def test_halo_banded_hop_matches_jax(halo_runs, case):
    """4 graph ranks' hop == the JAX halo hop on a (1, 4) mesh; its VJP ==
    the one-device hop of the cotangent (L symmetric)."""
    (op, x, g, dt), ranks = halo_runs[case]
    V = op.num_vertices
    jt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    mesh = JaxMesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "graph"))
    assert jax_halo.halo_supported(op, mesh)
    want = jax.jit(lambda x_: jax_halo.halo_banded_hop(op, x_, mesh))(jnp.asarray(x, jt))
    y = np.concatenate([r["y"] for r in ranks])[:V]
    dx = np.concatenate([r["dx"] for r in ranks])[:V]
    tol = BF16_TOL if dt == "bfloat16" else F32_TOL
    _close(y, np.asarray(want, np.float32), rtol=tol, atol=tol)
    tt = getattr(torch, dt)
    band = torch.from_numpy(np.array(op.band_val, np.float32)).to(tt)
    want_dx = hop_plain(band, torch.from_numpy(g).to(tt)).float().numpy()
    _close(dx, want_dx, rtol=tol, atol=tol)
    # rows beyond V hold zeros; two hops of one input agree to the bit
    assert not np.concatenate([r["y"] for r in ranks])[V:].any()
    assert all(r["equal_bits"] for r in ranks)
    # 3 exchanges (forward, VJP, again): edge ranks send one side, inner ones two
    sends = [r["census"]["by_kind"]["halo"]["count"] for r in ranks]
    assert sends == [3, 6, 6, 3]


# ---- the masked BatchNorm -------------------------------------------------------

def test_masked_batch_norm_matches_jax():
    """2 graph ranks' training BatchNorm of a row-padded tensor == the JAX
    `_MaskedBatchNorm` on the whole padded tensor: output on the real rows,
    zero pad rows, the running statistics."""
    rng = np.random.default_rng(5)
    Vp, V, B, F = 64, 50, 3, 6
    y = (rng.standard_normal((Vp, B, F)) * 2 + 1).astype(np.float32)
    y[V:] = 0.0
    p = {"weight": rng.random(F) + 0.5, "bias": rng.standard_normal(F),
         "running_mean": rng.standard_normal(F), "running_var": rng.random(F) + 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    bn = _MaskedBatchNorm(real_rows=V, use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply(
        {"params": {"scale": p["weight"], "bias": p["bias"]},
         "batch_stats": {"mean": p["running_mean"], "var": p["running_var"]}},
        jnp.asarray(y), mutable=["batch_stats"])
    ranks = spawn_ranks(H.masked_bn, 2, (y, V, p), timeout=TIMEOUT)
    out = np.concatenate([r["out"] for r in ranks])
    _close(out[:V], np.asarray(want)[:V], rtol=1e-5, atol=1e-5)
    assert not out[V:].any()
    for r in ranks:
        _close(r["mean"], upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-6)
        _close(r["var"], upd["batch_stats"]["var"], rtol=1e-5, atol=1e-6)


# ---- the sharded train step --------------------------------------------------------

STEP_LR = 1e-3
STEP_BATCH = 8


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """`_build_small`'s artifact (JAX packed, read by the port from its npz)
    and MeshNet schedule; JAX-initialised weights as the port's state dict;
    a batch; the JAX and the port's one-device SGD steps."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import _build_small

    art_j, small = _build_small()
    path = str(tmp_path_factory.mktemp("art") / "small.npz")
    jax_artifact.save_artifact(path, art_j)
    art_t = load_artifact(path, device="cpu")
    assert [op.kind for op in art_t.mesh_ops][:2] == ["band", "band"]
    rng = np.random.default_rng(0)
    V, J = art_t.num_vertices, art_t.joint_num
    jreg = rng.random((J, V)).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    template = (jax_uv_sphere(770)[0] * np.array([0.3, 0.2, 0.9])).astype(np.float32)
    batch = synthetic_batch(template, STEP_BATCH, jreg, rng)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        jmodel = type(small)(num_joint=J, posenet_hidden=32, blocks=small.blocks,
                             use_pallas=False)
        v = to_numpy(jax.jit(jmodel.init, static_argnums=3)(
            jax.random.PRNGKey(0), art_j, jnp.asarray(batch["pose2d"]), False))
        randomize_bn(v["params"], v["batch_stats"], np.random.default_rng(1))
        tx = jax_preconditioner("sgd")
        jstep = jax.jit(jax_make_train_step(jmodel, tx, jnp.asarray(jreg)))
        jstate, jlosses = jstep(JaxTrainState.create(v, tx), art_j,
                                {k: jnp.asarray(b) for k, b in batch.items()},
                                jnp.float32(STEP_LR), jnp.bool_(True), jax.random.PRNGKey(0))
    state = {k: t.numpy() for k, t in state_dict_from_flax(v).items()}
    jax_after = state_dict_from_flax(to_numpy({"params": jstate.params,
                                               "batch_stats": jstate.batch_stats}))
    # the port on one device
    model = Pose2Mesh(J, art_t.mesh_ops[-1].num_vertices, posenet_hidden=32,
                      blocks=small.blocks, inference_fused=False, dropout=0.0, device="cpu")
    model.load_state_dict(H._torch(state))
    from pose2mesh_release_tpu_torch.core.optim import make_preconditioner
    from pose2mesh_release_tpu_torch.core.train import TrainState, make_train_step
    opt = make_preconditioner("sgd", model.parameters())
    _, losses = make_train_step(model, opt, jreg, device="cpu")(
        TrainState(model, opt), art_t, H._torch(batch), STEP_LR, True, None)
    return {"art": art_t, "blocks": small.blocks, "state": state, "batch": batch,
            "jreg": jreg, "jax_losses": {k: float(x) for k, x in jlosses.items()},
            "jax_after": {k: t.numpy() for k, t in jax_after.items()},
            "port_losses": {k: float(x) for k, x in losses.items()},
            "port_after": H._numpy(model.state_dict())}


@pytest.fixture(scope="module")
def sharded_steps(step_setup):
    s = step_setup
    runs = {}
    for data_axis, graph_axis in ((2, 1), (2, 2)):
        runs[(data_axis, graph_axis)] = spawn_ranks(
            H.sharded_step, data_axis * graph_axis,
            (graph_axis, s["art"], s["blocks"], 32, s["state"], s["batch"], s["jreg"],
             STEP_LR), timeout=TIMEOUT)
    return runs


@pytest.mark.parametrize("reference", ["port", "jax"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_sharded_step_matches_single_device(step_setup, sharded_steps, shape, reference):
    """The step on the mesh == the one-device step of the global batch: every
    loss (rtol 1e-5) and every parameter and running statistic after it
    (atol 2e-5), on every rank."""
    want_losses = step_setup[f"{reference}_losses"]
    want = step_setup[f"{reference}_after"]
    for rank, r in enumerate(sharded_steps[shape]):
        for k, w in want_losses.items():
            _close(r["losses"][k], w, rtol=1e-5, err_msg=f"rank {rank} {k}")
        assert sorted(r["state"]) == sorted(want)
        for k in want:
            _close(r["state"][k], want[k], atol=2e-5, err_msg=f"rank {rank} {k}")


def test_census_allows_no_band_sized_gather(step_setup, sharded_steps):
    """The (2, 2) step gathers band-sized activations only at the boundaries
    of its two graph-split levels: out of each in the forward (the level
    transition out of the 390-row level; the final rows, which are not band
    sized), into each in the backward (the level entries' cotangents); the
    band levels' hops move as halo tiles.  A gather elsewhere, or more than
    allowed, fails the check."""
    art = step_setup["art"]
    B_l = STEP_BATCH // 2
    threshold = band_threshold(art, B_l, 16)  # the band levels' narrowest channels
    for r in sharded_steps[(2, 2)]:
        assert r["allowed_gathers"] == 4  # two split levels, left and entered
        c = Census()
        c.records = [tuple(x) for x in r["records"]]
        assert_no_large_gather(c, threshold, allow_max=r["allowed_gathers"],
                               context="(2, 2) step")
        kinds, sites = r["census"]["by_kind"], r["census"]["by_site"]
        assert kinds["all_gather"]["count"] == 4 and kinds["halo"]["count"] > 0
        assert sites[f"all_gather @ {backward_site(LEVEL_ENTRY)} [graph]"]["count"] == 2
        bad = Census()
        bad.records = c.records + [("all_gather", "a conv", "graph", threshold, 4 * threshold)]
        with pytest.raises(AssertionError, match="outside the level transitions"):
            assert_no_large_gather(bad, threshold, allow_max=r["allowed_gathers"])
    with pytest.raises(AssertionError, match="more than the 0 allowed"):
        assert_no_large_gather(c, threshold, allow_max=0)
    # the (2, 1) step gathers nothing: the band levels stay on K1 / K2
    for r in sharded_steps[(2, 1)]:
        assert r["allowed_gathers"] == 0
        assert "all_gather" not in r["census"]["by_kind"]
        assert "halo" not in r["census"]["by_kind"]


def test_dropout_graph_ranks_agree_data_ranks_differ(step_setup):
    """Dropout 0.5 on a (2, 2) mesh: the engine's epoch generator gives graph
    ranks of one data index the same PoseNet mask and data ranks different
    ones; after a step with dropout every rank holds the same state."""
    s = step_setup
    x = np.random.default_rng(2).standard_normal((4, 14)).astype(np.float32)
    ranks = spawn_ranks(H.dropout_run, 4,
                        (x, s["art"], s["blocks"], s["state"], s["batch"], s["jreg"]),
                        timeout=TIMEOUT)
    ys = [r["posenet"] for r in ranks]
    np.testing.assert_array_equal(ys[0], ys[1])
    np.testing.assert_array_equal(ys[2], ys[3])
    assert not np.allclose(ys[0], ys[2])
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)
    assert np.isfinite(ranks[0]["losses"]["total"])


# ---- the engine ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_graph():
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    _, faces = uv_sphere(770)
    pyr = build_pyramid(faces, joint_num=H.J, skeleton=((0, 1), (1, 2), (2, 3), (3, 4),
                                                        (1, 5), (5, 6)), levels=4)
    art = pack_pyramid(pyr, faces, dense_threshold=300, device="cpu")
    assert [op.kind for op in art.mesh_ops] == ["band", "band", "dense"]
    return art, faces


def test_trainer_on_2x2_mesh_matches_1x1(tiny_graph, tmp_path):
    """Trainer.fit (one epoch, SGD, float32) on a 2 x 2 mesh == 1 x 1: the
    epoch's loss, every parameter after it, the in-epoch Tester's metrics,
    then a deploy Tester (BatchNorm folded, the halo levels' deploy convs);
    rank 0 writes the 1 x 1 run's files, the other ranks none.  Then
    LiftTrainer / LiftTester on the same mesh == 1 x 1 (loss and MPJPE rtol
    1e-5, the lifter's small tensors atol 2e-5, the large ones' digests)."""
    art, faces = tiny_graph
    cfg = H.engine_cfg(default_config, tmp_path / "single")
    cfg.TRAIN.end_epoch = 1
    cfg.TRAIN.optimizer = "sgd"
    model = Pose2Mesh(H.J, art.mesh_ops[-1].num_vertices, posenet_hidden=32,
                      blocks=H.TEST_BLOCKS, inference_fused=False, dropout=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    tr = engine.Trainer(cfg, datasets=[H.TinyDataset(8, art, faces)],
                        test_dataset=H.TinyDataset(4, art, faces, seed=1), model=model,
                        device="cpu")
    result = tr.fit()
    want_deploy = H.deploy_test(cfg, tr.model, art, faces)
    want_lift = H.lift_fit(str(tmp_path / "single" / "lift"))
    want_files = sorted(os.path.relpath(os.path.join(d, f), cfg.output_dir)
                        for d, _, fs in os.walk(cfg.output_dir) for f in fs)
    want_state = H._numpy(tr.model.state_dict())
    ranks = spawn_ranks(H.trainer_fit, 4, (2, art, faces, str(tmp_path / "mesh")),
                        timeout=TIMEOUT)
    assert ranks[0]["files"] == want_files and "checkpoint1.pth.tar" in str(want_files)
    assert all(r["files"] == [] for r in ranks[1:])
    for rank, r in enumerate(ranks):
        _close(r["train_log"], tr.train_log, rtol=1e-5, err_msg=f"rank {rank}")
        assert sorted(r["result"]) == sorted(result)
        for k, v in result.items():
            _close(r["result"][k], v, rtol=1e-5, err_msg=f"rank {rank} {k}")
        for k, v in want_state.items():
            _close(r["state"][k], v, atol=2e-5, err_msg=f"rank {rank} {k}")
        assert sorted(r["deploy"]) == sorted(want_deploy)
        for k, v in want_deploy.items():
            _close(r["deploy"][k], v, rtol=1e-5, err_msg=f"rank {rank} deploy {k}")
        got = r["lift"]
        _close(got["loss"], want_lift["loss"], rtol=1e-5, err_msg=f"rank {rank} lift loss")
        _close(got["mpjpe"], want_lift["mpjpe"], rtol=1e-5, err_msg=f"rank {rank} mpjpe")
        for k, v in want_lift["small"].items():
            _close(got["small"][k], v, atol=2e-5, err_msg=f"rank {rank} lift {k}")
        for k, v in want_lift["digest"].items():
            _close(got["digest"][k], v, rtol=1e-5, atol=1e-6, err_msg=f"rank {rank} lift {k}")
