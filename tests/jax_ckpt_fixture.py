"""The JAX `.ckpt` fixture of tests/data/jax_ckpt/, written by the JAX package.

A cascade on the uv_sphere(770) pyramid (5 levels packed at dense_threshold
300: two band levels, 770 and 385 rows, whose 4 convs take the card's
kernels), PoseNet hidden 32, dropout off, BatchNorm with random affine and
running statistics, trained by the JAX package's `make_train_step` in
float32 with RMSprop:

  checkpoint1.ckpt  the JAX `save_checkpoint` of the train state after one
                    step (params, batch_stats, opt_state, step) at epoch 1;
  fixture.npz       "config" (JSON: the pyramid, the widths, lr, batch),
                    the fixed train batch ("batch/<key>") and regressor
                    ("jreg"), the eval inputs and the JAX `make_eval_step`
                    outputs of the state in the checkpoint ("eval/<key>"),
                    the losses of a second step on the same batch and the
                    variables after it ("step2/params/...",
                    "step2/batch_stats/...", flax paths).

The pyramid is packed as the CPU parity tests pack it for both packages
(the seeded Fiedler start vector, `test_torch_artifact.fixed_eigsh_start`).
Regenerate the committed files with

    python tests/jax_ckpt_fixture.py [OUT_DIR]

tests/test_torch_jax_ckpt.py regenerates them into a temporary directory
(`regenerate`) and holds the committed ones against the result.  Some
values are rounding: the biases that feed a BatchNorm have an exact
gradient of zero, which RMSprop scales up to a step of the learning rate's
size, and the eval outputs and the second step depend on those biases.  So
the files are reproducible bit for bit only from one packed pyramid and
one XLA CPU arithmetic.  The packer's Fiedler ordering (an ARPACK eigsh,
whose default start vector scipy draws afresh in every process) runs under
the seeded start vector too, and `regenerate` runs `write_fixture` in a
fresh process under PINNED_ENV (8 virtual devices, as tests/conftest.py;
XLA's Eigen pool, OpenMP, OpenBLAS and MKL at one thread) bound to one CPU,
so that no reduction splits by the machine's core count; the script, run
directly, does the same.
"""
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "jax_ckpt")
CONFIG = {
    "num_vertices": 770, "levels": 5, "dense_threshold": 300, "joint_num": 7,
    "skeleton": [[0, 1], [1, 2], [2, 3], [3, 4], [1, 5], [5, 6]],
    # band levels (770, 385) take blocks 3-5: every conv input 16 or 32 wide
    # (a narrow joint-graph output keeps the fc, and so the files, small)
    "blocks": [[5, 8, 4], [4, 16], [16, 16], [16, 32], [32, 32], [32, 16, 3]],
    "posenet_hidden": 32, "batch": 16, "eval_batch": 4, "lr": 1e-3,
    "use_edge_loss": True, "seed": 3,
}


# The environment of every regeneration (with the process bound to one CPU):
# the XLA CPU client of tests/conftest.py (8 virtual devices) with its Eigen
# thread pool off, and one thread for OpenMP, OpenBLAS and MKL, so that no
# reduction's order depends on the threads a loaded machine gives the process.
PINNED_ENV = {
    "JAX_PLATFORMS": "cpu",
    "XLA_FLAGS": "--xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false",
    "OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
}


def regenerate(out_dir: str) -> None:
    """`write_fixture(out_dir)` in a fresh Python process under PINNED_ENV."""
    env = {**os.environ, **PINNED_ENV}
    subprocess.run([sys.executable, os.path.abspath(__file__), out_dir], env=env, check=True,
                   cwd=os.path.dirname(HERE))


def flatten(tree, prefix=""):
    """Nested dicts -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def write_fixture(out_dir: str) -> None:
    """Train, evaluate and save with the JAX package into out_dir."""
    import flax.linen
    import jax
    import jax.numpy as jnp
    import pytest

    from pose2mesh_release_tpu.body.synthetic import uv_sphere
    from pose2mesh_release_tpu.core.checkpoint import save_checkpoint
    from pose2mesh_release_tpu.core.engine import _state_dict
    from pose2mesh_release_tpu.core.optim import make_preconditioner
    from pose2mesh_release_tpu.core.train import TrainState, make_eval_step, make_train_step
    from pose2mesh_release_tpu.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu.graphs.build import build_pyramid
    from pose2mesh_release_tpu.models.pose2mesh import Pose2Mesh
    from pose2mesh_release_tpu_torch.train_setup import synthetic_batch

    sys.path.insert(0, HERE)
    from test_torch_artifact import fixed_eigsh_start
    from test_torch_models import randomize_bn, to_numpy
    from test_torch_train import _NoDropout

    c = CONFIG
    os.makedirs(out_dir, exist_ok=True)
    verts, faces = uv_sphere(c["num_vertices"])
    with fixed_eigsh_start():  # the coarsening's and the packer's Fiedler vectors
        pyr = build_pyramid(faces, joint_num=c["joint_num"],
                            skeleton=[tuple(e) for e in c["skeleton"]], levels=c["levels"])
        art = pack_pyramid(pyr, faces, dense_threshold=c["dense_threshold"])
    rng = np.random.default_rng(c["seed"])
    jreg = rng.random((c["joint_num"], c["num_vertices"])).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)
    template = (verts * np.array([0.3, 0.2, 0.9])).astype(np.float32)
    batch = synthetic_batch(template, c["batch"], jreg, rng)
    eval_pose2d = rng.standard_normal((c["eval_batch"], c["joint_num"], 2)).astype(np.float32)

    blocks = tuple(tuple(b) for b in c["blocks"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _NoDropout)
        model = Pose2Mesh(num_joint=c["joint_num"], posenet_hidden=c["posenet_hidden"],
                          blocks=blocks, use_pallas=False)
        v = to_numpy(jax.jit(model.init, static_argnums=3)(
            jax.random.PRNGKey(c["seed"]), art, jnp.asarray(batch["pose2d"]), False))
        randomize_bn(v["params"], v["batch_stats"], rng)
        tx = make_preconditioner("rmsprop")
        state = TrainState.create(v, tx)
        step = jax.jit(make_train_step(model, tx, jnp.asarray(jreg)))
        jbatch = {k: jnp.asarray(b) for k, b in batch.items()}
        args = (jnp.float32(c["lr"]), jnp.bool_(c["use_edge_loss"]), jax.random.PRNGKey(0))
        state, loss1 = step(state, art, jbatch, *args)
        save_checkpoint(out_dir, 1, _state_dict(jax.device_get(state)),
                        train_log=[float(loss1["total"])], test_log={"joint": [123.5]})
        ev = jax.jit(make_eval_step(model, jnp.asarray(jreg)))(state, art,
                                                              jnp.asarray(eval_pose2d))
        state2, loss2 = step(state, art, jbatch, *args)
    arrays = {"config": np.array(json.dumps(c)), "jreg": jreg, "eval/pose2d": eval_pose2d}
    arrays.update({f"batch/{k}": b for k, b in batch.items()})
    arrays.update({f"eval/{k}": np.asarray(t)
                   for k, t in zip(("mesh_mm", "reg_pose", "pose3d"), ev)})
    arrays.update({f"step2/loss/{k}": np.asarray(t) for k, t in loss2.items()})
    arrays.update(flatten(to_numpy({"params": state2.params,
                                    "batch_stats": state2.batch_stats}), "step2/"))
    np.savez_compressed(os.path.join(out_dir, "fixture.npz"), **arrays)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else FIXTURE_DIR
    if any(os.environ.get(k) != v for k, v in PINNED_ENV.items()):
        regenerate(out)  # the same script, under the pinned thread counts
    else:
        # one CPU: every thread pool XLA sizes from the machine holds one thread
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[os.getpid() % len(cpus)]})
        sys.path.insert(0, os.path.dirname(HERE))
        import jax

        jax.config.update("jax_platforms", "cpu")
        write_fixture(out)
        for name in sorted(os.listdir(out)):
            print(name, os.path.getsize(os.path.join(out, name)), "bytes")
