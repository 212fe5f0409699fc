"""PyTorch port: the single banded hop (K4), the unfused conv and backward of
the JAX package's A/B switches, and K1's keep_basis outputs, against the JAX
package (Pallas in interpret mode), CPU f32.

  * `ops.hop.banded_hop` values and gradient == jax.grad of the JAX
    `banded_hop` (`_hop_call`), on synthetic band operators with band_k in
    {1, 2} and on the packed uv_sphere level of 770 rows in 8 tiles (rows
    >= V read as zero);
  * `fused_cheby_project(..., fused=False)` == the JAX `fused_cheby_project`
    under P2M_FUSED=0, values and gradients;
  * `fused_cheby_project`'s one backward (the fused backward K2) == the JAX
    one under P2M_BWD_FUSED=0 (the two-hop backward), gradients;
  * `fused_cheby_conv_train(..., keep_basis=True)` == `_fused_call(...,
    keep_basis=True)`, with and without the fold.

The JAX switches are read when a function is traced: every JAX call here
traces afresh after `jax.clear_caches()`.  Tolerance rtol 1e-4 (values) and
rtol 1e-3 (gradients, as tests/test_torch_train_kernels.py) in float32; the
gradients' atol is 1e-6 of their largest entry (dW entries reach ~60 as sums
over ~1.5k rows, summed in another order on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.ops import pallas_cheby as pc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
from pose2mesh_release_tpu_torch.ops import hop as hp

from test_torch_train_kernels import OPS, inputs

B, F, FOUT = 2, 16, 8
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL = 1e-3


def close_grad(got, want, name):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=1e-6 * float(np.abs(want).max()), err_msg=name)


def band(op) -> torch.Tensor:
    return torch.tensor(np.asarray(op.band_val))


@pytest.mark.parametrize("op_name", sorted(OPS))
def test_banded_hop_matches_pallas(op_name):
    op = OPS[op_name]()
    V = op.num_vertices
    rng = np.random.default_rng(1)
    x = rng.standard_normal((V, B, F)).astype(np.float32)
    g = rng.standard_normal((V, B, F)).astype(np.float32)
    jax.clear_caches()

    def ref(v, c):
        y, vjp = jax.vjp(lambda u: pc.banded_hop(op, u), v)
        return y, vjp(c)[0]

    want, want_gx = jax.jit(ref)(jnp.asarray(x), jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    got = hp.banded_hop(band(op), xt)
    (got_gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert got.shape == (V, B, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_gx.numpy(), np.asarray(want_gx), **TOL)


def test_hop_wrapper_on_the_cpu_takes_the_plain_version():
    op = OPS["k1"]()
    x = torch.randn(op.padded_vertices, 3, 16, generator=torch.Generator().manual_seed(0))
    before = dict(hp.launches)
    got = hp.hop(band(op), x)
    torch.testing.assert_close(got, hp.hop_plain(band(op), x), rtol=0, atol=0)
    assert hp.launches == before
    assert torch.equal(hp.banded_hop(op_from_torch(op), x), got)
    with pytest.raises(ValueError):  # more rows than the operator's tiles
        hp.hop(band(op), torch.zeros(op.padded_vertices + 1, 2))
    with pytest.raises(ValueError):  # not a band operator
        hp.banded_hop(band(op)[:2], x)


def op_from_torch(op):
    """The port's LevelOperator of the JAX operator's band."""
    from pose2mesh_release_tpu_torch.graphs.artifact import LevelOperator
    return LevelOperator(band_val=band(op), kind="band", num_vertices=op.num_vertices,
                         band_k=op.band_k)


def _jax_project_grads(op, a, env, monkeypatch):
    """Value and (dx, dW, db) of sum(y * g) for the JAX fused_cheby_project
    under the environment `env`, traced afresh."""
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    jax.clear_caches()

    def loss(x, W, b):
        y = pc.fused_cheby_project(op, x, W, b)
        return (y * jnp.asarray(a["g"])).sum(), y

    (_, y), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(a["x"]), jnp.asarray(a["W"]), jnp.asarray(a["b"]))
    return np.asarray(y), [np.asarray(t) for t in grads]


def _port_project_grads(op, a, **kw):
    args = [torch.from_numpy(a[n]).requires_grad_() for n in ("x", "W", "b")]
    y = ft.fused_cheby_project(band(op), *args, **kw)
    grads = torch.autograd.grad((y * torch.from_numpy(a["g"])).sum(), args)
    return y.detach().numpy(), [t.numpy() for t in grads]


def _inputs(op, seed):
    a = inputs(op.num_vertices, seed)
    a["g"] = np.random.default_rng(seed + 1).standard_normal(
        (op.num_vertices, B, FOUT)).astype(np.float32)
    return a


@pytest.mark.parametrize("op_name", sorted(OPS))
def test_unfused_project_matches_jax(op_name, monkeypatch):
    """fused=False == P2M_FUSED=0: two hops and three float32-accumulated
    projections, values and gradients; it launches no fused conv."""
    op = OPS[op_name]()
    a = _inputs(op, seed=40)
    y_j, g_j = _jax_project_grads(op, a, {"P2M_FUSED": "0"}, monkeypatch)
    before = dict(ft.launches)
    y_t, g_t = _port_project_grads(op, a, fused=False)
    assert ft.launches == before
    np.testing.assert_allclose(y_t, y_j, **TOL)
    for name, got, want in zip(("dx", "dW", "db"), g_t, g_j):
        close_grad(got, want, name)


@pytest.mark.parametrize("op_name", sorted(OPS))
def test_fused_backward_matches_jax_unfused_backward(op_name, monkeypatch):
    """The port keeps one backward for the plain-input conv: its gradients
    equal the JAX package's under P2M_BWD_FUSED=0 (two hops of the
    cotangent, one K=3 concatenated dW product, one gx product)."""
    op = OPS[op_name]()
    a = _inputs(op, seed=50)
    y_j, g_j = _jax_project_grads(op, a, {"P2M_BWD_FUSED": "0"}, monkeypatch)
    y_t, g_t = _port_project_grads(op, a)
    np.testing.assert_allclose(y_t, y_j, **TOL)
    for name, got, want in zip(("dx", "dW", "db"), g_t, g_j):
        close_grad(got, want, name)


@pytest.mark.parametrize("op_name", ["k1", "k2", "sphere770"])
@pytest.mark.parametrize("fold", [False, True])
def test_keep_basis_matches_pallas(op_name, fold):
    """K1 with keep_basis: (y, z1, z2) == `_fused_call(keep_basis=True)`."""
    op = OPS[op_name]()
    a = inputs(op.num_vertices, seed=60 + fold)
    in_fold = (jnp.asarray(a["s"]), jnp.asarray(a["c"])) if fold else None
    jax.clear_caches()
    want = pc._fused_call(op.band_val, jnp.asarray(a["x"]), jnp.asarray(a["W"]),
                          jnp.asarray(a["b"]), op.block_size, keep_basis=True,
                          in_fold=in_fold)
    tf = (torch.from_numpy(a["s"]), torch.from_numpy(a["c"])) if fold else None
    got = ft.fused_cheby_conv_train(band(op), torch.from_numpy(a["x"]),
                                    torch.from_numpy(a["W"]), torch.from_numpy(a["b"]),
                                    in_fold=tf, keep_basis=True)
    assert len(got) == len(want) == 3
    assert got[1].shape == got[2].shape == (op.num_vertices, B, F)
    for name, t, j in zip(("y", "z1", "z2"), got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=name)


def test_keep_basis_and_stats_exclude_each_other():
    op = OPS["k1"]()
    a = {k: torch.from_numpy(v) for k, v in inputs(op.num_vertices, seed=3).items()}
    with pytest.raises(ValueError):
        ft.fused_cheby_conv_train(band(op), a["x"], a["W"], a["b"], emit_stats=True,
                                  keep_basis=True)
