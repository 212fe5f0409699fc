"""PyTorch port: the strip (K5) and window (K6) deploy convs' plain versions
against the JAX package's Pallas kernels `fused_conv_flat_strip` and
`fused_conv_flat_window` (interpret mode), CPU f32, plus `window_cat`, the
flat_impl routing and the wrappers' CPU rules.

Operators: the synthetic band of tests/test_pallas.py:129 (768 rows at
band_k 1 and 2) in the strip form of 64- and 128-row tiles.  Every epilogue
(ReLU, skip add, skip projection, the final conv without ReLU) in both strip
orders.  Tolerance rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose2mesh_release_tpu.graphs.artifact import _make_level_op as jax_level_op
from pose2mesh_release_tpu.ops.pallas_strip import fused_conv_flat_strip
from pose2mesh_release_tpu.ops.pallas_window import _window_cat, fused_conv_flat_window
from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
from pose2mesh_release_tpu_torch.ops import window_cheby as wc
from pose2mesh_release_tpu_torch.models.meshnet import flat_route

from test_torch_fused_cheby import band_laplacian

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
EPILOGUES = ("relu", "skip_add", "skip_proj", "final")


def level(k: int, strip_h: int = 128):
    """(JAX operator, port operator) of band_laplacian(k)."""
    L = band_laplacian(k)
    return (jax_level_op(L, "band", 128, strip_h=strip_h),
            _make_level_op(L, "band", 128, strip_h=strip_h))


def conv_inputs(Vp, F, Fo, epilogue, seed):
    """numpy inputs, the JAX wrapper's keywords (flat layout) and the port's."""
    rng = np.random.default_rng(seed)
    Fs = 24 if epilogue == "skip_proj" else Fo
    x = (rng.standard_normal((Vp, B, F)) * 0.3).astype(np.float32)
    W = (rng.standard_normal((3 * F, Fo)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(Fo) * 0.1).astype(np.float32)
    skip = (rng.standard_normal((Vp, B, Fs)) * 0.3).astype(np.float32)
    skip_w = (rng.standard_normal((Fs, Fo)) * 0.1).astype(np.float32)
    jkw, tkw = {"relu": epilogue != "final"}, {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        jkw["skip"] = jnp.asarray(skip.reshape(Vp, -1))
        tkw["skip"] = torch.from_numpy(skip)
    if epilogue == "skip_proj":
        jkw["skip_w"] = jnp.asarray(skip_w)
        tkw["skip_w"] = torch.from_numpy(skip_w)
    if epilogue == "final":
        jkw["out_3d"] = True
    return x, W, b, jkw, tkw


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("strip_h", [64, 128])
@pytest.mark.parametrize("mode", ["basis", "commuted"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_strip_conv_plain_matches_pallas(k, strip_h, mode, epilogue, monkeypatch):
    op_j, op_t = level(k, strip_h)
    Vp, V = op_t.padded_vertices, op_t.num_vertices
    assert op_t.strip_h == strip_h and op_t.strip_val.shape[1] < (2 * k + 1) * 128
    F, Fo = (32, 48) if mode == "basis" else (48, 16)
    assert sc.strip_mode(F, Fo) == mode
    x, W, b, jkw, tkw = conv_inputs(Vp, F, Fo, epilogue, seed=k + strip_h)
    monkeypatch.setenv("P2M_STRIP_MODE", mode)
    ref = fused_conv_flat_strip(op_j, jnp.asarray(x.reshape(Vp, -1)), B, jnp.asarray(W),
                                jnp.asarray(b), **jkw)
    ref = np.asarray(ref).reshape(Vp, B, Fo)[:V]

    Wt = torch.from_numpy(W)
    if mode == "commuted":  # the wrapper takes the commuted weights formed
        W3 = Wt.reshape(3, F, Fo)
        Wt = torch.cat([W3[0] - W3[2], W3[1], W3[2]])
    got = sc.strip_cheby_conv(op_t.strip_val, op_t.strip_off, strip_h,
                              torch.from_numpy(x), Wt, torch.from_numpy(b), mode=mode,
                              **tkw)
    assert got.shape == (Vp, B, Fo) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_window_conv_plain_matches_pallas(k, epilogue):
    op_j, op_t = level(k)
    Vp, V = op_t.padded_vertices, op_t.num_vertices
    x, W, b, jkw, tkw = conv_inputs(Vp, 32, 48, epilogue, seed=10 + k)
    ref = fused_conv_flat_window(op_j, jnp.asarray(x.reshape(Vp, -1)), B,
                                 jnp.asarray(W), jnp.asarray(b), **jkw)
    ref = np.asarray(ref).reshape(Vp, B, 48)[:V]
    win, woff = wc.window_cat(op_t.band_val)
    got = wc.window_cheby_conv(win, woff, torch.from_numpy(x), torch.from_numpy(W),
                               torch.from_numpy(b), **tkw)
    assert got.shape == (Vp, B, 48)
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_window_cat_matches_jax(k):
    """The sliding-window form equals the JAX `_window_cat` (its shifted edge
    tiles included), and its offsets are the JAX kernel's s_j."""
    op_j, op_t = level(k)
    win, woff = wc.window_cat(op_t.band_val)
    np.testing.assert_array_equal(win.numpy(), np.asarray(_window_cat(op_j.band_val, 128)))
    nt, T = op_t.band_val.shape[1], 128
    want = np.clip(np.arange(nt) * T - k * T, 0, nt * T - (2 * k + 1) * T)
    np.testing.assert_array_equal(woff.numpy(), want)


def test_flat_route_follows_the_jax_dispatch():
    _, op = level(1)
    assert [flat_route(op, i) for i in ("group", "strip", "window")] == \
        ["group", "strip", "window"]
    no_strip = _make_level_op(band_laplacian(1), "band", 128, strip_h=0)
    assert flat_route(no_strip, "strip") == "group"
    small = _make_level_op(band_laplacian(2, nt=4), "band", 128)  # nt 4 < 2k+1
    assert small.band_val.shape[1] < 5 and flat_route(small, "window") == "group"
    with pytest.raises(ValueError):
        flat_route(op, "strips")


def test_cpu_tensors_take_the_plain_path():
    _, op = level(1, 64)
    Vp = op.padded_vertices
    g = torch.Generator().manual_seed(0)
    x = torch.randn(Vp, B, 16, generator=g)
    W, b = torch.randn(48, 16, generator=g) * 0.1, torch.randn(16, generator=g)
    before = (dict(sc.launches), dict(wc.launches))
    y = sc.strip_cheby_conv(op.strip_val, op.strip_off, 64, x, W, b, mode="basis",
                            relu=True, skip=x)
    torch.testing.assert_close(y, sc.strip_cheby_conv_plain(
        op.strip_val, op.strip_off, 64, x, W, b, mode="basis", relu=True, skip=x),
        rtol=0, atol=0)
    win, woff = wc.window_cat(op.band_val)
    yw = wc.window_cheby_conv(win, woff, x, W, b, relu=False)
    torch.testing.assert_close(yw, wc.window_cheby_conv_plain(win, woff, x, W, b,
                                                              relu=False), rtol=0, atol=0)
    assert (dict(sc.launches), dict(wc.launches)) == before
    with pytest.raises(ValueError):  # unknown mode
        sc.strip_cheby_conv(op.strip_val, op.strip_off, 64, x, W, b, mode="auto",
                            relu=True)
    with pytest.raises(ValueError):  # offsets of another tile height
        sc.strip_cheby_conv(op.strip_val, op.strip_off, 128, x, W, b, mode="basis",
                            relu=True)
    with pytest.raises(ValueError):  # skip-add of another width
        wc.window_cheby_conv(win, woff, x, W[:, :8], b[:8], relu=True, skip=x)
