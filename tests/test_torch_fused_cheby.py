"""PyTorch port: the plain versions of the two fused Chebyshev-conv kernels
against the JAX package's Pallas kernels (interpret mode), the commuted
conv's three launches emulated in plain PyTorch (float32 a and p1) against
the Pallas kernel, plus the wrapper's device rules."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from pose2mesh_release_tpu.graphs.artifact import _make_level_op as jax_level_op
from pose2mesh_release_tpu.ops.pallas_cheby import (
    fused_conv_flat, fused_conv_flat_commuted,
)
from pose2mesh_release_tpu_torch.ops import fused_cheby as fc

LANES = 128  # the JAX kernels take 128-lane-aligned channels
TOL = dict(rtol=1e-4, atol=1e-4)


def band_laplacian(k: int, nt: int = 6, T: int = 128, seed: int = 0):
    """Random symmetric operator with block-bandwidth exactly k (as
    tests/test_pallas.py::_synthetic_band_op)."""
    V = nt * T
    bw = k * T - T // 2
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(V), 4)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=rows.shape), 0, V - 1)
    vals = rng.standard_normal(rows.shape) * 0.2
    L = sp.coo_matrix((vals, (rows, cols)), shape=(V, V))
    L = ((L + L.T) * 0.5).tolil()
    L[0, bw] = L[bw, 0] = 0.1
    return L.tocsr()


def band_op(k: int):
    """band_laplacian(k) packed by the JAX packer."""
    op = jax_level_op(band_laplacian(k), "band", 128)
    assert op.band_k == k
    return op


@pytest.mark.parametrize("kind,k", [("dense", 1), ("band", 1), ("band", 2)])
def test_chebyshev_stack_matches_jax(kind, k):
    """ops.spmm (dense and band) and ops.cheby against the JAX package."""
    from pose2mesh_release_tpu.ops.cheby import chebyshev_stack as jax_cheby
    from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
    from pose2mesh_release_tpu_torch.ops.cheby import chebyshev_stack

    L = band_laplacian(k)
    x = np.random.default_rng(5).standard_normal((L.shape[0], 2, 5)).astype(np.float32)
    ref = jax_cheby(jax_level_op(L, kind, 128), jnp.asarray(x), 3)
    got = chebyshev_stack(_make_level_op(L, kind, 128), torch.from_numpy(x), 3)
    assert got.shape == (L.shape[0], 2, 15)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def pad_lanes(a: np.ndarray, axis: int = -1) -> np.ndarray:
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, LANES - a.shape[axis])
    return np.pad(a, pad)


def basis_weights(rng, fin, fout):
    """(3, fin, fout) basis blocks [W_x, W_Lx, W_cheb2] and their JAX form
    (3*128, 128), zero-padded per block."""
    W3 = (rng.standard_normal((3, fin, fout)) * 0.1).astype(np.float32)
    return W3, pad_lanes(pad_lanes(W3, 1), 2).reshape(3 * LANES, LANES)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("epilogue", ["relu", "skip_add", "skip_proj", "final"])
def test_fused_cheby_conv_plain_matches_pallas(k, epilogue):
    op = band_op(k)
    nt, V = op.band_val.shape[1], op.num_vertices
    Vp, B, F = nt * 128, 2, 32
    Fout = 3 if epilogue == "final" else 48
    Fs = 64 if epilogue == "skip_proj" else Fout
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((Vp, B, F)) * 0.3).astype(np.float32)
    W3, Wj = basis_weights(rng, F, Fout)
    b = (rng.standard_normal(Fout) * 0.1).astype(np.float32)
    skip = (rng.standard_normal((Vp, B, Fs)) * 0.3).astype(np.float32)
    skip_w = (rng.standard_normal((Fs, Fout)) * 0.1).astype(np.float32)

    kw, tkw = {"relu": epilogue != "final"}, {}
    if epilogue == "skip_add":
        kw["skip"] = jnp.asarray(pad_lanes(skip).reshape(Vp, -1))
        tkw["skip"] = torch.from_numpy(skip)
    elif epilogue == "skip_proj":
        kw["skip"] = jnp.asarray(pad_lanes(skip).reshape(Vp, -1))
        kw["skip_w"] = jnp.asarray(pad_lanes(pad_lanes(skip_w, 0), 1))
        tkw = {"skip": torch.from_numpy(skip), "skip_w": torch.from_numpy(skip_w)}
    elif epilogue == "final":
        kw["out_3d"] = True
    ref = fused_conv_flat(op, jnp.asarray(pad_lanes(x).reshape(Vp, -1)), B,
                          jnp.asarray(Wj), jnp.asarray(pad_lanes(b)), **kw)
    ref = np.asarray(ref).reshape(Vp, B, LANES)[:V, :, :Fout]

    band = torch.tensor(np.asarray(op.band_val))
    got = fc.fused_cheby_conv_plain(
        band, torch.from_numpy(x), torch.from_numpy(W3.reshape(3 * F, Fout)),
        torch.from_numpy(b), relu=kw["relu"], **tkw)
    assert got.shape == (Vp, B, Fout) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_cheby_conv_commuted_plain_matches_pallas(k, relu):
    op = band_op(k)
    nt, V = op.band_val.shape[1], op.num_vertices
    Vp, B, F, Fo = nt * 128, 4, 64, 32
    rng = np.random.default_rng(10 + k)
    x = (rng.standard_normal((Vp, B, F)) * 0.3).astype(np.float32)
    W3 = (rng.standard_normal((3, F, Fo)) * 0.1).astype(np.float32)
    Wc = np.concatenate([W3[0] - W3[2], W3[1], W3[2]])      # (3F, Fo)
    b = (rng.standard_normal(Fo) * 0.1).astype(np.float32)

    Wcj = pad_lanes(Wc.reshape(3, F, Fo), 1).reshape(3 * LANES, Fo)
    ref = fused_conv_flat_commuted(op, jnp.asarray(pad_lanes(x).reshape(Vp, -1)),
                                   B, jnp.asarray(Wcj), jnp.asarray(b), relu=relu)
    ref = np.asarray(ref).reshape(Vp, B, Fo)[:V]

    got = fc.fused_cheby_conv_commuted_plain(
        torch.tensor(np.asarray(op.band_val)), torch.from_numpy(x),
        torch.from_numpy(Wc), torch.from_numpy(b), relu=relu)
    assert got.shape == (Vp, B, Fo)
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


def commuted_stages(band_val, x, Wc, b, *, relu: bool, dt) -> torch.Tensor:
    """The commuted conv as its three launches on the card compute it
    (csrc/fused_cheby_commuted.cu), in plain PyTorch with operands rounded to
    dt: the projection over (Vp*B, F) rows into three blocks of fo_pad
    columns (`commuted_plan`), a = x (W0 - W2) + b and p1 = x W1 in float32,
    p2 = x W2 rounded; the hops over (Vp, B*fo_pad): t = dt(2 L p2 + p1), then
    y = dt(act(L t + a)); narrowed to Fo."""
    from pose2mesh_release_tpu_torch.ops.spmm import band_hop
    Vp, B, Fin = x.shape
    Fo = Wc.shape[1]
    fo_pad = fc.commuted_plan(Vp * B, Fin, Fo, 132).np // 3
    pad = torch.nn.functional.pad
    W = pad(Wc.to(dt).float(), (0, fo_pad - Fo))
    bias = pad(b.to(dt).float(), (0, fo_pad - Fo))
    band = band_val.to(dt)
    rows = x.to(dt).float().reshape(Vp * B, Fin)
    a = (rows @ W[:Fin] + bias).reshape(Vp, B * fo_pad)
    p1 = (rows @ W[Fin:2 * Fin]).reshape(Vp, B * fo_pad)
    p2 = (rows @ W[2 * Fin:]).to(dt).reshape(Vp, B * fo_pad)
    t = (2.0 * band_hop(band, p2) + p1).to(dt)
    y = band_hop(band, t) + a
    if relu:
        y = torch.relu(y)
    return y.to(dt).reshape(Vp, B, fo_pad)[..., :Fo]


def commuted_case(k, Fo, seed):
    """(op, x, Wc, b) numpy f32 for the commuted conv at F = 64 and a batch
    the Pallas kernel's lane packing takes (a multiple of 128 / Fo)."""
    op = band_op(k)
    Vp, B, F = op.band_val.shape[1] * 128, max(4, 128 // Fo), 64
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((Vp, B, F)) * 0.3).astype(np.float32)
    W3 = (rng.standard_normal((3, F, Fo)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(Fo) * 0.1).astype(np.float32)
    return op, x, np.concatenate([W3[0] - W3[2], W3[1], W3[2]]), b


def pallas_commuted(op, x, Wc, b, relu):
    Vp, B, F = x.shape
    Fo = Wc.shape[1]
    Wcj = pad_lanes(Wc.reshape(3, F, Fo), 1).reshape(3 * LANES, Fo)
    ref = fused_conv_flat_commuted(op, jnp.asarray(pad_lanes(x).reshape(Vp, -1)),
                                   B, jnp.asarray(Wcj), jnp.asarray(b), relu=relu)
    return np.asarray(ref).reshape(Vp, B, Fo)[:op.num_vertices]


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("Fo", [8, 32])  # 8: padded to a 16-column block, narrowed
def test_commuted_stages_match_pallas(k, relu, Fo):
    """The three-launch design, in float32, equals the Pallas kernel at the
    parity tolerance."""
    op, x, Wc, b = commuted_case(k, Fo, 20 + k + Fo)
    got = commuted_stages(torch.tensor(np.asarray(op.band_val)), torch.from_numpy(x),
                          torch.from_numpy(Wc), torch.from_numpy(b), relu=relu,
                          dt=torch.float32)
    assert got.shape == (x.shape[0], x.shape[1], Fo)
    np.testing.assert_allclose(got[:op.num_vertices].numpy(),
                               pallas_commuted(op, x, Wc, b, relu), **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_commuted_stages_in_bf16(k):
    """In bf16 (the card's working type) the three launches round where the
    plain version does: within 2e-3 relative L2 of it, and within 1e-2 (the
    card's kernel tolerance) of the Pallas kernel in float32 on the same
    bf16-rounded inputs."""
    op, x, Wc, b = commuted_case(k, 32, 30 + k)
    band = torch.tensor(np.asarray(op.band_val)).to(torch.bfloat16)
    xt, Wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, Wc, b))
    got = commuted_stages(band, xt, Wt, bt, relu=True, dt=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    V = op.num_vertices
    plain = fc.fused_cheby_conv_commuted_plain(band, xt, Wt, bt, relu=True)

    def rel(a, r):
        return float((a.float() - r.float()).norm() / r.float().norm())

    assert rel(got[:V], plain[:V]) <= 2e-3
    ref = pallas_commuted(op, xt.float().numpy(), Wt.float().numpy(), bt.float().numpy(),
                          True)
    assert rel(got[:V], torch.from_numpy(ref)) <= 1e-2


def test_commuted_form_equals_basis_form():
    """The commuted kernel computes the same conv as the basis kernel."""
    op = band_op(1)
    band = torch.tensor(np.asarray(op.band_val))
    Vp, B, F, Fo = band.shape[1] * 128, 2, 32, 16
    g = torch.Generator().manual_seed(0)
    x = torch.randn(Vp, B, F, generator=g, dtype=torch.float32)
    W3 = torch.randn(3, F, Fo, generator=g, dtype=torch.float32) * 0.1
    b = torch.randn(Fo, generator=g, dtype=torch.float32)
    y = fc.fused_cheby_conv_plain(band, x, W3.reshape(3 * F, Fo), b, relu=True)
    Wc = torch.cat([W3[0] - W3[2], W3[1], W3[2]])
    yc = fc.fused_cheby_conv_commuted_plain(band, x, Wc, b, relu=True)
    torch.testing.assert_close(yc, y, rtol=1e-4, atol=1e-4)


def test_cpu_tensors_take_the_plain_path():
    op = band_op(1)
    band = torch.tensor(np.asarray(op.band_val))
    Vp, B, F, Fo = band.shape[1] * 128, 2, 16, 16
    g = torch.Generator().manual_seed(1)
    x = torch.randn(Vp, B, F, generator=g)
    W = torch.randn(3 * F, Fo, generator=g) * 0.1
    b = torch.randn(Fo, generator=g)
    before = dict(fc.launches)
    y = fc.fused_cheby_conv(band, x, W, b, relu=True, skip=x)
    torch.testing.assert_close(
        y, fc.fused_cheby_conv_plain(band, x, W, b, relu=True, skip=x),
        rtol=0, atol=0)
    yc = fc.fused_cheby_conv_commuted(band, x, W, b, relu=False)
    torch.testing.assert_close(
        yc, fc.fused_cheby_conv_commuted_plain(band, x, W, b, relu=False),
        rtol=0, atol=0)
    assert fc.launches == before  # no kernel launched
    with pytest.raises(ValueError):
        fc.fused_cheby_conv(band, x[:-1], W, b, relu=True)


def test_entry_points_without_device_need_cuda():
    """Without device=, entry points ask for CUDA and raise where it is
    absent; nothing silently runs on the CPU."""
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    from pose2mesh_release_tpu_torch.core.train import make_eval_step
    from pose2mesh_release_tpu_torch.device import resolve_device
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh

    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    _, faces = uv_sphere(770)
    pyr = build_pyramid(faces, joint_num=3, skeleton=[(0, 1), (1, 2)], levels=4)
    blocks = ((5, 8), (8, 8), (8, 8), (8, 8), (8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        pack_pyramid(pyr, faces, dense_threshold=300)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pose2Mesh(3, 96, posenet_hidden=8, blocks=blocks)
    model = Pose2Mesh(3, 96, posenet_hidden=8, blocks=blocks, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_step(model, np.ones((3, 770), np.float32))
