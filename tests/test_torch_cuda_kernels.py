"""PyTorch port on the card: the CUDA kernels against their plain versions at
shapes the SMPL path does not reach (every input-channel chunk size, output
widths that are not multiples of 16 or 32, band_k in {1, 2}, row counts that
are not a multiple of the 128-row tile), the wrappers' input checks, a small
deploy MeshNet, and the training kernels' determinism (equal bits run to
run).

Needs a CUDA device; skips elsewhere.  Run on the card, without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: relative L2 error <= 1e-2 of the bf16 kernel against the plain
version computed in float32 from the same bf16 inputs.
"""
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
from pose2mesh_release_tpu_torch.models.meshnet import channel_interp_matrix
from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def band_level(k: int, V: int = 900, seed: int = 0):
    """Random symmetric operator of V rows with block-bandwidth exactly k."""
    T = 128
    bw = k * T - T // 2
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(V), 6)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=rows.shape), 0, V - 1)
    L = sp.coo_matrix((rng.standard_normal(rows.shape) * 0.15, (rows, cols)),
                      shape=(V, V))
    L = ((L + L.T) * 0.5).tolil()
    L[0, bw] = L[bw, 0] = 0.1
    op = _make_level_op(L.tocsr(), "band", T)
    assert op.band_k == k
    return op


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def inputs(op, B, shapes, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*s, generator=g, device=dev) * sc).to(torch.bfloat16)
            for s, sc in shapes]


@pytest.mark.parametrize("k,F,Fout,epilogue", [
    (1, 16, 16, "relu"),        # input chunk 16
    (1, 48, 40, "skip_add"),    # chunk 16, Fout not a multiple of 16
    (1, 32, 3, "final"),        # chunk 32, the 3-wide final conv
    (1, 64, 24, "skip_proj"),   # chunk 64
    (1, 256, 256, "skip_add"),  # chunk 64 at the widest SMPL width
    (2, 256, 128, "relu"),      # band_k 2 at F=256: chunk 32
    (2, 16, 8, "final"),
    (2, 96, 64, "skip_proj"),
])
def test_fused_cheby_conv_kernel(cuda, k, F, Fout, epilogue):
    op = band_level(k, seed=k)
    band = op.band_val.to(cuda, torch.bfloat16)
    Vp, V, B = op.padded_vertices, op.num_vertices, 3
    Fs = 2 * Fout if epilogue == "skip_proj" else Fout
    x, W, b, skip = inputs(op, B, [((Vp, B, F), 0.5),
                                   ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                   ((Fout,), 0.1), ((Vp, B, Fs), 0.5)], cuda, 1)
    kw = {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        kw["skip"] = skip
    if epilogue == "skip_proj":
        kw["skip_w"] = torch.from_numpy(
            channel_interp_matrix(Fs, Fout).T.copy()).to(cuda, torch.bfloat16)
    before = fc.launches["fused_cheby_conv"]
    y = fc.fused_cheby_conv(band, x, W, b, **kw)
    torch.cuda.synchronize()
    assert fc.launches["fused_cheby_conv"] == before + 1
    f32 = {n: (v.float() if torch.is_tensor(v) else v) for n, v in kw.items()}
    ref = fc.fused_cheby_conv_plain(band.float(), x.float(), W.float(),
                                    b.float(), **f32)
    assert y.shape == (Vp, B, Fout) and y.dtype == torch.bfloat16
    assert rel_l2(y[:V], ref[:V]) <= TOL


@pytest.mark.parametrize("k,F,Fo", [(1, 64, 32), (1, 48, 3), (2, 256, 128),
                                    (2, 32, 40)])
def test_fused_cheby_conv_commuted_kernel(cuda, k, F, Fo):
    op = band_level(k, seed=10 + k)
    band = op.band_val.to(cuda, torch.bfloat16)
    Vp, V, B = op.padded_vertices, op.num_vertices, 2
    x, Wc, b = inputs(op, B, [((Vp, B, F), 0.5),
                              ((3 * F, Fo), 1 / math.sqrt(3 * F)),
                              ((Fo,), 0.1)], cuda, 2)
    before = fc.launches["fused_cheby_conv_commuted"]
    y = fc.fused_cheby_conv_commuted(band, x, Wc, b, relu=True)
    torch.cuda.synchronize()
    assert fc.launches["fused_cheby_conv_commuted"] == before + 1
    ref = fc.fused_cheby_conv_commuted_plain(band.float(), x.float(),
                                             Wc.float(), b.float(), relu=True)
    assert y.shape == (Vp, B, Fo)
    assert rel_l2(y[:V], ref[:V]) <= TOL


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    op = band_level(1)
    band = op.band_val.to(cuda, torch.bfloat16)
    Vp = op.padded_vertices
    x, W, b = inputs(op, 2, [((Vp, 2, 32), 1.0), ((96, 32), 0.1),
                             ((32,), 0.1)], cuda, 3)
    with pytest.raises(TypeError):
        fc.fused_cheby_conv(band, x.float(), W, b, relu=True)
    with pytest.raises(ValueError):
        fc.fused_cheby_conv(band, x.transpose(1, 2).contiguous().transpose(1, 2),
                            W, b, relu=True)
    with pytest.raises(ValueError):  # F % 16 != 0
        fc.fused_cheby_conv(band, x[..., :24].contiguous(), W[:72], b,
                            relu=True)
    with pytest.raises(ValueError):
        fc.fused_cheby_conv(band, x, W, b.cpu(), relu=True)


def test_small_deploy_meshnet_kernels_vs_plain(cuda, monkeypatch):
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    from pose2mesh_release_tpu_torch.models import meshnet
    from pose2mesh_release_tpu_torch.models.meshnet import MeshNet

    w, h = 6, 260  # long strip: block-tridiagonal band levels
    faces = np.asarray([f for r in range(h - 1) for c in range(w - 1) for f in (
        (r * w + c, r * w + c + 1, (r + 1) * w + c),
        (r * w + c + 1, (r + 1) * w + c + 1, (r + 1) * w + c))], np.int64)
    pyr = build_pyramid(faces, joint_num=7,
                        skeleton=[(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)],
                        levels=4)
    art = pack_pyramid(pyr, faces, dense_threshold=100, device=cuda)
    art = art.to(cuda, torch.bfloat16)
    blocks = ((5, 16, 16), (16, 32), (32, 32), (32, 16), (16, 64, 3))
    net = MeshNet(7, art.mesh_ops[-1].num_vertices, blocks=blocks,
                  dtype=torch.bfloat16).to(cuda)
    x = torch.randn(4, 7, 5, generator=torch.Generator().manual_seed(0)).to(cuda)
    with torch.inference_mode():
        before = dict(fc.launches)
        y = net(art, x)
        n_basis = fc.launches["fused_cheby_conv"] - before["fused_cheby_conv"]
        monkeypatch.setattr(meshnet, "fused_cheby_conv", fc.fused_cheby_conv_plain)
        monkeypatch.setattr(meshnet, "fused_cheby_conv_commuted",
                            fc.fused_cheby_conv_commuted_plain)
        ref = net(art, x)
    assert n_basis > 0
    assert torch.isfinite(y).all() and y.shape == ref.shape
    assert rel_l2(y, ref) <= 2e-2


# ---- the training step's kernels ---------------------------------------------

def train_inputs(op, B, F, Fout, dev, seed):
    """x (V, B, F) at the real row count, W, b, the fold's (s, c) and an
    output cotangent g, bf16."""
    V = op.num_vertices
    x, W, b, s, c, g = inputs(op, B, [((V, B, F), 0.5),
                                      ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                      ((Fout,), 0.1), ((F,), 0.25), ((F,), 0.1),
                                      ((V, B, Fout), 1.0)], dev, seed)
    return x, W, b, (s.float() + 1.0).to(torch.bfloat16), c, g


def f32(t):
    return None if t is None else t.float()


@pytest.mark.parametrize("k,F,Fout,fold,stats", [
    (1, 16, 8, False, True),     # input chunk 16
    (1, 64, 3, True, False),     # the network's last conv: 3 outputs, no stats
    (1, 256, 256, True, True),   # the widest SMPL conv, chunk 64, two output slices
    (2, 256, 128, False, True),  # band_k 2 at F=256: chunk 32
    (2, 64, 8, True, True),
    (2, 16, 3, False, False),
])
def test_train_conv_kernel(cuda, k, F, Fout, fold, stats):
    op = band_level(k, seed=20 + k)  # 900 rows: the last tile is ragged
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, b, s, c, _ = train_inputs(op, 3, F, Fout, cuda, 4)
    in_fold = (s, c) if fold else None
    before = ft.launches["fused_cheby_conv_train"]
    out = ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold, emit_stats=stats)
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_train"] == before + 1
    ref = ft.fused_cheby_conv_train_plain(
        band.float(), x.float(), W.float(), b.float(),
        in_fold=(s.float(), c.float()) if fold else None, emit_stats=stats)
    out, ref = (out, ref) if stats else ((out,), (ref,))
    assert out[0].shape == (op.num_vertices, 3, Fout) and out[0].dtype == torch.bfloat16
    for got, want in zip(out, ref):
        assert torch.isfinite(got.float()).all()
        assert rel_l2(got, want) <= TOL


@pytest.mark.parametrize("k,F,Fout,fold", [
    (1, 16, 8, False),
    (1, 64, 3, True),
    (1, 256, 256, True),
    (2, 256, 128, False),
    (2, 64, 8, True),
    (2, 16, 3, True),
])
def test_train_bwd_kernel(cuda, k, F, Fout, fold):
    op = band_level(k, seed=30 + k)
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, _, s, c, g = train_inputs(op, 3, F, Fout, cuda, 5)
    in_fold = (s, c) if fold else None
    before = ft.launches["fused_cheby_conv_bwd"]
    got = ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold)
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_bwd"] == before + 1
    want = ft.fused_cheby_conv_bwd_plain(
        band.float(), g.float(), x.float(), W.float(),
        in_fold=(s.float(), c.float()) if fold else None)
    assert len(got) == len(want) == (5 if fold else 3)
    assert got[0].shape == x.shape and got[0].dtype == torch.bfloat16
    assert got[1].shape == (3 * F, Fout) and got[1].dtype == torch.float32
    for name, t, r in zip(("dx", "dW", "db", "ds", "dc"), got, want):
        assert torch.isfinite(t).all(), name
        assert rel_l2(t, r) <= TOL, name


def test_train_kernels_are_deterministic(cuda):
    """Cross-block sums go through per-block partials added in a fixed order:
    two runs give equal bits (stats, dx, dW, db, ds, dc)."""
    op = band_level(1, V=1849, seed=40)
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, b, s, c, g = train_inputs(op, 16, 128, 128, cuda, 6)
    runs = []
    for _ in range(2):
        y, s1, s2 = ft.fused_cheby_conv_train(band, x, W, b, in_fold=(s, c),
                                              emit_stats=True)
        runs.append((y, s1, s2) + ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=(s, c)))
    torch.cuda.synchronize()
    for name, a, b2 in zip(("y", "sum_y", "sum_y2", "dx", "dW", "db", "ds", "dc"), *runs):
        assert torch.equal(a, b2), name


def test_train_autograd_function_runs_the_fused_backward(cuda):
    """The folded, stats-emitting conv's backward is one K2 launch, equal to
    K2 on the cotangent g = gy + gs + 2 y gs2 folded in float32."""
    op = band_level(2, seed=50)
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, b, s, c, gy = train_inputs(op, 2, 32, 16, cuda, 7)
    x, W, b, s, c = (t.clone().requires_grad_() for t in (x, W, b, s, c))
    y, s1, s2 = ft.fused_cheby_project_folded_stats(band, x, W, b, s, c)
    gs = torch.linspace(-1, 1, 16, device=cuda)
    gs2 = torch.linspace(0.5, -0.5, 16, device=cuda)
    before = dict(ft.launches)
    torch.autograd.backward((y, s1, s2), (gy, gs, gs2))
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_bwd"] == before["fused_cheby_conv_bwd"] + 1
    assert ft.launches["fused_cheby_conv_train"] == before["fused_cheby_conv_train"]
    g = (gy.float() + gs + 2.0 * y.detach().float() * gs2).to(torch.bfloat16)
    want = ft.fused_cheby_conv_bwd(band, g, x.detach(), W.detach(),
                                   in_fold=(s.detach(), c.detach()))
    for name, t, r in zip(("dx", "dW", "db", "ds", "dc"),
                          (x.grad, W.grad, b.grad, s.grad, c.grad), want):
        assert torch.equal(t, r.to(t.dtype)), name


def test_train_wrappers_reject_what_the_kernels_do_not_take(cuda):
    op = band_level(1)
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, b, s, c, g = train_inputs(op, 2, 32, 16, cuda, 8)
    with pytest.raises(TypeError):  # float32 activations
        ft.fused_cheby_conv_train(band, x.float(), W, b)
    with pytest.raises(TypeError):
        ft.fused_cheby_conv_bwd(band, g.float(), x, W)
    with pytest.raises(ValueError):  # not contiguous
        ft.fused_cheby_conv_train(band, x.transpose(1, 2).contiguous().transpose(1, 2),
                                  W, b)
    with pytest.raises(ValueError):  # F % 16 != 0
        ft.fused_cheby_conv_train(band, x[..., :24].contiguous(), W[:72].contiguous(), b)
    with pytest.raises(ValueError):  # the fold on another device
        ft.fused_cheby_conv_train(band, x, W, b, in_fold=(s.cpu(), c.cpu()))
    with pytest.raises(ValueError):  # more rows than the operator's tiles
        ft.fused_cheby_conv_train(band, torch.zeros(op.padded_vertices + 1, 2, 32,
                                                    dtype=torch.bfloat16, device=cuda),
                                  W, b)
    with pytest.raises(ValueError):  # cotangent of the wrong width
        ft.fused_cheby_conv_bwd(band, g[..., :8].contiguous(), x, W)
