"""PyTorch port on the card: the two CUDA kernels against their plain
versions at shapes the SMPL path does not reach (every input-channel chunk
size, output widths that are not multiples of 16 or 32, band_k in {1, 2}),
the wrapper's input checks, and a small deploy MeshNet.

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
