"""PyTorch port on the card: the CUDA kernels against their plain versions at
shapes the SMPL path does not reach (every input-channel chunk size, output
widths that are not multiples of 16 or 32, band_k in {1, 2}, row counts that
are not a multiple of the 128-row tile), the wrappers' input checks, a small
deploy MeshNet on each path, and the training kernels' determinism (equal
bits run to run).  Kernels: the group deploy convs, the training conv K1 (and
its keep_basis outputs) and its backward K2, the single hop K4, the strip
conv K5 and the window conv K6.  The hops of K4, K1, K2 and the group
deploy conv run on the banded hop engine, which skips all-zero 16 x 16 band
sub-tiles: their cases include bands shaped to break that skip (a dense band
block, single nonzeros in sub-tile corners, an all-zero row tile) and a band
whose pad columns are nonzero (K1's fold must leave the missing rows zero).
K1 and the group conv project through one GEMM whose 3-wide outputs are
computed 16 wide and stored 3 wide.  The commuted conv (one projection into
float32 a, p1 and bf16 p2, then two engine hops with a float32 add), the
strip conv (basis order: two engine hops reading the strip form, then the
projection; commuted order: one projection into bf16 [p | t0 | u], then two
hops, the last with the ReLU and the skip) and the window conv (the strip
conv's basis order at T-row tiles) also run their launches apart through
their launchers, which must give the whole call's bits; the window conv at
nt = 2k+1 makes every row tile an edge tile of the window form; the strip
conv runs at strip tiles of 64, 128 and 256 rows.  The halo hop
(`parallel.halo.halo_banded_hop`: K4 on each rank's halo-extended slab) runs
on 2 gloo ranks on cuda:0 at the hop's odd shapes, forward and VJP against
the one-device K4 (float32 within 1e-6).

Needs a CUDA device; skips elsewhere.  Run on the card, without the JAX
test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Every kernel also runs its float32 instance (nothing rounded: the hops by
exact FFMA on the float32 hop engine, csrc/band_hop_f32.cuh, the products
by 3xTF32) on the same cases: the group and commuted deploy convs, K1 (with
keep_basis), K2, the hop K4, the strip conv (both orders, every epilogue,
its launches apart) and the window conv (at nt = 2k+1 too).  The float32
hop engine's own cases: K4 at a row count not a multiple of 16 and 16, 48
and 8208 columns (a chunk masked), and a band_k 2 row tile filled dense
(lists in batches); each hop epilogue (alpha / beta / add, the ReLU, the
float32 add, the skip add and the skip projection) through the conv that
runs it, on both layouts of L, with random and dense bands, run twice to
equal bits; the halo hop at those widths.

Tolerance: relative L2 error <= 1e-2 of the bf16 kernel against the plain
version computed in float32 from the same bf16 inputs; <= 1e-5 of the
float32 instance against the plain version on the same float32 inputs,
with the plain version's products in full float32 (TF32 off).
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
from pose2mesh_release_tpu_torch.ops import hop as hp
from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
from pose2mesh_release_tpu_torch.ops import window_cheby as wc
from pose2mesh_release_tpu_torch.parallel.distributed import spawn_ranks

import torch_mesh_helpers

pytestmark = pytest.mark.cuda
TOL = 1e-2
F32_TOL = 1e-5  # the float32 instances (chip_smoke's F32_KERNEL_TOL)
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                 ids=["bf16", "f32"])


def tol(dtype) -> float:
    return F32_TOL if dtype == torch.float32 else TOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def band_level(k: int, V: int = 900, seed: int = 0, strip_h: int = 0):
    """Random symmetric operator of V rows with block-bandwidth exactly k
    (and its strip form of strip_h-row tiles)."""
    T = 128
    bw = k * T - T // 2
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(V), 6)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=rows.shape), 0, V - 1)
    L = sp.coo_matrix((rng.standard_normal(rows.shape) * 0.15, (rows, cols)),
                      shape=(V, V))
    L = ((L + L.T) * 0.5).tolil()
    L[0, bw] = L[bw, 0] = 0.1
    op = _make_level_op(L.tocsr(), "band", T, strip_h=strip_h)
    assert op.band_k == k
    return op


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def inputs(op, B, shapes, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*s, generator=g, device=dev) * sc).to(dtype) for s, sc in shapes]


@pytest.mark.parametrize("k,F,Fout,epilogue", [
    (1, 16, 16, "relu"),        # input chunk 16
    (1, 48, 40, "skip_add"),    # chunk 16, Fout not a multiple of 16
    (1, 32, 3, "final"),        # chunk 32, the 3-wide final conv
    (1, 64, 3, "final"),        # the network's last conv: 3 of a 16-column tile stored
    (1, 64, 24, "skip_proj"),   # chunk 64
    (1, 256, 256, "skip_add"),  # chunk 64 at the widest SMPL width
    (2, 256, 128, "relu"),      # band_k 2 at F=256: chunk 32
    (2, 16, 8, "final"),
    (2, 96, 64, "skip_proj"),
])
@DTYPES
def test_fused_cheby_conv_kernel(cuda, k, F, Fout, epilogue, dtype):
    op = band_level(k, seed=k)
    band = op.band_val.to(cuda, dtype)
    Vp, V, B = op.padded_vertices, op.num_vertices, 3
    Fs = 2 * Fout if epilogue == "skip_proj" else Fout
    x, W, b, skip = inputs(op, B, [((Vp, B, F), 0.5),
                                   ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                   ((Fout,), 0.1), ((Vp, B, Fs), 0.5)], cuda, 1, dtype)
    kw = {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        kw["skip"] = skip
    if epilogue == "skip_proj":
        kw["skip_w"] = torch.from_numpy(
            channel_interp_matrix(Fs, Fout).T.copy()).to(cuda, dtype)
    before = fc.launches["fused_cheby_conv"]
    y = fc.fused_cheby_conv(band, x, W, b, **kw)
    torch.cuda.synchronize()
    assert fc.launches["fused_cheby_conv"] == before + 1
    f32 = {n: (v.float() if torch.is_tensor(v) else v) for n, v in kw.items()}
    ref = fc.fused_cheby_conv_plain(band.float(), x.float(), W.float(),
                                    b.float(), **f32)
    assert y.shape == (Vp, B, Fout) and y.dtype == dtype
    assert y.untyped_storage().nbytes() == y.nbytes  # exactly (Vp, B, Fout)
    assert rel_l2(y[:V], ref[:V]) <= tol(dtype)


@pytest.mark.parametrize("k,F,Fo", [(1, 64, 32), (1, 48, 3), (2, 256, 128),
                                    (2, 32, 40),
                                    (1, 256, 40),   # Fo_pad 48: 16-column tiles
                                    (2, 64, 3)])    # Fo_pad 16, narrowed to 3
@DTYPES
def test_fused_cheby_conv_commuted_kernel(cuda, k, F, Fo, dtype):
    op = band_level(k, seed=10 + k)
    band = op.band_val.to(cuda, dtype)
    Vp, V, B = op.padded_vertices, op.num_vertices, 2
    x, Wc, b = inputs(op, B, [((Vp, B, F), 0.5),
                              ((3 * F, Fo), 1 / math.sqrt(3 * F)),
                              ((Fo,), 0.1)], cuda, 2, dtype)
    before = fc.launches["fused_cheby_conv_commuted"]
    y = fc.fused_cheby_conv_commuted(band, x, Wc, b, relu=True)
    torch.cuda.synchronize()
    assert fc.launches["fused_cheby_conv_commuted"] == before + 1
    ref = fc.fused_cheby_conv_commuted_plain(band.float(), x.float(),
                                             Wc.float(), b.float(), relu=True)
    assert y.shape == (Vp, B, Fo) and y.dtype == dtype
    assert y.untyped_storage().nbytes() == y.nbytes  # exactly (Vp, B, Fo)
    assert rel_l2(y[:V], ref[:V]) <= tol(dtype)


@pytest.mark.parametrize("k,F,Fo,relu", [(1, 64, 32, True), (2, 256, 128, False),
                                         (1, 48, 40, True), (2, 32, 3, False)])
@DTYPES
def test_commuted_launches_apart_equal_the_whole_call(cuda, k, F, Fo, relu, dtype):
    """The projection, hop 1 and hop 2 run one by one through
    commuted_launcher give the wrapper's bits (narrowed to Fo), and the pad
    columns of the intermediate output are zero."""
    op = band_level(k, seed=12 + k)
    band = op.band_val.to(cuda, dtype)
    Vp, B = op.padded_vertices, 3
    x, Wc, b = inputs(op, B, [((Vp, B, F), 0.5), ((3 * F, Fo), 1 / math.sqrt(3 * F)),
                              ((Fo,), 0.1)], cuda, 16, dtype)
    whole = fc.fused_cheby_conv_commuted(band, x, Wc, b, relu=relu)
    before = dict(fc.launches)
    run, out = fc.commuted_launcher(band, x, Wc, b, relu)
    for name in ("proj", "hop1", "hop2"):
        run(fc.COMMUTED_STAGES[name])
    torch.cuda.synchronize()
    assert fc.launches == before  # the launcher alone counts nothing
    assert out.shape == (Vp, B, -(-Fo // 16) * 16)
    assert torch.equal(out[..., :Fo], whole)
    assert not out[..., Fo:].any()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    op = band_level(1)
    band = op.band_val.to(cuda, torch.bfloat16)
    Vp = op.padded_vertices
    x, W, b = inputs(op, 2, [((Vp, 2, 32), 1.0), ((96, 32), 0.1),
                             ((32,), 0.1)], cuda, 3)
    with pytest.raises(TypeError):  # mixed dtypes
        fc.fused_cheby_conv(band, x.float(), W, b, relu=True)
    for dt in (torch.float16, torch.float64):  # no instance
        with pytest.raises(TypeError):
            fc.fused_cheby_conv(band.to(dt), x.to(dt), W.to(dt), b.to(dt), relu=True)
        with pytest.raises(TypeError):
            fc.fused_cheby_conv_commuted(band.to(dt), x.to(dt), W.to(dt), b.to(dt),
                                         relu=True)
    with pytest.raises(ValueError):
        fc.fused_cheby_conv(band, x.transpose(1, 2).contiguous().transpose(1, 2),
                            W, b, relu=True)
    with pytest.raises(ValueError):  # F % 16 != 0
        fc.fused_cheby_conv(band, x[..., :24].contiguous(), W[:72], b,
                            relu=True)
    with pytest.raises(ValueError):
        fc.fused_cheby_conv(band, x, W, b.cpu(), relu=True)


def small_deploy_net(cuda):
    """A small deploy MeshNet on a strip of triangles (block-tridiagonal band
    levels with strip forms), bf16, and its input."""
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
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
    return art, net, x


def test_small_deploy_meshnet_kernels_vs_plain(cuda, monkeypatch):
    from pose2mesh_release_tpu_torch.models import meshnet
    art, net, x = small_deploy_net(cuda)
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

def train_inputs(op, B, F, Fout, dev, seed, dtype=torch.bfloat16):
    """x (V, B, F) at the real row count, W, b, the fold's (s, c) and an
    output cotangent g, in dtype."""
    V = op.num_vertices
    x, W, b, s, c, g = inputs(op, B, [((V, B, F), 0.5),
                                      ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                      ((Fout,), 0.1), ((F,), 0.25), ((F,), 0.1),
                                      ((V, B, Fout), 1.0)], dev, seed, dtype)
    return x, W, b, (s.float() + 1.0).to(dtype), c, g


def f32(t):
    return None if t is None else t.float()


@pytest.mark.parametrize("k,F,Fout,fold,stats", [
    (1, 16, 8, False, True),     # input chunk 16
    (1, 64, 3, True, False),     # the network's last conv: 3 outputs, no stats
    (1, 128, 3, False, False),   # 3 of a 16-column projection tile stored
    (1, 256, 256, True, True),   # the widest SMPL conv, chunk 64, two output slices
    (2, 256, 128, False, True),  # band_k 2 at F=256: chunk 32
    (2, 64, 8, True, True),
    (2, 16, 3, False, False),
])
@DTYPES
def test_train_conv_kernel(cuda, k, F, Fout, fold, stats, dtype):
    op = band_level(k, seed=20 + k)  # 900 rows: the last tile is ragged
    band = op.band_val.to(cuda, dtype)
    x, W, b, s, c, _ = train_inputs(op, 3, F, Fout, cuda, 4, dtype)
    in_fold = (s, c) if fold else None
    before = ft.launches["fused_cheby_conv_train"]
    out = ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold, emit_stats=stats)
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_train"] == before + 1
    ref = ft.fused_cheby_conv_train_plain(
        band.float(), x.float(), W.float(), b.float(),
        in_fold=(s.float(), c.float()) if fold else None, emit_stats=stats)
    out, ref = (out, ref) if stats else ((out,), (ref,))
    assert out[0].shape == (op.num_vertices, 3, Fout) and out[0].dtype == dtype
    assert out[0].untyped_storage().nbytes() == out[0].nbytes  # exactly (V, B, Fout)
    for got, want in zip(out, ref):
        assert torch.isfinite(got.float()).all()
        assert rel_l2(got, want) <= tol(dtype)


@pytest.mark.parametrize("k,F,Fout,fold,kind", [
    (1, 16, 8, False, "random"),
    (1, 64, 3, True, "random"),
    (1, 256, 256, True, "random"),
    (2, 256, 128, False, "random"),
    (2, 64, 8, True, "random"),
    (2, 16, 3, True, "random"),
    (1, 64, 3, True, "dense"),       # the network's last conv with the fold
    (2, 256, 256, False, "random"),  # the widest conv at band_k 2: Wt 768 x 256
    (2, 32, 16, True, "dense"),
    (1, 48, 40, False, "corner"),
    (2, 16, 3, True, "zero_tile"),
])
@DTYPES
def test_train_bwd_kernel(cuda, k, F, Fout, fold, kind, dtype):
    op = band_level(k, seed=30 + k)
    band = shaped_band(op, kind).to(cuda, dtype)
    x, W, _, s, c, g = train_inputs(op, 3, F, Fout, cuda, 5, dtype)
    in_fold = (s, c) if fold else None
    before = ft.launches["fused_cheby_conv_bwd"]
    got = ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold)
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_bwd"] == before + 1
    want = ft.fused_cheby_conv_bwd_plain(
        band.float(), g.float(), x.float(), W.float(),
        in_fold=(s.float(), c.float()) if fold else None)
    assert len(got) == len(want) == (5 if fold else 3)
    assert got[0].shape == x.shape and got[0].dtype == dtype
    assert got[1].shape == (3 * F, Fout) and got[1].dtype == torch.float32
    for name, t, r in zip(("dx", "dW", "db", "ds", "dc"), got, want):
        assert torch.isfinite(t).all(), name
        assert rel_l2(t, r) <= tol(dtype), name


@DTYPES
def test_train_kernels_are_deterministic(cuda, dtype):
    """Cross-block sums go through per-block partials added in a fixed order:
    two runs give equal bits (stats, dx, dW, db, ds, dc)."""
    op = band_level(1, V=1849, seed=40)
    band = op.band_val.to(cuda, dtype)
    x, W, b, s, c, g = train_inputs(op, 16, 128, 128, cuda, 6, dtype)
    runs = []
    for _ in range(2):
        y, s1, s2 = ft.fused_cheby_conv_train(band, x, W, b, in_fold=(s, c),
                                              emit_stats=True)
        runs.append((y, s1, s2) + ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=(s, c)))
    torch.cuda.synchronize()
    for name, a, b2 in zip(("y", "sum_y", "sum_y2", "dx", "dW", "db", "ds", "dc"), *runs):
        assert torch.equal(a, b2), name


# the float32 GEMMs' tile edges (csrc/gemm_f32.cuh): (kernel, k, V, B, F,
# Fout, variant); V*B rows not a multiple of 128 (a ragged last tile), Fout 3
# and 16 (one 16-column tile), F 16 and 48 (K 48 and 144: ragged k-tiles),
# 128- and 256-wide outputs (128-column tiles, two of them), every epilogue
F32_GEMM_CASES = [
    ("group", 1, 900, 3, 16, 16, "relu"),
    ("group", 1, 900, 3, 48, 3, "final"),
    ("group", 2, 900, 5, 48, 16, "skip_proj"),
    ("group", 1, 900, 3, 128, 128, "skip_add"),
    ("group", 1, 900, 2, 256, 256, "relu"),
    ("commuted", 1, 900, 3, 16, 16, "relu"),
    ("commuted", 2, 900, 3, 256, 128, "relu"),
    ("strip", 1, 900, 3, 48, 16, "skip_proj"),   # commuted order: kEpiCommutedT, kEpiF32
    ("strip", 2, 900, 3, 128, 128, "skip_proj"),  # basis order with the skip projection
    ("window", 1, 900, 3, 16, 3, "final"),
    ("train", 1, 900, 3, 16, 16, "fold_stats"),
    ("train", 1, 900, 3, 48, 3, "fold"),
    ("train", 2, 900, 5, 128, 128, "stats"),
    ("train", 1, 900, 2, 256, 256, "fold_stats"),
    ("bwd", 1, 900, 3, 16, 3, "fold"),
    ("bwd", 1, 900, 3, 48, 16, "plain"),
    ("bwd", 2, 900, 5, 128, 128, "fold"),         # dx 128-column tiles
    ("bwd", 1, 900, 2, 64, 256, "plain"),         # dx 64-column tiles, G 768 wide
    ("bwd", 1, 900, 2, 256, 64, "fold"),          # dx two 128-column tiles
]


@pytest.mark.parametrize("kernel,k,V,B,F,Fout,variant", F32_GEMM_CASES,
                         ids=["-".join(map(str, c)) for c in F32_GEMM_CASES])
def test_f32_gemm_tile_edges(cuda, kernel, k, V, B, F, Fout, variant):
    """Each float32 instance through the wgmma GEMMs at a tile edge: within
    F32_TOL of its plain version on the same float32 inputs, and two runs
    equal bits."""
    dt = torch.float32
    op = band_level(k, V=V, seed=90 + k, strip_h=128)
    band = op.band_val.to(cuda, dt)
    Vp = op.padded_vertices
    if kernel in ("train", "bwd"):
        x, W, b, s, c, g = train_inputs(op, B, F, Fout, cuda, 91, dt)
        fold = (s, c) if "fold" in variant else None
        if kernel == "train":
            stats = "stats" in variant
            run = lambda: ft.fused_cheby_conv_train(band, x, W, b, in_fold=fold,  # noqa: E731
                                                    emit_stats=stats)
            ref = ft.fused_cheby_conv_train_plain(band, x, W, b, in_fold=fold, emit_stats=stats)
        else:
            run = lambda: ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=fold)  # noqa: E731
            ref = ft.fused_cheby_conv_bwd_plain(band, g, x, W, in_fold=fold)
        rows = op.num_vertices
    else:
        Fs = 2 * Fout if variant == "skip_proj" else Fout
        x, W, b, skip, skip_w = inputs(op, B, [((Vp, B, F), 0.5),
                                               ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                               ((Fout,), 0.1), ((Vp, B, Fs), 0.5),
                                               ((Fs, Fout), 1 / math.sqrt(Fs))], cuda, 92, dt)
        kw = {"relu": variant != "final"}
        if variant in ("skip_add", "skip_proj"):
            kw["skip"] = skip
        if variant == "skip_proj":
            kw["skip_w"] = skip_w
        if kernel == "group":
            run = lambda: fc.fused_cheby_conv(band, x, W, b, **kw)  # noqa: E731
            ref = fc.fused_cheby_conv_plain(band, x, W, b, **kw)
        elif kernel == "commuted":
            run = lambda: fc.fused_cheby_conv_commuted(band, x, W, b, **kw)  # noqa: E731
            ref = fc.fused_cheby_conv_commuted_plain(band, x, W, b, **kw)
        elif kernel == "strip":
            S, off = op.strip_val.to(cuda, dt), op.strip_off.to(cuda)
            kw["mode"] = sc.strip_mode(F, Fout)
            run = lambda: sc.strip_cheby_conv(S, off, 128, x, W, b, **kw)  # noqa: E731
            ref = sc.strip_cheby_conv_plain(S, off, 128, x, W, b, **kw)
        else:
            win, woff = wc.window_cat(band)
            run = lambda: wc.window_cheby_conv(win, woff, x, W, b, **kw)  # noqa: E731
            ref = wc.window_cheby_conv_plain(win, woff, x, W, b, **kw)
        rows = op.num_vertices
    first, second = run(), run()
    torch.cuda.synchronize()
    first, second, ref = ((t,) if torch.is_tensor(t) else t for t in (first, second, ref))
    assert len(first) == len(ref)
    for i, (a, a2, r) in enumerate(zip(first, second, ref)):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), i
        assert torch.equal(a, a2), i
        cut = rows if a.dim() == 3 else None
        assert rel_l2(a[:cut], r[:cut]) <= F32_TOL, i


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
    with pytest.raises(TypeError):  # float32 activations, bf16 weights
        ft.fused_cheby_conv_train(band, x.float(), W, b)
    with pytest.raises(TypeError):
        ft.fused_cheby_conv_bwd(band, g.float(), x, W)
    for dt in (torch.float16, torch.float64):  # no instance
        with pytest.raises(TypeError):
            ft.fused_cheby_conv_train(band.to(dt), x.to(dt), W.to(dt), b.to(dt))
        with pytest.raises(TypeError):
            ft.fused_cheby_conv_bwd(band.to(dt), g.to(dt), x.to(dt), W.to(dt))
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


# ---- the single hop, the strip and window convs, K1's keep_basis -------------

def shaped_band(op, kind: str, seed: int = 0) -> torch.Tensor:
    """op's band_val (CPU, float32) reshaped to break the hop engine's
    sub-tile skip: "dense" fills row tile 1's diagonal and first neighbour
    blocks (more nonzero 16 x 16 sub-tiles per warp than it keeps in
    registers); "corner" leaves row tile 1 one nonzero in the corner of three
    sub-tiles; "zero_tile" makes row tile 1 all zero; "dense_all" fills
    every block of row tile 1 (the float32 engine's lists in batches);
    "random" keeps op's."""
    band = op.band_val.float().clone()
    k = band.shape[0] // 2
    g = torch.Generator().manual_seed(seed)
    if kind == "dense":
        band[k - 1:k + 1, 1] = torch.randn(2, 128, 128, generator=g) * 0.05
    elif kind == "dense_all":
        band[:, 1] = torch.randn(2 * k + 1, 128, 128, generator=g) * 0.05
    elif kind == "corner":
        band[:, 1] = 0.0
        band[k, 1, 15, 15] = 0.7
        band[k + 1, 1, 16, 0] = -0.4
        band[k - 1, 1, 127, 127] = 0.3
    elif kind == "zero_tile":
        band[:, 1] = 0.0
    return band


@pytest.mark.parametrize("k,V,B,F,deploy,kind", [
    (1, 900, 3, 16, False, "random"),     # training layout: rows >= V read as zero
    (2, 900, 3, 48, False, "random"),     # 144 columns: chunk 16
    (1, 900, 2, 64, True, "random"),      # deploy layout at nt*T rows: chunk 64
    (2, 1849, 5, 32, True, "random"),     # 160 columns: chunk 32
    (1, 900, 1, 16, False, "dense"),      # C = 16; sub-tiles beyond the register slots
    (2, 1000, 3, 16, False, "dense"),     # C = 48, ragged V
    (1, 1000, 12, 16, False, "corner"),   # C = 192
    (2, 900, 1, 16, False, "corner"),
    (1, 900, 3, 16, False, "zero_tile"),  # C = 48
    (2, 1849, 4, 48, True, "zero_tile"),  # C = 192
    (1, 1001, 1, 16, False, "random"),    # V not a multiple of 16, C = 16
    (2, 1001, 3, 16, True, "random"),     # C = 48
    (1, 1001, 57, 144, False, "random"),  # C = 8208: the float32 engine's last chunk masked
    (2, 1001, 2, 64, False, "dense_all"),  # 640 nonzeros a row: float32 lists in batches
])
@DTYPES
def test_banded_hop_kernel(cuda, k, V, B, F, deploy, kind, dtype):
    op = band_level(k, V=V, seed=60 + k)
    band = shaped_band(op, kind).to(cuda, dtype)
    rows = op.padded_vertices if deploy else V
    x, g = inputs(op, B, [((rows, B, F), 0.5), ((rows, B, F), 1.0)], cuda, 9, dtype)
    xr = x.clone().requires_grad_()
    before = hp.launches["banded_hop"]
    y = hp.banded_hop(band, xr)
    y.backward(g)
    torch.cuda.synchronize()
    assert hp.launches["banded_hop"] == before + 2
    assert y.shape == x.shape and y.dtype == dtype
    ref = hp.hop_plain(band.float(), x.float())
    assert rel_l2(y.detach()[:V], ref[:V]) <= tol(dtype)
    assert rel_l2(xr.grad[:V], hp.hop_plain(band.float(), g.float())[:V]) <= tol(dtype)
    if kind == "zero_tile":  # the all-zero row tile gives exact zeros
        assert not y.detach()[128:256].any()
    if kind == "corner":  # row tile 1 holds three products, each exact to bf16
        assert torch.allclose(y.detach()[128:256].float(), ref[128:256], rtol=1e-2, atol=1e-3)
    if not deploy or dtype == torch.float32:
        assert torch.equal(hp.hop(band, x), y.detach())  # equal bits run to run


# the float32 hop engine's epilogues, each through a conv that runs it: (conv,
# k, strip_h, band kind).  group: z1 = L x, then alpha 2, beta -1 and the add
# (kHopAdd); k1 and k2 the same at the training layout's row count;
# commuted: the float32 add and the ReLU (kHopF32Add); strip commuted with a
# skip: the post-activation add (kHopSkipAdd) and the float32 skip
# projection (kHopSkipProj); strip basis and window: the strip layout
F32_EPILOGUE_CASES = [
    ("group", 1, 0, "random"), ("group", 2, 0, "dense_all"),
    ("k1", 1, 0, "random"), ("k2", 2, 0, "dense_all"),
    ("commuted", 1, 0, "random"), ("commuted", 2, 0, "dense_all"),
    ("strip_skip_add", 1, 64, "random"), ("strip_skip_proj", 2, 128, "random"),
    ("strip_basis", 1, 256, "random"), ("window", 2, 0, "dense_all"),
]


def f32_epilogue_case(op, conv, h, band, dev):
    """(kernel call, plain call) of one float32 conv on op."""
    Vp, V, B, F, Fout = op.padded_vertices, op.num_vertices, 3, 32, 40
    x, W, b, skip, skip_w, g = inputs(op, B, [((Vp, B, F), 0.5),
                                              ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                              ((Fout,), 0.1), ((Vp, B, Fout), 0.5),
                                              ((2 * Fout, Fout), 1 / math.sqrt(2 * Fout)),
                                              ((V, B, Fout), 1.0)], dev, 31, torch.float32)
    if conv == "group":
        return (lambda: fc.fused_cheby_conv(band, x, W, b, relu=True, skip=skip),
                lambda: fc.fused_cheby_conv_plain(band, x, W, b, relu=True, skip=skip))
    if conv == "k1":
        return (lambda: ft.fused_cheby_conv_train(band, x[:V], W, b, emit_stats=True),
                lambda: ft.fused_cheby_conv_train_plain(band, x[:V], W, b, emit_stats=True))
    if conv == "k2":
        return (lambda: ft.fused_cheby_conv_bwd(band, g, x[:V], W),
                lambda: ft.fused_cheby_conv_bwd_plain(band, g, x[:V], W))
    if conv == "commuted":
        return (lambda: fc.fused_cheby_conv_commuted(band, x, W, b, relu=True),
                lambda: fc.fused_cheby_conv_commuted_plain(band, x, W, b, relu=True))
    if conv == "window":
        win, woff = wc.window_cat(band)
        return (lambda: wc.window_cheby_conv(win, woff, x, W, b, relu=True),
                lambda: wc.window_cheby_conv_plain(win, woff, x, W, b, relu=True))
    S, off = op.strip_val.to(dev), op.strip_off.to(dev)
    mode = "basis" if conv == "strip_basis" else "commuted"
    kw = {"mode": mode, "relu": True, "skip": None if mode == "basis" else skip}
    if conv == "strip_skip_proj":
        kw.update(skip=torch.cat([skip, skip], -1), skip_w=skip_w)
    return (lambda: sc.strip_cheby_conv(S, off, h, x, W, b, **kw),
            lambda: sc.strip_cheby_conv_plain(S, off, h, x, W, b, **kw))


@pytest.mark.parametrize("conv,k,h,kind", F32_EPILOGUE_CASES,
                         ids=[f"{c}-k{k}-h{h}-{kind}" for c, k, h, kind in F32_EPILOGUE_CASES])
def test_f32_hop_engine_epilogues(cuda, conv, k, h, kind):
    """Each float32 hop epilogue on its layout, at 1001 rows (not a multiple
    of 16), with a random band or row tile 1 dense: within 1e-5 of the plain
    version (the vertex rows below V), equal bits run to run."""
    op = band_level(k, V=1001, seed=90 + k, strip_h=h)
    band = shaped_band(op, kind).to(cuda)
    run, plain = f32_epilogue_case(op, conv, h, band, cuda)
    got, again = run(), run()
    torch.cuda.synchronize()
    got, again, want = ((t if isinstance(t, tuple) else (t,)) for t in (got, again, plain()))
    for a, c, w in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, c)
        rows = op.num_vertices if a.dim() == 3 else a.shape[0]
        assert rel_l2(a[:rows], w[:rows]) <= F32_TOL


@pytest.mark.parametrize("k,h,mode,F,Fout,epilogue", [
    (1, 128, "basis", 16, 16, "relu"),
    (1, 64, "basis", 48, 40, "skip_add"),       # Fout not a multiple of 16
    (1, 128, "commuted", 64, 3, "final"),       # the 3-wide final conv
    (1, 64, "commuted", 256, 128, "relu"),
    (2, 128, "basis", 96, 64, "skip_proj"),
    (2, 64, "commuted", 128, 40, "skip_proj"),  # skip projection in the last hop
    (2, 128, "commuted", 32, 8, "skip_add"),
    (1, 256, "basis", 64, 64, "skip_add"),      # two row tiles share a strip tile
    (2, 256, "commuted", 128, 64, "relu"),
    (2, 64, "commuted", 64, 3, "final"),        # fo_pad 16 computed, 3 stored
])
@DTYPES
def test_strip_cheby_conv_kernel(cuda, k, h, mode, F, Fout, epilogue, dtype):
    op = band_level(k, seed=70 + k, strip_h=h)
    S, off = op.strip_val.to(cuda, dtype), op.strip_off.to(cuda)
    Vp, V, B = op.padded_vertices, op.num_vertices, 3
    Fs = 80 if epilogue == "skip_proj" else Fout
    x, W, b, skip, skip_w = inputs(op, B, [((Vp, B, F), 0.5),
                                           ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                           ((Fout,), 0.1), ((Vp, B, Fs), 0.5),
                                           ((Fs, Fout), 1 / math.sqrt(Fs))], cuda, 10,
                                     dtype)
    kw = {"mode": mode, "relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        kw["skip"] = skip
    if epilogue == "skip_proj":
        kw["skip_w"] = skip_w
    before = sc.launches["strip_cheby_conv"]
    y = sc.strip_cheby_conv(S, off, h, x, W, b, **kw)
    torch.cuda.synchronize()
    assert sc.launches["strip_cheby_conv"] == before + 1
    f32 = {n: (v.float() if torch.is_tensor(v) else v) for n, v in kw.items()}
    ref = sc.strip_cheby_conv_plain(S.float(), off, h, x.float(), W.float(), b.float(),
                                    **f32)
    assert y.shape == (Vp, B, Fout) and y.dtype == dtype
    assert y.untyped_storage().nbytes() == y.nbytes  # exactly (Vp, B, Fout)
    assert rel_l2(y[:V], ref[:V]) <= tol(dtype)


@pytest.mark.parametrize("k,h,mode,F,Fout,epilogue", [
    (1, 64, "basis", 64, 24, "skip_proj"),
    (2, 128, "basis", 32, 3, "final"),
    (1, 128, "commuted", 64, 32, "relu"),
    (2, 64, "commuted", 128, 40, "skip_proj"),  # four launches: the skip projection first
    (1, 256, "commuted", 48, 8, "skip_add"),
])
@DTYPES
def test_strip_launches_apart_equal_the_whole_call(cuda, k, h, mode, F, Fout, epilogue,
                                                   dtype):
    """The launches run one by one through strip_launcher (basis: the two
    hops, the projection; commuted: the projection(s), hop 1, hop 2) give the
    wrapper's bits (narrowed to Fout in commuted order), and the pad columns
    of the commuted order's output are zero."""
    op = band_level(k, seed=140 + k, strip_h=h)
    S, off = op.strip_val.to(cuda, dtype), op.strip_off.to(cuda)
    Vp, B = op.padded_vertices, 2
    Fs = 80 if epilogue == "skip_proj" else Fout
    x, W, b, skip, skip_w = inputs(op, B, [((Vp, B, F), 0.5),
                                           ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                           ((Fout,), 0.1), ((Vp, B, Fs), 0.5),
                                           ((Fs, Fout), 1 / math.sqrt(Fs))], cuda, 19,
                                     dtype)
    skip = skip if epilogue in ("skip_add", "skip_proj") else None
    skip_w = skip_w if epilogue == "skip_proj" else None
    relu = epilogue != "final"
    whole = sc.strip_cheby_conv(S, off, h, x, W, b, mode=mode, relu=relu, skip=skip,
                                skip_w=skip_w)
    before = dict(sc.launches)
    run, out = sc.strip_launcher(S, off, h, x, W, b, mode, relu, skip, skip_w)
    for mask in sc.STRIP_STAGES[mode].values():
        run(mask)
    torch.cuda.synchronize()
    assert sc.launches == before  # the launcher alone counts nothing
    assert torch.equal(out[..., :Fout], whole)
    assert out.shape == (Vp, B, Fout if mode == "basis" else -(-Fout // 16) * 16)
    assert not out[..., Fout:].any()


@pytest.mark.parametrize("k,F,Fout,epilogue", [
    (1, 16, 16, "relu"),
    (1, 48, 40, "skip_add"),
    (1, 32, 3, "final"),
    (1, 64, 24, "skip_proj"),
    (2, 256, 128, "relu"),      # band_k 2 at F=256: chunk 32
    (2, 96, 64, "skip_proj"),
])
@DTYPES
def test_window_cheby_conv_kernel(cuda, k, F, Fout, epilogue, dtype):
    op = band_level(k, seed=80 + k)
    win, woff = wc.window_cat(op.band_val.to(cuda, dtype))
    Vp, V, B = op.padded_vertices, op.num_vertices, 3
    Fs = 2 * Fout if epilogue == "skip_proj" else Fout
    x, W, b, skip = inputs(op, B, [((Vp, B, F), 0.5),
                                   ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                   ((Fout,), 0.1), ((Vp, B, Fs), 0.5)], cuda, 11, dtype)
    kw = {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        kw["skip"] = skip
    if epilogue == "skip_proj":
        kw["skip_w"] = torch.from_numpy(
            channel_interp_matrix(Fs, Fout).T.copy()).to(cuda, dtype)
    before = wc.launches["window_cheby_conv"]
    y = wc.window_cheby_conv(win, woff, x, W, b, **kw)
    torch.cuda.synchronize()
    assert wc.launches["window_cheby_conv"] == before + 1
    f32 = {n: (v.float() if torch.is_tensor(v) else v) for n, v in kw.items()}
    ref = wc.window_cheby_conv_plain(win.float(), woff, x.float(), W.float(), b.float(),
                                     **f32)
    assert y.shape == (Vp, B, Fout) and y.dtype == dtype
    assert rel_l2(y[:V], ref[:V]) <= tol(dtype)


@pytest.mark.parametrize("k,V,F,Fout,epilogue", [
    (2, 600, 128, 128, "skip_proj"),  # nt = 5 = 2k+1: every row tile an edge tile
    (2, 640, 256, 128, "relu"),
    (2, 600, 48, 40, "skip_add"),
    (1, 300, 64, 3, "final"),         # nt = 3 = 2k+1
])
@DTYPES
def test_window_cheby_conv_kernel_at_nt_2k_plus_1(cuda, k, V, F, Fout, epilogue, dtype):
    """The smallest window form: nt = 2k+1, so s_t is clamped for every tile
    and one sub-tile column maps to other x rows than on the block band."""
    op = band_level(k, V=V, seed=120 + V)
    assert op.band_val.shape[1] == 2 * k + 1
    win, woff = wc.window_cat(op.band_val.to(cuda, dtype))
    Vp, B = op.padded_vertices, 3
    Fs = 2 * Fout if epilogue == "skip_proj" else Fout
    x, W, b, skip = inputs(op, B, [((Vp, B, F), 0.5),
                                   ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                   ((Fout,), 0.1), ((Vp, B, Fs), 0.5)], cuda, 17, dtype)
    kw = {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        kw["skip"] = skip
    if epilogue == "skip_proj":
        kw["skip_w"] = torch.from_numpy(
            channel_interp_matrix(Fs, Fout).T.copy()).to(cuda, dtype)
    y = wc.window_cheby_conv(win, woff, x, W, b, **kw)
    torch.cuda.synchronize()
    f32 = {n: (v.float() if torch.is_tensor(v) else v) for n, v in kw.items()}
    ref = wc.window_cheby_conv_plain(win.float(), woff, x.float(), W.float(), b.float(),
                                     **f32)
    assert y.shape == (Vp, B, Fout) and y.dtype == dtype
    assert rel_l2(y[:V], ref[:V]) <= tol(dtype)
    # and the group conv on the block band computes the same conv
    group = fc.fused_cheby_conv(op.band_val.to(cuda, dtype), x, W, b, **kw)
    assert rel_l2(y[:V], group[:V]) <= tol(dtype)


@pytest.mark.parametrize("k,V,F,Fout,epilogue", [(1, 900, 64, 24, "skip_proj"),
                                                 (2, 600, 128, 128, "skip_add"),
                                                 (2, 900, 32, 3, "final")])
def test_window_launches_apart_equal_the_whole_call(cuda, k, V, F, Fout, epilogue):
    """The two hops and the projection run apart through window_launcher give
    the wrapper's bits."""
    op = band_level(k, V=V, seed=130 + k)
    win, woff = wc.window_cat(op.band_val.to(cuda, torch.bfloat16))
    Vp, B = op.padded_vertices, 2
    Fs = 2 * Fout if epilogue == "skip_proj" else Fout
    x, W, b, skip = inputs(op, B, [((Vp, B, F), 0.5),
                                   ((3 * F, Fout), 1 / math.sqrt(3 * F)),
                                   ((Fout,), 0.1), ((Vp, B, Fs), 0.5)], cuda, 18)
    skip_w = None if epilogue != "skip_proj" else torch.from_numpy(
        channel_interp_matrix(Fs, Fout).T.copy()).to(cuda, torch.bfloat16)
    skip = skip if epilogue in ("skip_add", "skip_proj") else None
    relu = epilogue != "final"
    whole = wc.window_cheby_conv(win, woff, x, W, b, relu=relu, skip=skip, skip_w=skip_w)
    before = dict(wc.launches)
    run, out = wc.window_launcher(win, woff, x, W, b, relu, skip, skip_w)
    for name in ("hops", "proj"):
        run(wc.WINDOW_STAGES[name])
    torch.cuda.synchronize()
    assert wc.launches == before
    assert torch.equal(out, whole)


@pytest.mark.parametrize("k,F,Fout,fold", [
    (1, 64, 32, False),
    (2, 16, 3, True),
    (1, 256, 256, True),   # two output slices: the basis is stored once
])
@DTYPES
def test_train_conv_keep_basis_kernel(cuda, k, F, Fout, fold, dtype):
    op = band_level(k, seed=90 + k)  # 900 rows: the last tile is ragged
    band = op.band_val.to(cuda, dtype)
    x, W, b, s, c, _ = train_inputs(op, 3, F, Fout, cuda, 12, dtype)
    in_fold = (s, c) if fold else None
    before = ft.launches["fused_cheby_conv_train"]
    got = ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold, keep_basis=True)
    torch.cuda.synchronize()
    assert ft.launches["fused_cheby_conv_train"] == before + 1
    want = ft.fused_cheby_conv_train_plain(
        band.float(), x.float(), W.float(), b.float(),
        in_fold=(s.float(), c.float()) if fold else None, keep_basis=True)
    assert got[1].shape == got[2].shape == x.shape
    assert got[1].dtype == got[2].dtype == dtype
    for name, t, r in zip(("y", "z1", "z2"), got, want):
        assert rel_l2(t, r) <= tol(dtype), name


def pad_column_band(op) -> torch.Tensor:
    """op's band_val (CPU, float32) with nonzero values in the band columns
    of the missing rows V .. nt*T, in every block that reaches the last row
    tile: a nonzero u on a missing row would reach z1 on real rows."""
    band = op.band_val.float().clone()
    k, nt, V = band.shape[0] // 2, band.shape[1], op.num_vertices
    g = torch.Generator().manual_seed(1)
    for d in range(k, 2 * k + 1):
        t = nt - 1 - (d - k)
        band[d, t, :, V % 128:] = torch.randn(128, 128 - V % 128, generator=g) * 0.2
    return band


@pytest.mark.parametrize("k,stats", [(1, False), (1, True), (2, False)])
@DTYPES
def test_train_conv_fold_leaves_missing_rows_zero(cuda, k, stats, dtype):
    """With the fold and c > 0, relu(x*s + c) of a missing row would be
    relu(c) > 0: on a band with nonzero pad columns it would move z1, z2 and
    y on the last real rows.  V = 900 is not a multiple of 128."""
    op = band_level(k, seed=110 + k)
    V = op.num_vertices
    assert V % 128
    band = pad_column_band(op).to(cuda, dtype)
    x, W, b, s, c, _ = train_inputs(op, 3, 64, 32, cuda, 15, dtype)
    c = (c.float().abs() + 0.5).to(dtype)
    kw = {"emit_stats": True} if stats else {"keep_basis": True}
    got = ft.fused_cheby_conv_train(band, x, W, b, in_fold=(s, c), **kw)
    torch.cuda.synchronize()
    want = ft.fused_cheby_conv_train_plain(band.float(), x.float(), W.float(), b.float(),
                                           in_fold=(s.float(), c.float()), **kw)
    last = slice((op.band_val.shape[1] - 1 - k) * 128, V)  # the rows the pad columns reach
    names = ("y", "sum_y", "sum_y2") if stats else ("y", "z1", "z2")
    for name, t, r in zip(names, got, want):
        assert rel_l2(t, r) <= tol(dtype), name
        if name not in ("sum_y", "sum_y2"):
            assert rel_l2(t[last], r[last]) <= tol(dtype), name


@pytest.mark.parametrize("k", [1, 2])
def test_unfused_conv_and_backward_on_the_card(cuda, k):
    """fused=False: 2 hop launches forward and 2 backward, no fused conv;
    its gradients agree with the fused conv's backward K2."""
    op = band_level(k, seed=100 + k)  # 900 rows: the last tile is ragged
    band = op.band_val.to(cuda, torch.bfloat16)
    x, W, b, _, _, g = train_inputs(op, 3, 32, 16, cuda, 14)
    grads = {}
    for name, kw in (("fused", {}), ("unfused", {"fused": False})):
        args = [t.clone().requires_grad_() for t in (x, W, b)]
        before = {**ft.launches, **hp.launches}
        y = ft.fused_cheby_project(band, *args, **kw)
        y.backward(g)
        torch.cuda.synchronize()
        ran = {n: c - before[n] for n, c in {**ft.launches, **hp.launches}.items()}
        want = {"fused": (1, 1, 0), "unfused": (0, 0, 4)}[name]
        assert (ran["fused_cheby_conv_train"], ran["fused_cheby_conv_bwd"],
                ran["banded_hop"]) == want, name
        grads[name] = [t.grad for t in args]
    for n, got, ref in zip(("dx", "dW", "db"), grads["unfused"], grads["fused"]):
        assert rel_l2(got, ref) <= TOL, n


@pytest.mark.parametrize("path", ["strip", "window", "unfused"])
def test_small_deploy_meshnet_paths_vs_plain(cuda, monkeypatch, path):
    """Each further path through its kernels == the same path through the
    plain versions, and == the group path (bf16)."""
    from pose2mesh_release_tpu_torch.models import meshnet
    art, net, x = small_deploy_net(cuda)
    kw = {"fused": False} if path == "unfused" else {"flat_impl": path}
    other = meshnet.MeshNet(7, art.mesh_ops[-1].num_vertices, blocks=net.blocks,
                            dtype=torch.bfloat16, **kw).to(cuda)
    other.load_state_dict(net.state_dict())
    counts = {"strip": sc.launches, "window": wc.launches, "unfused": hp.launches}[path]
    with torch.inference_mode():
        group = net(art, x)
        before = sum(counts.values())
        y = other(art, x)
        assert sum(counts.values()) > before
        if path == "unfused":
            monkeypatch.setattr(hp, "hop", hp.hop_plain)
        else:
            name = f"{path}_cheby_conv"
            monkeypatch.setattr(meshnet, name, getattr({"strip": sc, "window": wc}[path],
                                                       f"{name}_plain"))
        ref = other(art, x)
    assert torch.isfinite(y).all() and y.shape == ref.shape
    assert rel_l2(y, ref) <= 2e-2 and rel_l2(y, group) <= 2e-2


def test_strip_window_hop_wrappers_reject_what_the_kernels_do_not_take(cuda):
    op = band_level(1, strip_h=128)
    S, off = op.strip_val.to(cuda, torch.bfloat16), op.strip_off.to(cuda)
    band = op.band_val.to(cuda, torch.bfloat16)
    Vp = op.padded_vertices
    x, W, b = inputs(op, 2, [((Vp, 2, 32), 1.0), ((96, 32), 0.1), ((32,), 0.1)], cuda, 13)
    with pytest.raises(TypeError):  # float32 activations, bf16 operator and weights
        sc.strip_cheby_conv(S, off, 128, x.float(), W, b, mode="basis", relu=True)
    with pytest.raises(ValueError):  # offsets not int32
        sc.strip_cheby_conv(S, off.long(), 128, x, W, b, mode="basis", relu=True)
    with pytest.raises(ValueError):  # F % 16 != 0
        sc.strip_cheby_conv(S, off, 128, x[..., :24].contiguous(), W[:72], b,
                            mode="basis", relu=True)
    win, woff = wc.window_cat(band)
    with pytest.raises(ValueError):  # offsets on the CPU
        wc.window_cheby_conv(win, woff.cpu(), x, W, b, relu=True)
    with pytest.raises(TypeError):
        hp.hop(band, x.float())
    with pytest.raises(ValueError):  # more rows than the operator's tiles
        hp.hop(band, torch.zeros(Vp + 1, 32, dtype=torch.bfloat16, device=cuda))
    # 16-row strip tiles whose offsets spread a row tile's warps over 128
    # staged 16-row groups, more than the engine's 64: refused, no fallback
    S2 = torch.zeros(2048, 64, dtype=torch.bfloat16, device=cuda)
    off2 = torch.tensor([0] * 4 + [2048 - 64] * 4, dtype=torch.int32).repeat(2048 // 128)
    x2 = torch.zeros(2048, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        sc.strip_cheby_conv(S2, off2.to(cuda), 16, x2, W, b, mode="basis", relu=True)


# the halo hop on 2 graph ranks: (k, V, B, F) of test_banded_hop_kernel's
# random bands, both dtypes; one spawn of 2 gloo ranks on cuda:0 runs them all
HALO_CASES = [(k, V, B, F, dt) for k, V, B, F in [(1, 900, 3, 16), (2, 900, 3, 48),
                                                  (2, 1849, 5, 32), (2, 1000, 3, 16),
                                                  (1, 1001, 1, 16), (2, 1001, 57, 144)]
              for dt in ("bfloat16", "float32")]


@pytest.fixture(scope="module")
def halo_runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cases = []
    for k, V, B, F, dt in HALO_CASES:
        rng = np.random.default_rng(V + B)
        x = (rng.standard_normal((V, B, F)) * 0.5).astype(np.float32)
        g = rng.standard_normal((V, B, F)).astype(np.float32)
        cases.append((band_level(k, V=V, seed=60 + k).band_val.numpy(), x, g, dt))
    ranks = spawn_ranks(torch_mesh_helpers.halo_hops, 2, (cases, "cuda:0"), timeout=300)
    return cases, ranks


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=[f"k{k}-V{V}-B{B}-F{F}-{dt}" for k, V, B, F, dt in HALO_CASES])
def test_halo_hop_on_two_ranks_matches_k4(cuda, halo_runs, case):
    """2 graph ranks' halo hop (K4 on each slab: 3 launches a rank, the hop,
    its VJP, the hop again to equal bits) == the one-device K4 on the whole
    tensor, forward and VJP."""
    cases, ranks = halo_runs
    band, x, g, dt = cases[case]
    dtype, V = getattr(torch, dt), x.shape[0]
    band = torch.from_numpy(band).to(cuda, dtype)
    want = hp.hop(band, torch.from_numpy(x).to(cuda, dtype))
    want_dx = hp.hop(band, torch.from_numpy(g).to(cuda, dtype))
    got = [r[case] for r in ranks]
    y = torch.from_numpy(np.concatenate([r["y"] for r in got])[:V])
    dx = torch.from_numpy(np.concatenate([r["dx"] for r in got])[:V])
    tolerance = 1e-6 if dtype == torch.float32 else TOL
    assert rel_l2(y, want.cpu()) <= tolerance
    assert rel_l2(dx, want_dx.cpu()) <= tolerance
    assert all(r["launches"] == 3 and r["equal_bits"] for r in got)
