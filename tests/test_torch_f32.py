"""PyTorch port: the CPU side of the float32 instances of the group and
commuted deploy convs, K1 and K2 (csrc/, `f32` argument).

- The launch plans at 4-byte operands: the hop engine's x ring, the
  projection's and dx's tiles fit a block's 227 KB of shared memory, the
  engine keeps `_HOP_BLOCKS_PER_SM` blocks on an SM where two fit (band_k 1;
  band_k 2 takes one), the projection tiles at most 64 columns wide.  The
  bf16 plans stay value for value what they were before the float32
  instances (the table below, taken from the bf16-only plans at the SMPL
  train and deploy shapes).
- The wrappers' dtype rule (`fused_cheby.check_dtypes`): bfloat16 and
  float32 taken by these four kernels, the others bfloat16 only; float16,
  float64 and mixed dtypes refused.
- The demo computes in float32 whatever the device, as the JAX demo does,
  and decodes --input_img with PIL where matplotlib is missing, to
  matplotlib's pixels.

The float32 arithmetic itself is held against the Pallas kernels in interpret
mode (tests/test_torch_fused_cheby.py, tests/test_torch_train_kernels.py)
and against the plain versions on the card (tests/test_torch_cuda_kernels.py).
"""
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu_torch.cli import demo
from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
from pose2mesh_release_tpu_torch.ops import hop as hp

SMS = 132  # the H100's SMs
B = 64
BLOCK_SMEM = 232448  # a block's dynamic shared memory on sm_90
SM_SMEM = 233472
RESERVED = 1024 + 128
# SMPL's band levels (V, nt) and its band convs (V, fin, fout), train and deploy
NT = {6890: 56, 3475: 28, 1849: 15, 981: 8}
CONVS = [(981, 256, 256), (1849, 256, 128), (1849, 128, 128), (3475, 128, 128),
         (6890, 128, 128), (6890, 128, 64), (6890, 64, 3)]

# the bf16 plans at the SMPL shapes: hop (nt, k, C) -> (cc, grid, per_block,
# smem, items); proj (M, F, Fout) and projstats (M at the real rows) -> (bn,
# np, items, grid, smem); comm (M, F, Fo) the commuted projection; bwd (V,
# nt, k, F, Fout) -> (fo_pad, gw, fp, hop, dx_items, grid_dx, dx_smem,
# slices, slice_rows, dw_grid, dw_smem)
BF16_PLANS = {
    'hop 8 1 16384': [64,  256,  8,  110592,  2048],
    'hop 8 2 16384': [32,  256,  16,  102400,  4096],
    'proj 65536 256 256': [128,  256,  1024,  264,  56832],
    'projstats 62784 256 256': [128,  256,  982,  264,  65024],
    'comm 65536 256 256': [128,  768,  3072,  264,  56832],
    'bwd 981 8 1 256 256': [256,  768,  256,  [64,  256,  8,  110592,  2048],  1964,  396,  52736,  11,  5728,  528,  27648],
    'bwd 981 8 2 256 256': [256,  768,  256,  [32,  256,  16,  102400,  4096],  1964,  396,  52736,  11,  5728,  528,  27648],
    'hop 15 1 16384': [64,  256,  15,  110592,  3840],
    'hop 15 2 16384': [32,  256,  30,  102400,  7680],
    'proj 122880 256 128': [128,  128,  960,  264,  56832],
    'projstats 118336 256 128': [128,  128,  925,  264,  60928],
    'comm 122880 256 128': [128,  384,  2880,  264,  56832],
    'bwd 1849 15 1 256 128': [128,  384,  256,  [64,  240,  8,  110592,  1920],  3700,  396,  52736,  22,  5408,  528,  27648],
    'bwd 1849 15 2 256 128': [128,  384,  256,  [32,  256,  15,  102400,  3840],  3700,  396,  52736,  22,  5408,  528,  27648],
    'hop 15 1 8192': [64,  240,  8,  110592,  1920],
    'hop 15 2 8192': [32,  256,  15,  102400,  3840],
    'proj 122880 128 128': [128,  128,  960,  264,  56832],
    'projstats 118336 128 128': [128,  128,  925,  264,  60928],
    'comm 122880 128 128': [128,  384,  2880,  264,  56832],
    'bwd 1849 15 1 128 128': [128,  384,  128,  [64,  240,  8,  110592,  1920],  1850,  396,  48640,  44,  2720,  528,  27648],
    'bwd 1849 15 2 128 128': [128,  384,  128,  [32,  256,  15,  102400,  3840],  1850,  396,  48640,  44,  2720,  528,  27648],
    'hop 28 1 8192': [64,  256,  14,  110592,  3584],
    'hop 28 2 8192': [32,  256,  28,  102400,  7168],
    'proj 229376 128 128': [128,  128,  1792,  264,  56832],
    'projstats 222400 128 128': [128,  128,  1738,  264,  60928],
    'comm 229376 128 128': [128,  384,  5376,  264,  56832],
    'bwd 3475 28 1 128 128': [128,  384,  128,  [64,  256,  14,  110592,  3584],  3476,  396,  48640,  44,  5056,  528,  27648],
    'bwd 3475 28 2 128 128': [128,  384,  128,  [32,  256,  28,  102400,  7168],  3476,  396,  48640,  44,  5056,  528,  27648],
    'hop 56 1 8192': [64,  256,  28,  110592,  7168],
    'hop 56 2 8192': [32,  261,  55,  102400,  14336],
    'proj 458752 128 128': [128,  128,  3584,  264,  56832],
    'projstats 440960 128 128': [128,  128,  3445,  264,  60928],
    'comm 458752 128 128': [128,  384,  10752,  264,  56832],
    'bwd 6890 56 1 128 128': [128,  384,  128,  [64,  256,  28,  110592,  7168],  6890,  396,  48640,  44,  10048,  528,  27648],
    'bwd 6890 56 2 128 128': [128,  384,  128,  [32,  261,  55,  102400,  14336],  6890,  396,  48640,  44,  10048,  528,  27648],
    'proj 458752 128 64': [64,  64,  3584,  264,  44544],
    'projstats 440960 128 64': [64,  64,  3445,  264,  46592],
    'comm 458752 128 64': [64,  192,  10752,  264,  44544],
    'bwd 6890 56 1 128 64': [64,  192,  128,  [64,  256,  14,  110592,  3584],  6890,  396,  48640,  88,  5024,  528,  27648],
    'bwd 6890 56 2 128 64': [64,  192,  128,  [32,  256,  28,  102400,  7168],  6890,  396,  48640,  88,  5024,  528,  27648],
    'hop 56 1 4096': [64,  256,  14,  110592,  3584],
    'hop 56 2 4096': [32,  256,  28,  102400,  7168],
    'proj 458752 64 3': [16,  16,  3584,  264,  35328],
    'projstats 440960 64 3': [16,  16,  3445,  264,  36352],
    'comm 458752 64 3': [16,  48,  10752,  264,  35328],
    'bwd 6890 56 1 64 3': [16,  64,  64,  [64,  224,  4,  110592,  896],  3445,  396,  46592,  511,  864,  511,  27648],
    'bwd 6890 56 2 64 3': [16,  64,  64,  [32,  256,  7,  102400,  1792],  3445,  396,  46592,  511,  864,  511,  27648],
}


def _plan(key: str, esize: int = 2):
    kind, *a = key.split()
    a = [int(v) for v in a]
    if kind == "hop":
        return list(dataclasses.astuple(hp.hop_plan(a[0], hp.band_span(a[1]), a[2], SMS,
                                                    esize)))
    if kind in ("proj", "projstats"):
        return list(dataclasses.astuple(fc.proj_plan(a[0], a[1], a[2], SMS,
                                                     stats=kind == "projstats",
                                                     esize=esize)))
    if kind == "comm":
        return list(dataclasses.astuple(fc.commuted_plan(a[0], a[1], a[2], SMS,
                                                         esize=esize)))
    p = ft.bwd_plan(a[0], B, a[1], a[2], a[3], a[4], SMS, esize)
    return [p.fo_pad, p.gw, p.fp, list(dataclasses.astuple(p.hop)), p.dx_items, p.grid_dx,
            p.dx_smem, p.slices, p.slice_rows, p.dw_grid, p.dw_smem]


@pytest.mark.parametrize("kind", ["hop", "proj", "projstats", "comm", "bwd"])
def test_bf16_plans_unchanged(kind):
    """Giving the plans an element size leaves every bf16 plan as it was."""
    keys = [k for k in BF16_PLANS if k.split()[0] == kind]
    assert keys
    for key in keys:
        assert _plan(key) == BF16_PLANS[key], key


@pytest.mark.parametrize("V,fin,fout", CONVS)
@pytest.mark.parametrize("k", [1, 2])
def test_f32_plans_fit_shared_memory(V, fin, fout, k):
    """The float32 plans of one SMPL conv (deploy at Vp rows, train at V):
    every launch fits a block's shared memory; the engine stages float32 x
    in 16- or 32-column chunks, two blocks an SM at band_k 1 and one at
    band_k 2; the projection's tiles are at most 64 wide and two of its
    blocks fit an SM; dx keeps two blocks, dW's static rings stay under
    48 KB; the float32 plan never takes more columns of a chunk or a tile
    than the bf16 plan."""
    nt = NT[V]
    span = hp.band_span(k)
    for C in (B * fin, B * -(-fout // 16) * 16):
        p32, p16 = hp.hop_plan(nt, span, C, SMS, 4), hp.hop_plan(nt, span, C, SMS)
        assert p32.smem == hp.hop_smem(p32.cc, span, 4) <= BLOCK_SMEM
        assert p32.cc in (16, 32) and p32.cc <= p16.cc and C % p32.cc == 0
        blocks = SM_SMEM // (p32.smem + RESERVED)
        assert blocks >= (hp._HOP_BLOCKS_PER_SM if k == 1 else 1)
        assert p32.grid <= SMS * min(blocks, hp._HOP_BLOCKS_PER_SM)
        assert p32.grid * p32.per_block >= p32.items == nt * (C // p32.cc)
    for M, stats in ((nt * 128 * B, False), (V * B, True)):
        pp = fc.proj_plan(M, fin, fout, SMS, stats=stats, esize=4)
        assert pp.bn <= 64 and pp.np % pp.bn == 0 and pp.np >= fout
        assert pp.smem == fc.proj_smem(pp.bn, pp.np, stats, 4)
        assert fc._PROJ_BLOCKS_PER_SM * (pp.smem + RESERVED) <= SM_SMEM
    cp = fc.commuted_plan(nt * 128 * B, fin, fout, SMS, esize=4)
    assert cp.bn <= 64 and (cp.np // 3) % cp.bn == 0
    assert fc._PROJ_BLOCKS_PER_SM * (cp.smem + RESERVED) <= SM_SMEM
    bp = ft.bwd_plan(V, B, nt, k, fin, fout, SMS, 4)
    assert bp.dx_smem == ft.dx_smem(bp.fp, 4) <= BLOCK_SMEM
    assert 2 * (bp.dx_smem + RESERVED) <= SM_SMEM and bp.grid_dx <= 2 * SMS
    assert bp.dw_smem == ft.dw_smem(4) <= 48 * 1024
    assert bp.slices * bp.slice_rows >= V * B and bp.slice_rows % 32 == 0


def test_f32_smem_formulas():
    """The shared-memory formulas at 4-byte elements, as csrc computes them
    (band_hop_smem, proj_smem<float>, dx_smem<float>, the dW rings)."""
    assert hp.hop_smem(16, 24, 4) == 2 * 24 * 16 * 24 * 4
    assert hp.hop_smem(32, 40, 4) == 2 * 40 * 16 * 40 * 4
    assert fc.proj_smem(64, 128, False, 4) == 3 * (128 * 36 + 32 * 72) * 4
    assert fc.proj_smem(16, 16, True, 4) == 3 * (128 * 36 + 32 * 24) * 4 + 2 * 8 * 16 * 4
    assert ft.dx_smem(128, 4) == 3 * (128 * 36 + 32 * 72) * 4 + 8 * 128 * 4
    assert ft.dw_smem(4) == 2 * 2 * 32 * 72 * 4 and ft.dw_smem() == 2 * 3 * 32 * 72 * 2
    with pytest.raises(ValueError):
        hp.hop_plan(8, 24, 64, SMS, esize=8)
    with pytest.raises(ValueError):
        fc.proj_plan(128, 16, 16, SMS, esize=1)


def _t(dtype, n=4):
    return torch.zeros(n, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_dtype_rule_takes_bf16_and_f32(dtype):
    """The four kernels with float32 instances take either dtype, every
    operand in it; the result is that dtype."""
    got = fc.check_dtypes(fc.KERNEL_DTYPES, x=_t(dtype), band_val=_t(dtype), W=_t(dtype),
                          b=_t(dtype), fold_s=_t(dtype))
    assert got == dtype


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_dtype_rule_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fc.check_dtypes(fc.KERNEL_DTYPES, x=_t(dtype), W=_t(dtype))


@pytest.mark.parametrize("x_dt,w_dt", [(torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.float64)])
def test_kernel_dtype_rule_refuses_mixed_dtypes(x_dt, w_dt):
    with pytest.raises(TypeError, match="one dtype"):
        fc.check_dtypes(fc.KERNEL_DTYPES, x=_t(x_dt), band_val=_t(x_dt), W=_t(w_dt))


def test_bf16_only_kernels_refuse_f32():
    """The hop K4 and the strip and window convs have no float32 instance yet
    (ROADMAP Queue 2 K.4): their rule, the default, takes bfloat16 only."""
    assert fc.check_dtypes(x=_t(torch.bfloat16), W=_t(torch.bfloat16)) == torch.bfloat16
    with pytest.raises(TypeError, match="takes bfloat16, got torch.float32"):
        fc.check_dtypes(x=_t(torch.float32), W=_t(torch.float32))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_demo_computes_in_float32_on_every_device(device, monkeypatch, tmp_path):
    """cli.demo casts the graph to float32 and builds a float32 cascade,
    whatever --device says (CUDA reported available; the run stops at the
    cast, before any tensor reaches the card)."""
    from pose2mesh_release_tpu_torch.data import base
    seen = []

    class Art:
        mesh_ops = [types.SimpleNamespace(num_vertices=8)]

        def to(self, dev, dtype):
            seen.append((torch.device(dev).type, dtype))
            raise _Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(demo, "_setting", lambda joint_set: (
        types.SimpleNamespace(face=np.zeros((1, 3), np.int64)),
        types.SimpleNamespace(joint_num=17), 9, None))
    monkeypatch.setattr(base, "pyramid_for", lambda *a, **k: Art())
    np.save(tmp_path / "pose.npy", np.zeros((17, 2), np.float32))
    with pytest.raises(_Stop):
        demo.main(["--input_pose", str(tmp_path / "pose.npy"), "--device", device,
                   "--out_dir", str(tmp_path / "out")])
    assert seen == [(device, torch.float32)]


@pytest.mark.parametrize("fmt,mode", [("png", "RGB"), ("png", "RGBA"), ("jpeg", "RGB")])
def test_read_image_through_pil_equals_matplotlib(fmt, mode, monkeypatch, tmp_path):
    """With matplotlib hidden, _read_image decodes through PIL to the pixels
    matplotlib's path gives (its PNG floats scaled back to uint8, its JPEG
    bytes), the first three channels; with neither decoder it raises."""
    from PIL import Image
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (37, 53, len(mode)), dtype=np.uint8)
    path = str(tmp_path / f"img.{fmt}")
    Image.fromarray(arr, mode).save(path)
    want = demo._read_image(path)  # matplotlib's path
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.image", None)
    got = demo._read_image(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)
    if fmt == "png":
        np.testing.assert_array_equal(got, arr[..., :3])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="matplotlib or PIL"):
        demo._read_image(path)
