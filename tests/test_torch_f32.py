"""PyTorch port: the CPU side of the float32 instances of every kernel: the
group and commuted deploy convs, K1, K2, the hop K4, the strip conv K5 and
the window conv K6 (csrc/, `f32` argument).

- The launch plans at 4-byte operands: the float32 hop engine
  (csrc/band_hop_f32.cuh) in 128-column chunks (the last masked), its
  static lists within 48 KB, one chunk a block, and the band bytes its
  list pass reads (the plan's `band_bytes`); the projection's and dx's tiles
  (the float32 GEMMs on wgmma, csrc/gemm_f32.cuh: up to 128 columns, one
  block an SM) fit a block's 227 KB of shared memory, and dW's two blocks an
  SM's (tests/test_torch_f32_gemm.py holds them at every phase-14 shape).
  The bf16 plans stay value for value what they were before the float32
  instances (the table below, taken from the bf16-only plans at the SMPL
  train and deploy shapes, and at the strip and window forms' spans of
  SMPL's and MANO's band levels).  The float32 hop plans at those spans
  (K4 and the window form on the block band, the strip form at each
  level's span) hold the same invariants.
- The wrappers' dtype rule (`fused_cheby.check_dtypes`): bfloat16 and
  float32 taken by every kernel; float16, float64 and mixed dtypes refused,
  also by the K4, strip and window wrappers themselves.
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
from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
from pose2mesh_release_tpu_torch.ops import window_cheby as wc

SMS = 132  # the H100's SMs
B = 64
BLOCK_SMEM = 232448  # a block's dynamic shared memory on sm_90
SM_SMEM = 233472
RESERVED = 1024 + 128
# SMPL's band levels (V, nt) and its band convs (V, fin, fout), train and deploy
NT = {6890: 56, 3475: 28, 1849: 15, 981: 8}
CONVS = [(981, 256, 256), (1849, 256, 128), (1849, 128, 128), (3475, 128, 128),
         (6890, 128, 128), (6890, 128, 64), (6890, 64, 3)]
# SMPL's and MANO's band levels in the deploy layout, V: (nt, the strip
# form's span at 128-row strip tiles, the columns B * fin of the block-band
# hops (K4 on the unfused path, the window form), the columns of the strip
# convs (B * fin in basis order, B * fo_pad in commuted order))
PATH_LEVELS = {6890: (56, 20, (8192, 4096), (8192, 4096, 1024)),
               3475: (28, 21, (8192,), (8192,)),
               1849: (16, 24, (16384, 8192), (8192,)),
               981: (8, 20, (16384,), (16384,)),
               778: (8, 30, (16384, 8192, 4096), (8192, 4096, 1024))}
# the strip convs of both deploy forwards (fin, fout, skip width or 0)
STRIP_CONVS = [(256, 256, 0), (256, 256, 256), (256, 128, 0), (128, 128, 256),
               (128, 128, 128), (128, 64, 0), (64, 3, 0)]

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
    # the strip form (nt, span, C) at the levels' spans, the window form's
    # 24 (band_k 1) and 40 (band_k 2)
    'strip 56 20 8192': [64, 256, 28, 92160, 7168],
    'strip 56 20 4096': [64, 256, 14, 92160, 3584],
    'strip 56 20 1024': [64, 224, 4, 92160, 896],
    'strip 56 24 8192': [64, 256, 28, 110592, 7168],
    'strip 56 24 4096': [64, 256, 14, 110592, 3584],
    'strip 56 40 8192': [32, 261, 55, 102400, 14336],
    'strip 56 40 4096': [32, 256, 28, 102400, 7168],
    'strip 28 21 8192': [64, 256, 14, 96768, 3584],
    'strip 28 24 8192': [64, 256, 14, 110592, 3584],
    'strip 28 40 8192': [32, 256, 28, 102400, 7168],
    'strip 16 24 8192': [64, 256, 8, 110592, 2048],
    'strip 16 24 16384': [64, 256, 16, 110592, 4096],
    'strip 16 40 16384': [32, 256, 32, 102400, 8192],
    'strip 16 40 8192': [32, 256, 16, 102400, 4096],
    'strip 8 20 16384': [64, 256, 8, 92160, 2048],
    'strip 8 24 16384': [64, 256, 8, 110592, 2048],
    'strip 8 40 16384': [32, 256, 16, 102400, 4096],
    'strip 8 30 8192': [32, 256, 8, 76800, 2048],
    'strip 8 30 4096': [32, 256, 4, 76800, 1024],
    'strip 8 30 1024': [32, 256, 1, 76800, 256],
    'strip 8 24 8192': [64, 256, 4, 110592, 1024],
    'strip 8 24 4096': [64, 256, 2, 110592, 512],
    'strip 8 40 8192': [32, 256, 8, 102400, 2048],
    'strip 8 40 4096': [32, 256, 4, 102400, 1024],
}


def _plan(key: str, esize: int = 2):
    kind, *a = key.split()
    a = [int(v) for v in a]
    if kind == "hop":
        return list(dataclasses.astuple(hp.hop_plan(a[0], hp.band_span(a[1]), a[2], SMS,
                                                    esize)))
    if kind == "strip":
        return list(dataclasses.astuple(hp.hop_plan(a[0], a[1], a[2], SMS, esize)))
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


@pytest.mark.parametrize("kind", ["hop", "proj", "projstats", "comm", "bwd", "strip"])
def test_bf16_plans_unchanged(kind):
    """Giving the plans an element size leaves every bf16 plan as it was."""
    keys = [k for k in BF16_PLANS if k.split()[0] == kind]
    assert keys
    for key in keys:
        assert _plan(key) == BF16_PLANS[key], key


def check_f32_hop_plan(nt: int, span: int, C: int):
    """The float32 engine's plan for C columns over nt row tiles of `span`
    source groups: its chunks, its grid of one chunk a block, and the band
    bytes it reckons."""
    p = hp.hop_plan(nt, span, C, SMS, 4)
    assert isinstance(p, hp.F32HopPlan) and p.cap == hp.F32_LIST_CAP
    assert p.smem == hp.hop_f32_smem() <= 48 * 1024  # static shared memory
    assert p.cc == hp.F32_CHUNK == 128
    nch = -(-C // p.cc)
    assert p.items == nt * nch
    assert p.per_block == 1 and p.grid == p.items  # one chunk a block
    assert p.band_bytes == nt * 128 * span * 16 * 4  # the list pass: each row tile once
    return p


@pytest.mark.parametrize("V,fin,fout", CONVS)
@pytest.mark.parametrize("k", [1, 2])
def test_f32_plans_fit_shared_memory(V, fin, fout, k):
    """The float32 plans of one SMPL conv (deploy at Vp rows, train at V):
    the hop engine's plan holds its invariants (check_f32_hop_plan); the
    projection's tiles are at most 128 wide and its one block an SM fits;
    dx and dW keep one warp-specialized block an SM."""
    nt = NT[V]
    for C in (B * fin, B * -(-fout // 16) * 16):
        check_f32_hop_plan(nt, hp.band_span(k), C)
    for M, stats in ((nt * 128 * B, False), (V * B, True)):
        pp = fc.proj_plan(M, fin, fout, SMS, stats=stats, esize=4)
        assert pp.bn <= 128 and pp.np % pp.bn == 0 and pp.np >= fout
        assert pp.smem == fc.proj_smem(pp.bn, pp.np, stats, 4)
        assert fc.proj_blocks_per_sm(4) * (pp.smem + RESERVED) <= SM_SMEM
        assert pp.grid <= SMS
    cp = fc.commuted_plan(nt * 128 * B, fin, fout, SMS, esize=4)
    assert cp.bn <= 128 and (cp.np // 3) % cp.bn == 0
    assert fc.proj_blocks_per_sm(4) * (cp.smem + RESERVED) <= SM_SMEM
    bp = ft.bwd_plan(V, B, nt, k, fin, fout, SMS, 4)
    assert bp.dx_smem == ft.dx_smem(bp.fp, 4) <= BLOCK_SMEM
    assert bp.dx_smem + RESERVED <= SM_SMEM and bp.grid_dx <= SMS
    assert bp.dw_smem == ft.dw_smem(4) <= BLOCK_SMEM
    assert bp.slices * bp.slice_rows >= V * B and bp.slice_rows % 32 == 0


@pytest.mark.parametrize("V", list(PATH_LEVELS))
@pytest.mark.parametrize("form", ["band_k1", "band_k2", "strip"])
def test_f32_engine_plans_at_the_path_spans(V, form):
    """The float32 plans of the hop engine at one level of SMPL or MANO: K4
    and the window form on the block band (24 source groups at band_k 1, 40
    at band_k 2) and the strip form at the level's span hold the plan's
    invariants (check_f32_hop_plan)."""
    nt, strip_span, block_cols, strip_cols = PATH_LEVELS[V]
    span, cols = {"band_k1": (hp.band_span(1), block_cols),
                  "band_k2": (hp.band_span(2), block_cols),
                  "strip": (strip_span, strip_cols)}[form]
    for C in cols:
        check_f32_hop_plan(nt, span, C)


@pytest.mark.parametrize("fin,fout,fs", STRIP_CONVS)
def test_f32_strip_projection_plans(fin, fout, fs):
    """The strip conv's float32 projections at the SMPL 6890 level's rows:
    basis order's (proj_plan), commuted order's [p | t0 | u] and its skip
    projection (commuted_plan, 3 blocks and 1): tiles at most 128 wide, one
    block an SM."""
    M = 7168 * B
    plans = [fc.proj_plan(M, fin, fout, SMS, esize=4)]
    if sc.strip_mode(fin, fout) == "commuted":
        plans.append(fc.commuted_plan(M, fin, fout, SMS, esize=4))
        if fs:
            plans.append(fc.commuted_plan(M, fs, fout, SMS, blocks=1, esize=4))
    for pp in plans:
        assert pp.bn <= 128 and pp.np % pp.bn == 0 and pp.np >= fout
        assert fc.proj_blocks_per_sm(4) * (pp.smem + RESERVED) <= SM_SMEM


def test_f32_smem_formulas():
    """The shared-memory formulas at 4-byte elements, as csrc computes them
    (band_hop_f32_smem: 8 warps' lists of 8-byte entries and 17 row
    offsets; proj_smem<float>, dx_smem<float>, dw_smem<float>: the float32
    GEMMs' B planes and raw rings, gemm_f32_smem; bf16 dW's static rings);
    the engine's
    widest span, 64 groups, plans as any other (no x ring); C not a
    multiple of 128 masks the last chunk."""
    assert hp.hop_f32_smem() == 8 * (hp.F32_LIST_CAP * 8 + 17 * 4) == 16928
    assert hp.hop_smem(16, 24) == 2 * 24 * 16 * 24 * 2
    assert fc.proj_smem(64, 128, False, 4) == 1024 + 7 * (128 + 64) * 128
    assert fc.proj_smem(16, 16, True, 4) == 1024 + 7 * (128 + 16) * 128 + 2 * 8 * 16 * 4
    assert ft.dx_smem(128, 4) == 1024 + 6 * (128 + 128) * 128 + 2 * 8 * 128 * 4
    assert ft.dw_smem(4) == 1024 + 7 * (64 + 64) * 128 and ft.dw_smem() == 2 * 3 * 32 * 72 * 2
    widest = hp.hop_plan(8, hp.MAX_SPAN, 1024, SMS, 4)
    assert (widest.cc, widest.smem) == (128, hp.hop_f32_smem())
    assert hp.hop_plan(8, 24, 8208, SMS, 4).items == 8 * 65
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
    got = fc.check_dtypes(x=_t(dtype), band_val=_t(dtype), W=_t(dtype),
                          b=_t(dtype), fold_s=_t(dtype))
    assert got == dtype


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_kernel_dtype_rule_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fc.check_dtypes(x=_t(dtype), W=_t(dtype))


@pytest.mark.parametrize("x_dt,w_dt", [(torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.float64)])
def test_kernel_dtype_rule_refuses_mixed_dtypes(x_dt, w_dt):
    with pytest.raises(TypeError, match="one dtype"):
        fc.check_dtypes(x=_t(x_dt), band_val=_t(x_dt), W=_t(w_dt))


def _meta(dtype, *shape):
    return torch.empty(shape, dtype=dtype, device="meta")


# K4, the strip conv and the window conv on meta tensors (neither the CPU,
# whose tensors take the plain versions, nor the card): x's dtype, the other
# operands' dtype
HOP_STRIP_WINDOW = {
    "hop": lambda dx, dw: hp.hop(_meta(dw, 3, 2, 128, 128), _meta(dx, 256, 2, 16)),
    "strip": lambda dx, dw: sc.strip_cheby_conv(
        _meta(dw, 256, 128), _meta(torch.int32, 2), 128, _meta(dx, 256, 2, 16),
        _meta(dw, 48, 16), _meta(dw, 16), mode="basis", relu=True),
    "window": lambda dx, dw: wc.window_cheby_conv(
        _meta(dw, 384, 384), _meta(torch.int32, 3), _meta(dx, 384, 2, 16),
        _meta(dw, 48, 16), _meta(dw, 16), relu=True),
}


@pytest.mark.parametrize("wrapper", list(HOP_STRIP_WINDOW))
@pytest.mark.parametrize("dx,dw,error", [
    (torch.bfloat16, torch.bfloat16, "no kernel for device meta"),
    (torch.float32, torch.float32, "no kernel for device meta"),
    (torch.float16, torch.float16, "takes bfloat16 or float32, got torch.float16"),
    (torch.float32, torch.bfloat16, "one dtype"),
    (torch.bfloat16, torch.float32, "one dtype"),
], ids=["bf16", "f32", "f16", "f32-bf16", "bf16-f32"])
def test_hop_strip_window_dtype_rule(wrapper, dx, dw, error):
    """K4 and the strip and window convs take bfloat16 and float32 (the
    dtype rule passes and only the device is refused) and refuse float16
    and mixed dtypes (TypeError), as the other kernels' wrappers do."""
    with pytest.raises(ValueError if error.startswith("no kernel") else TypeError,
                       match=error):
        HOP_STRIP_WINDOW[wrapper](dx, dw)


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
