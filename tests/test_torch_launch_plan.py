"""PyTorch port: the launch plans of the banded hop engine (K4, and the two
hops of K1, K2, the group, commuted, strip and window deploy convs), of the
three-operand projection GEMM (K1, the group, strip and window deploy
convs), of the commuted convs' one-operand projection and of the fused
training backward K2, computed on the CPU for a card of 132 SMs (an H100
SXM).  The engine's ring is sized from the 16-row groups a row tile stages:
(2k+1) T rows of the block band, the union of its warps' source groups for
the strip form (at most 64, the bits of the engine's mask).

At every shape of the unfused deploy path (the hop of each SMPL band conv,
batch 64), of the group deploy path and of the train path (K1 and K2 of each
SMPL training conv, batch 64), plus band_k = 2 levels and odd widths: each
block's shared memory fits the 232,448 bytes a block may use on sm_90, the
engine and the projection keep two blocks on an SM where they claim to, and
the work items of every launch cover every row and column exactly once.
"""
import numpy as np
import pytest

from pose2mesh_release_tpu_torch.graphs.artifact import strip_offset
from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
from pose2mesh_release_tpu_torch.ops import hop as hp

SMS = 132
MAX_SMEM = 232448
SM_SMEM = 233472
T = 128
BATCH = 64
# (V, nt) of the SMPL band levels
LEVELS = {6890: 56, 3475: 28, 1849: 16, 981: 8}
# the unfused deploy path's hops: (V, input channels) per conv, two hops each
UNFUSED_HOPS = [(981, 256), (981, 256), (1849, 256), (1849, 128), (3475, 128),
                (3475, 128), (6890, 128), (6890, 128), (6890, 128), (6890, 64)]
# the train path's K2: (V, Fin, Fout)
TRAIN_CONVS = [(981, 256, 256), (981, 256, 256), (1849, 256, 128), (1849, 128, 128),
               (3475, 128, 128), (3475, 128, 128), (6890, 128, 128), (6890, 128, 128),
               (6890, 128, 64), (6890, 64, 3)]
# the group deploy forward's band convs at the padded rows: (V, Fin, Fout),
# the 8 basis-order convs, then the 2 commuted convs' widths
DEPLOY_CONVS = [(981, 256, 256), (1849, 128, 128), (3475, 128, 128), (6890, 128, 128),
                (6890, 64, 3), (1849, 256, 128), (6890, 128, 64)]


def cdiv(a, b):
    return -(-a // b)


def check_hop_plan(p: hp.HopPlan, V: int, nt: int, span: int, C: int):
    """span: the 16-row groups a row tile stages."""
    assert C % p.cc == 0 and p.cc in (16, 32, 64)
    assert p.smem == hp.hop_smem(p.cc, span) <= MAX_SMEM
    assert p.items == nt * (C // p.cc)
    assert p.grid <= 2 * SMS
    # block b walks items [b * per_block, min(items, (b + 1) * per_block)):
    # every item once, no block empty
    assert p.grid * p.per_block >= p.items > (p.grid - 1) * p.per_block
    covered = [0] * p.items
    for blk in range(p.grid):
        for it in range(blk * p.per_block, min(p.items, (blk + 1) * p.per_block)):
            covered[it] += 1
    assert set(covered) == {1}
    # items (row tile, chunk), t-major: every row tile and every column once
    nch = C // p.cc
    cols = sorted((it % nch) * p.cc for it in range(nch))
    assert cols == list(range(0, C, p.cc))
    assert {it // nch for it in range(p.items)} == set(range(nt))
    assert nt * T >= V


@pytest.mark.parametrize("V,F", sorted(set(UNFUSED_HOPS)))
def test_hop_plan_at_the_unfused_path_shapes(V, F):
    nt, C = LEVELS[V], BATCH * F
    p = hp.hop_plan(nt, hp.band_span(1), C, SMS)
    check_hop_plan(p, V, nt, hp.band_span(1), C)
    assert p.cc == 64  # the widest chunk keeps two blocks on an SM
    assert 2 * (p.smem + 1152) <= SM_SMEM


@pytest.mark.parametrize("C", [16, 48, 144, 160, 192, 8192, 16384])
@pytest.mark.parametrize("k", [1, 2])
def test_hop_plan_at_odd_widths_and_band_k_2(k, C):
    V, nt = 3475, 28
    p = hp.hop_plan(nt, hp.band_span(k), C, SMS)
    check_hop_plan(p, V, nt, hp.band_span(k), C)
    assert 2 * (p.smem + 1152) <= SM_SMEM  # two blocks on an SM at every width


def test_hop_plan_rejects_what_the_engine_does_not_take():
    with pytest.raises(ValueError):  # C % 16 != 0
        hp.hop_plan(8, hp.band_span(1), 24, SMS)
    with pytest.raises(ValueError):  # band_k 3
        hp.hop_plan(8, hp.band_span(3), 64, SMS)
    with pytest.raises(ValueError):  # more staged groups than the mask's 64 bits
        hp.hop_plan(8, hp.MAX_SPAN + 1, 64, SMS)


@pytest.mark.parametrize("V,k,Fin,Fout", [(V, 1, fi, fo) for V, fi, fo in sorted(set(TRAIN_CONVS))]
                         + [(3475, 2, 128, 128), (3475, 2, 256, 256), (900, 2, 16, 3)])
def test_bwd_plan_at_the_train_path_shapes(V, k, Fin, Fout):
    nt = LEVELS.get(V, cdiv(V, T))
    p = ft.bwd_plan(V, BATCH, nt, k, Fin, Fout, SMS)
    M = V * BATCH
    # channels: g padded to fo_pad, the three K-blocks inside gw, F inside fp
    assert p.fo_pad % 16 == 0 and Fout <= p.fo_pad < Fout + 16
    assert p.gw % 64 == 0 and 3 * p.fo_pad <= p.gw < 3 * p.fo_pad + 64
    assert p.fp % 64 == 0 and Fin <= p.fp < Fin + 64
    # the two hops over (V, B * fo_pad)
    check_hop_plan(p.hop, V, nt, hp.band_span(k), BATCH * p.fo_pad)
    # dx: 128 x 64 tiles over (M, fp), a persistent grid-stride walk
    assert p.dx_items == cdiv(M, 128) * (p.fp // 64)
    assert 0 < p.grid_dx <= p.dx_items and p.dx_smem == ft.dx_smem(p.fp) <= MAX_SMEM
    # dW: row slices cover the M rows once, every (f tile, column tile) each
    assert p.slice_rows % 32 == 0
    assert p.slices * p.slice_rows >= M > (p.slices - 1) * p.slice_rows
    assert p.dw_grid == (p.fp // 64) * (p.gw // 64) * p.slices
    assert p.dw_smem <= 48 * 1024  # static shared memory


def test_bwd_plan_copies_g_only_for_narrow_outputs():
    """fo_pad equals Fout at every train-path width but the last conv's 3."""
    pads = {fo: ft.bwd_plan(6890, BATCH, 56, 1, 64, fo, SMS).fo_pad for fo in (3, 64, 128, 256)}
    assert pads == {3: 16, 64: 64, 128: 128, 256: 256}


def check_proj_plan(p: fc.ProjPlan, M: int, F: int, Fout: int, stats: bool):
    assert p.bn in (16, 32, 64, 128)
    # W padded to np columns: Fout rounded up to 16, then to the tile width
    fo_pad = cdiv(Fout, 16) * 16
    assert p.np % p.bn == 0 and fo_pad <= p.np < fo_pad + p.bn
    assert p.items == cdiv(M, 128) * (p.np // p.bn)
    assert 0 < p.grid <= min(p.items, 2 * SMS)
    assert p.smem == fc.proj_smem(p.bn, p.np, stats) <= MAX_SMEM
    assert 2 * (p.smem + 1024) <= SM_SMEM  # two blocks on an SM
    # the grid-stride walk: every (128-row, bn-column) tile once, m-major
    nn = p.np // p.bn
    seen = [0] * p.items
    for blk in range(p.grid):
        for w in range(blk, p.items, p.grid):
            seen[w] += 1
    assert set(seen) == {1}
    rows = {(w // nn) * 128 for w in range(p.items)}
    assert rows == set(range(0, M, 128))
    assert {(w % nn) * p.bn for w in range(p.items)} == set(range(0, p.np, p.bn))


@pytest.mark.parametrize("V,k,Fin,Fout,stats",
                         [(V, 1, fi, fo, fo != 3) for V, fi, fo in sorted(set(TRAIN_CONVS))]
                         + [(3475, 2, 128, 128, True), (900, 2, 16, 3, False)])
def test_train_conv_plans_at_the_train_path_shapes(V, k, Fin, Fout, stats):
    """K1: the two hops over (V, B * Fin) and the projection over V * B rows
    (with the statistics epilogue where the train step asks for it)."""
    nt = LEVELS.get(V, cdiv(V, T))
    span = hp.band_span(k)
    check_hop_plan(hp.hop_plan(nt, span, BATCH * Fin, SMS), V, nt, span, BATCH * Fin)
    M = V * BATCH
    check_proj_plan(fc.proj_plan(M, Fin, Fout, SMS, stats=stats), M, Fin, Fout, stats)


@pytest.mark.parametrize("V,Fin,Fout", DEPLOY_CONVS + [(3475, 128, 128)])
def test_proj_plan_at_the_group_deploy_shapes(V, Fin, Fout):
    """The group conv's projection over the padded nt*T*B rows."""
    nt = LEVELS[V]
    M = nt * T * BATCH
    p = fc.proj_plan(M, Fin, Fout, SMS)
    check_proj_plan(p, M, Fin, Fout, False)
    assert p.grid == 2 * SMS  # every SMPL level has tiles for a full grid


@pytest.mark.parametrize("Fout", [3, 8, 24, 40, 64, 96, 200, 256])
@pytest.mark.parametrize("F", [16, 48])
@pytest.mark.parametrize("stats", [False, True])
def test_proj_plan_at_odd_widths(F, Fout, stats):
    M = 900 * 3
    check_proj_plan(fc.proj_plan(M, F, Fout, SMS, stats=stats), M, F, Fout, stats)


def test_proj_plan_pads_the_three_wide_output_to_one_16_column_tile():
    p = fc.proj_plan(6890 * BATCH, 64, 3, SMS)
    assert (p.bn, p.np) == (16, 16)
    with pytest.raises(ValueError):  # F % 16 != 0
        fc.proj_plan(900, 24, 16, SMS)


# the group deploy forward's two commuted convs (V, Fin, Fout), and the
# band_k = 2 level's
COMMUTED_CONVS = [(1849, 256, 128), (6890, 128, 64)]


def check_commuted_plan(p: fc.ProjPlan, M: int, F: int, Fo: int):
    """[a | p1 | p2]: three blocks of fo_pad columns, each tile in one block."""
    fo_pad = cdiv(Fo, 16) * 16
    assert p.np == 3 * fo_pad
    assert p.bn in (16, 32, 64, 128) and fo_pad % p.bn == 0
    assert p.bn == max(b for b in (16, 32, 64, 128) if fo_pad % b == 0)  # the widest
    assert p.items == cdiv(M, 128) * (p.np // p.bn)
    assert 0 < p.grid <= min(p.items, 2 * SMS)
    assert p.smem == fc.proj_smem(p.bn, p.np, False) <= MAX_SMEM
    assert 2 * (p.smem + 1024) <= SM_SMEM  # two blocks on an SM
    nn = p.np // p.bn
    seen = [0] * p.items
    for blk in range(p.grid):
        for w in range(blk, p.items, p.grid):
            seen[w] += 1
    assert set(seen) == {1}
    # every tile's columns in one block s, which reads W's rows sF .. (s+1)F
    blocks = {}
    for n in range(nn):
        n0 = n * p.bn
        s = n0 // fo_pad
        assert (n0 + p.bn - 1) // fo_pad == s
        blocks.setdefault(s, []).append(n0 - s * fo_pad)
    assert sorted(blocks) == [0, 1, 2]
    assert all(sorted(v) == list(range(0, fo_pad, p.bn)) for v in blocks.values())


@pytest.mark.parametrize("V,k,Fin,Fout", [(V, 1, fi, fo) for V, fi, fo in COMMUTED_CONVS]
                         + [(3475, 2, 256, 128)])
def test_commuted_plans_at_the_group_deploy_shapes(V, k, Fin, Fout):
    """The commuted conv: its projection over the padded nt*T*B rows, and its
    two hops over B * fo_pad columns (fo_pad = Fout on the SMPL convs)."""
    nt = LEVELS[V]
    M = nt * T * BATCH
    p = fc.commuted_plan(M, Fin, Fout, SMS)
    check_commuted_plan(p, M, Fin, Fout)
    assert (p.bn, p.np, p.grid) == (Fout, 3 * Fout, 2 * SMS)
    span = hp.band_span(k)
    check_hop_plan(hp.hop_plan(nt, span, BATCH * Fout, SMS), V, nt, span, BATCH * Fout)


@pytest.mark.parametrize("Fo", [3, 8, 24, 40, 48, 96, 200, 256])
@pytest.mark.parametrize("F", [16, 48])
def test_commuted_plan_at_odd_widths(F, Fo):
    M = 7 * T * 3
    p = fc.commuted_plan(M, F, Fo, SMS)
    check_commuted_plan(p, M, F, Fo)
    fo_pad = p.np // 3
    span = hp.band_span(1)
    check_hop_plan(hp.hop_plan(7, span, 3 * fo_pad, SMS), 7 * T, 7, span, 3 * fo_pad)


def test_commuted_plan_pads_narrow_outputs_to_16_columns():
    assert [fc.commuted_plan(900, 48, fo, SMS).np // 3 for fo in (3, 40, 64, 128)] == \
        [16, 48, 64, 128]
    with pytest.raises(ValueError):  # F % 16 != 0
        fc.commuted_plan(900, 24, 16, SMS)


# the strip path's band convs (V, Fin, Fout), in basis or commuted order by
# the JAX rule (commuted where the conv narrows), and each SMPL level's scalar
# bandwidth: the strip form's width is h + 2 bw rounded up to 16
STRIP_CONVS = [(981, 256, 256), (1849, 256, 128), (1849, 128, 128), (3475, 128, 128),
               (6890, 128, 128), (6890, 128, 64), (6890, 64, 3)]
BANDWIDTH = {6890: 89, 3475: 104, 1849: 127, 981: 90}


def strip_layout(V: int, h: int) -> hp.HopLayout:
    nt = LEVELS[V]
    Vp, W = nt * T, cdiv(h + 2 * BANDWIDTH[V], 16) * 16
    return hp.hop_layout(nt, off=strip_offset(np.arange(Vp // h), h, W, Vp), h=h, wd=W)


@pytest.mark.parametrize("h", [64, 128, 256])
@pytest.mark.parametrize("V,Fin,Fout", STRIP_CONVS)
def test_strip_plans_at_the_strip_deploy_shapes(V, Fin, Fout, h):
    """The strip conv at strip_h 64, 128 and 256: the engine's ring holds
    the staged span (one strip tile's W / 16 groups where h is a multiple of
    T, the union of two tiles' windows at h = 64, never over the window
    form's 24 groups below h = 256), its two hops cover every row tile and
    column with two blocks on an SM (64-column chunks up to the window
    form's span), and the projection's plan is the group conv's (basis
    order) or the commuted conv's."""
    lay = strip_layout(V, h)
    nt, W = lay.nt, lay.ld
    span = lay.span
    assert span <= hp.MAX_SPAN
    if h % T == 0:
        assert span == W // 16
    else:
        assert W // 16 < span <= 24
    M = nt * T * BATCH
    if Fout < Fin:  # commuted order: the hops on fo_pad columns
        p = fc.commuted_plan(M, Fin, Fout, SMS)
        check_commuted_plan(p, M, Fin, Fout)
        C = BATCH * (p.np // 3)
    else:
        check_proj_plan(fc.proj_plan(M, Fin, Fout, SMS), M, Fin, Fout, False)
        C = BATCH * Fin
    p = hp.hop_plan(nt, span, C, SMS)
    check_hop_plan(p, V, nt, span, C)
    assert 2 * (p.smem + 1152) <= SM_SMEM  # two blocks on an SM
    assert p.cc == (64 if span <= 24 else 32)  # 64 columns fit the window form's ring


def test_hop_plan_refuses_a_strip_span_over_64_groups():
    """Offsets that spread one row tile's warps over more than 64 staged
    16-row groups: the layout names the span, hop_plan refuses it; offsets
    that are not non-decreasing multiples of 16 apart within a row tile have
    no layout."""
    nt, h, W = 2, 16, 64
    off = np.tile([0] * 4 + [1024] * 4, nt)  # warps 4-7 of each row tile read rows 1024 ..
    lay = hp.hop_layout(nt, off=off, h=h, wd=W)
    assert lay.staged(0) == (0, 1024 // 16 + W // 16) and lay.span > hp.MAX_SPAN
    with pytest.raises(ValueError):
        hp.hop_plan(nt, lay.span, 64, SMS)
    with pytest.raises(ValueError):  # offsets of one row tile 8 rows apart
        hp.hop_layout(nt, off=off // 128, h=h, wd=W)
    with pytest.raises(ValueError):  # offsets falling within a row tile
        hp.hop_layout(nt, off=off[::-1].copy(), h=h, wd=W)


@pytest.mark.parametrize("Fs,Fo", [(80, 40), (256, 128), (32, 3)])
def test_skip_projection_plan_is_one_block(Fs, Fo):
    """The strip conv's skip projection in commuted order (kEpiF32): one
    column block of fo_pad, the widest tile dividing it."""
    M = 7 * T * 3
    p = fc.commuted_plan(M, Fs, Fo, SMS, blocks=1)
    fo_pad = cdiv(Fo, 16) * 16
    assert p.np == fo_pad and fo_pad % p.bn == 0
    assert p.bn == max(b for b in (16, 32, 64, 128) if fo_pad % b == 0)
    assert p.items == cdiv(M, 128) * (fo_pad // p.bn) and 0 < p.grid <= 2 * SMS
    assert p.smem == fc.proj_smem(p.bn, p.np, False) <= MAX_SMEM
