"""PyTorch port: the CPU side of the float32 GEMMs on wgmma (csrc/gemm_f32.cuh:
the float32 projection of K1, the group, commuted, strip and window convs,
and K2's float32 dx and dW).

- The operand split (`ops.gemm_f32.tf32_split`, the kernels' cvt.rna.tf32):
  big and small are TF32 values (the low 13 mantissa bits zero), big is x
  rounded to nearest with ties away from zero, and big + small = x within
  2^-22 of |x|.
- The sum order (`tf32x3_matmul`: per 32-deep k-tile a float32 partial of
  the three products of each k8 step, then one IEEE add) is held within
  1e-6 relative L2 of a float64 product at the main path's depths and a
  ragged one, the error budget under the card's 1e-5; one TF32 product
  alone misses it.
- The plan mirrors (`proj_plan`, `commuted_plan`, `proj_smem`, `bwd_plan`,
  `dx_smem`, `dw_smem`) at every float32 shape of chip_smoke phase 14
  (MAIN_PATH_CONVS, TRAIN_CONVS, K2_TRAIN_CONV), of MANO and of the JAX
  .ckpt fixture's widths: a block's shared memory at most 232,448 bytes,
  tiles of 128 (dW 64) rows and widths a multiple of 8, one block an SM;
  the shapes the kernels refuse raise.
- The planes' 128-byte swizzle (`plane_offset`): each 8-row atom a
  permutation of its 64 chunks, and the split pass's stores (row by row,
  and transposed) free of bank conflicts.

The kernels themselves run only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py phase 14).
"""
import math

import numpy as np
import pytest

import chip_smoke as cs
from pose2mesh_release_tpu_torch.ops import fused_cheby as fc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft
from pose2mesh_release_tpu_torch.ops import gemm_f32 as gf
from pose2mesh_release_tpu_torch.ops import strip_cheby as sc

SMS = 132  # the H100's SMs
BLOCK_SMEM = 232448  # a block's dynamic shared memory on sm_90
SM_SMEM = 233472
RESERVED = 1024 + 128
BUDGET = 1e-6  # the sum order's error against float64


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _case(kind: str, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "wide":  # exponents from 2^-100 to 2^100, both signs
        return (rng.choice([-1.0, 1.0], n) * 2.0 ** rng.uniform(-100, 100, n)).astype(np.float32)
    # ties: the 13 dropped bits exactly half of a TF32 ulp
    return ((rng.integers(0x3F000000, 0x40800000, n, dtype=np.uint32) & np.uint32(0xFFFFE000))
            | np.uint32(0x1000)).view(np.float32) * rng.choice([-1.0, 1.0], n).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "wide", "ties"])
def test_tf32_split_is_exact_to_2_pow_minus_22(kind):
    x = _case(kind)
    big, small = gf.tf32_split(x)
    assert not (_bits(big) & 0x1FFF).any() and not (_bits(small) & 0x1FFF).any()
    err = np.abs(big.astype(np.float64) + small.astype(np.float64) - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    # big is x to nearest TF32, ties away from zero
    lo = (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)
    hi = ((_bits(x) & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32)
    dlo, dhi = np.abs(x - lo.astype(np.float64)), np.abs(hi.astype(np.float64) - x)
    want = np.where(dhi <= dlo, hi, lo)
    assert np.array_equal(_bits(big), _bits(want))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# depths K of the float32 products: 48 (K2's dx at Fout 3 or 16: a ragged
# k-tile), 96 (the fixture's 32-wide convs), 192 / 384 / 768 (the projections
# at F 64 / 128 / 256, dx at Fout 64 / 128 / 256), 2720 (a dW row slice)
@pytest.mark.parametrize("K", [48, 96, 192, 384, 768, 2720])
def test_tf32x3_sum_order_meets_the_error_budget(K):
    rng = np.random.default_rng(K)
    a = (rng.standard_normal((64, K)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((K, 40)) / math.sqrt(K)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = gf.tf32x3_matmul(a, b)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert _rel_l2(got, want) <= BUDGET
    assert _rel_l2(gf.tf32x3_matmul(a, b, terms=1), want) > 10 * BUDGET  # one TF32 product


def _deploy_rows(V: int, B: int = cs.BATCH) -> int:
    return -(-V // 128) * 128 * B


# every float32 projection and K2 shape: (kind, M or V, fin, fout, extra)
def _f32_shapes():
    out = []
    for V, name, fin, fout, ep in cs.MAIN_PATH_CONVS:
        M = _deploy_rows(V)
        if name == "fused_cheby_conv":
            out.append(("proj", M, fin, fout, False))
            if ep == "skip_proj":
                out.append(("proj", M, 2 * fout, fout, False))
        else:
            out.append(("comm", M, fin, fout, 3))
        if sc.strip_mode(fin, fout) == "commuted":
            out.append(("comm", M, fin, fout, 3))
            if ep == "skip_proj":
                out.append(("comm", M, 2 * fout, fout, 1))
    for V, fin, fout, fold, stats in cs.TRAIN_CONVS + [(3475,) + cs.K2_TRAIN_CONV]:
        out += [("projstats" if stats else "proj", V * cs.BATCH, fin, fout, False),
                ("bwd", V, fin, fout, cs.BATCH)]
    mano = 778
    for name, fin, fout, ep in cs.MANO_DEPLOY_CONVS:
        out.append(("proj" if name == "fused_cheby_conv" else "comm", _deploy_rows(mano), fin,
                    fout, 3 if name != "fused_cheby_conv" else False))
    for fin, fout, fold, stats in cs.MANO_TRAIN_CONVS:
        out += [("projstats" if stats else "proj", mano * cs.BATCH, fin, fout, False),
                ("bwd", mano, fin, fout, cs.BATCH)]
    for V in (770, 385):  # the JAX .ckpt fixture's band levels, batch 16
        for fin, fout in ((16, 16), (16, 32), (32, 32), (32, 16), (16, 3)):
            out += [("proj", _deploy_rows(V, 16), fin, fout, False),
                    ("projstats", V * 16, fin, fout, False), ("comm", _deploy_rows(V, 16), fin,
                                                              fout, 3),
                    ("bwd", V, fin, fout, 16)]
    return sorted(set(out))


F32_SHAPES = _f32_shapes()


@pytest.mark.parametrize("kind,M,fin,fout,extra", F32_SHAPES,
                         ids=[f"{k}-{m}-{a}-{b}" for k, m, a, b, _ in F32_SHAPES])
def test_f32_gemm_plans(kind, M, fin, fout, extra):
    """The float32 plans hold the kernels' invariants at every phase-14,
    MANO and fixture shape."""
    if kind == "bwd":
        V, B = M, extra
        p = ft.bwd_plan(V, B, -(-V // 128), 1, fin, fout, SMS, 4)
        assert p.dx_bn in (64, 128) and p.fp % p.dx_bn == 0 and p.fp >= fin
        assert p.dx_items == -(-V * B // 128) * (p.fp // p.dx_bn)
        assert 0 < p.grid_dx <= min(p.dx_items, SMS)  # one dx block an SM
        assert p.dx_smem == ft.dx_smem(p.fp, 4) <= BLOCK_SMEM
        assert p.dx_smem + RESERVED <= SM_SMEM
        assert p.dw_smem == ft.dw_smem(4) == gf.gemm_f32_smem(64, 64, 3) <= BLOCK_SMEM
        assert p.dw_smem + RESERVED <= SM_SMEM
        assert p.gw % 64 == 0 and p.gw >= 3 * p.fo_pad and p.fo_pad % 16 == 0
        assert p.slices * p.slice_rows >= V * B and p.slice_rows % 32 == 0
        return
    if kind == "comm":
        p = fc.commuted_plan(M, fin, fout, SMS, blocks=extra, esize=4)
        assert p.np == extra * -(-fout // 16) * 16 and (p.np // extra) % p.bn == 0
        assert p.smem == fc.proj_smem(p.bn, p.np, False, 4)
    else:
        stats = kind == "projstats"
        p = fc.proj_plan(M, fin, fout, SMS, stats=stats, esize=4)
        assert p.np >= fout and p.np % p.bn == 0
        assert p.smem == fc.proj_smem(p.bn, p.np, stats, 4)
    assert p.bn in (16, 32, 64, 128) and p.bn % 8 == 0
    assert p.items == -(-M // 128) * (p.np // p.bn)
    assert 0 < p.grid <= min(p.items, fc.proj_blocks_per_sm(4) * SMS) <= SMS
    assert p.smem <= BLOCK_SMEM and p.smem + RESERVED <= SM_SMEM
    assert p.smem >= gf.gemm_f32_smem(128, p.bn, 2)


@pytest.mark.parametrize("case", ["proj_f", "proj_esize", "comm_blocks", "comm_esize",
                                  "bwd_esize", "widths_esize"])
def test_f32_plans_refuse_what_the_kernels_do_not_take(case):
    calls = {
        "proj_f": lambda: fc.proj_plan(4096, 24, 16, SMS, esize=4),
        "proj_esize": lambda: fc.proj_plan(4096, 16, 16, SMS, esize=8),
        "comm_blocks": lambda: fc.commuted_plan(4096, 16, 16, SMS, blocks=2, esize=4),
        "comm_esize": lambda: fc.commuted_plan(4096, 16, 16, SMS, esize=1),
        "bwd_esize": lambda: ft.bwd_plan(900, 3, 8, 1, 16, 16, SMS, 8),
        "widths_esize": lambda: fc._proj_widths(8),
    }
    with pytest.raises(ValueError):
        calls[case]()


def test_f32_smem_at_the_widest_tiles():
    """The largest float32 blocks: the 128-column projection (3 raw stages,
    230,400 bytes); with the statistics at Np 256, and dx at Fp 256, 2 raw
    stages and the slots (214,016 each); dW 115,712 (3 raw stages)."""
    assert gf.gemm_f32_smem(128, 128, 3) == 1024 + 7 * 256 * 128 == 230400
    assert fc.proj_smem(128, 128, False, 4) == 230400 <= BLOCK_SMEM
    assert fc.proj_smem(128, 256, True, 4) == gf.gemm_f32_smem(128, 128, 2) + 2 * 8 * 256 * 4
    assert fc.proj_smem(128, 256, True, 4) == ft.dx_smem(256, 4) == 214016 <= BLOCK_SMEM
    assert ft.dx_smem(64, 4) == gf.gemm_f32_smem(128, 64, 3) + 2 * 8 * 64 * 4
    assert ft.dw_smem(4) == 115712 and ft.dw_smem() == 2 * 3 * 32 * 72 * 2
    assert (gf.proj_f32_stages(128, True), gf.proj_f32_stages(64, True),
            gf.dx_f32_stages(128), gf.dx_f32_stages(64), gf.DW_F32_STAGES) == (2, 3, 2, 3, 3)


M_ROWS, V_ROWS, FIN, FOUT, FS = 7168 * 64, 6890 * 64, 128, 128, 256
# the multiply-adds of each conv's GEMM splits at M_ROWS rows, FIN -> FOUT
GEMM_MACS = {
    ("fused_cheby_conv", "basis", 0): {"proj": M_ROWS * 3 * FIN * FOUT},
    ("fused_cheby_conv", "basis", FS): {"proj": M_ROWS * (3 * FIN + FS) * FOUT},
    ("fused_cheby_conv_commuted", "basis", 0): {"proj": M_ROWS * FIN * 3 * FOUT},
    ("strip_cheby_conv", "commuted", FS): {"proj": M_ROWS * (FIN * 3 + FS) * FOUT},
    ("fused_cheby_conv_train", "basis", 0): {"proj": M_ROWS * 3 * FIN * FOUT},
    ("fused_cheby_conv_bwd", "basis", 0): {"dx": M_ROWS * 3 * FOUT * FIN,
                                           "dW": FIN * M_ROWS * 3 * FOUT},
}


@pytest.mark.parametrize("name,mode,fs", list(GEMM_MACS))
def test_chip_smoke_gemm_yardstick_shapes(name, mode, fs):
    """chip_smoke's GEMM yardsticks: each split's float32 torch.matmul
    shapes multiply out to the conv's products, its bound counts the real
    rows only (at least their operations at the 3xTF32 rate), and gemm_pass
    sums a pass's splits (the band_k 2 level's rows left out)."""
    pairs = cs.gemm_pairs(name, M_ROWS, FIN, FOUT, mode, fs)
    want = GEMM_MACS[(name, mode, fs)]
    assert set(pairs) == set(want)
    for split, ps in pairs.items():
        macs = sum((a[1] if t else a[0]) * (a[0] if t else a[1]) * b[1] for a, b, t in ps)
        assert macs == want[split]
        ms, by = cs.gemm_bound(ps, M_ROWS, V_ROWS)
        assert ms >= 2 * macs * V_ROWS / M_ROWS / cs.PEAK_3XTF32_FLOPS * 1e3 * (1 - 1e-9)
        assert by in ("bytes", "operations")
    rows = [{"tag": f"f32main{i}", "name": name, "split_ms": {k: 1.0 for k in pairs},
             "gemm_library_ms": {k: 2.0 for k in pairs},
             "gemm_bound_ms": {k: 0.5 for k in pairs}} for i in range(3)]
    rows.append({"tag": "f32k2_0", "name": name, "split_ms": {k: 9.0 for k in pairs},
                 "gemm_library_ms": {k: 9.0 for k in pairs},
                 "gemm_bound_ms": {k: 9.0 for k in pairs}})
    assert cs.gemm_pass(rows) == {name: {k: {"ms": 3.0, "library_ms": 6.0, "bound_ms": 1.5}
                                         for k in pairs}}


@pytest.mark.parametrize("stages", [2, 3])
@pytest.mark.parametrize("count", [1, 2, 3, 5, 12, 40])
def test_producer_ring_waits_for_each_k_tile(stages, count):
    """f32_produce's cp.async waits: before splitting k-tile q every group up
    to the one holding q has landed, and no k-tile's stage is refilled while
    an earlier k-tile that was not yet split sits in it."""
    live = {}
    for q, (committed, pending, group, stage) in enumerate(gf.ring_schedule(count, stages)):
        assert group < committed - pending, (q, committed, pending, group)
        live = {t: st for t, st in live.items() if t >= q}
        assert live.get(q, stage) == stage
        for t, st in live.items():
            assert t == q or st != stage or t < q
        live[q] = stage


@pytest.mark.parametrize("R", [16, 32, 64, 128])
@pytest.mark.parametrize("split", ["rows", "cols"])
def test_plane_layout_is_a_conflict_free_swizzle(R, split):
    """plane_offset maps each 8-row atom's 64 chunks onto its 1024 bytes one
    to one; every 8 consecutive threads of the split pass (a shared-memory
    phase of 16-byte stores) write 8 different 16-byte bank groups, row by
    row (split_rows: e -> row e / 8, chunk e % 8) and transposed
    (split_cols: e -> row e % R, chunk e / R)."""
    r, c = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    assert sorted(gf.plane_offset(r, c).ravel() // 16) == list(range(64))
    e = np.arange(R * 8)
    rows, chunks = (e >> 3, e & 7) if split == "rows" else (e % R, e // R)
    groups = (gf.plane_offset(rows, chunks) // 16) % 8
    for phase in groups.reshape(-1, 8):
        assert len(set(phase.tolist())) == 8
