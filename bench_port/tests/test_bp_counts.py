"""The shape-based operation and byte counts against a hand-worked small
level, and the SMPL bounds against chip_smoke's recipe's totals."""
import json

import pytest

from bench_port import counts
from bench_port.harness import BENCH
from bench_port.peaks import PEAK_BF16_FLOPS, PEAK_BYTES
from bench_port.reference.pyramid import build_ref_pyramid


def _conv(**kw):
    base = dict(block=1, V=1000, nnz=5000, fin=16, fout=8, band=True, final=False,
                skip_fin=0, fold=False)
    base.update(kw)
    return counts.Conv(**base)


def test_deploy_group_conv_by_hand():
    # V 1000, nnz 5000, fin 16, fout 16, skip 8 -> 16 (skip_w), B 2, bf16:
    # ops  = 2*2*5000*2*16 + 2*1000*2*48*16 + 2*1000*2*8*16 = 640000 + 3072000 + 512000
    # bytes = 2*(1000*2*16 + 1000*2*8 + 48*16 + 16 + 8*16 + 1000*2*16 + 5000) = 2*(...)
    c = _conv(fin=16, fout=16, skip_fin=8)
    ops = 640000 + 3072000 + 512000
    bytes_ = 2 * (32000 + 16000 + 768 + 16 + 128 + 32000 + 5000)
    assert counts.band_bound_s([c], 2, train=False) == pytest.approx(
        max(bytes_ / PEAK_BYTES, ops / PEAK_BF16_FLOPS), rel=1e-12)


def test_deploy_commuted_conv_hops_on_the_output_width():
    c = _conv(fin=16, fout=8)          # narrows, no skip, not final: commuted
    ops = 2 * 2 * 5000 * 2 * 8 + 2 * 1000 * 2 * 48 * 8
    bytes_ = 2 * (1000 * 2 * 16 + 48 * 8 + 8 + 1000 * 2 * 8 + 5000)
    assert counts.band_bound_s([c], 2, train=False) == pytest.approx(
        max(bytes_ / PEAK_BYTES, ops / PEAK_BF16_FLOPS), rel=1e-12)


def test_train_conv_k1_and_k2_by_hand():
    c = _conv(fin=16, fout=8, fold=True)
    k1_ops = 2 * 2 * 5000 * 2 * 16 + 2 * 1000 * 2 * 48 * 8
    k1_bytes = 2 * (32000 + 384 + 8 + 16000 + 5000) + 2 * 2 * 16 + 2 * 8 * 4
    k2_ops = 2 * 2 * 5000 * 2 * 8 + 2 * 2 * 1000 * 2 * 48 * 8
    k2_bytes = (2 * (16000 + 32000 + 384) + 2 * 32000 + 384 * 4 + 8 * 4 + 2 * 5000
                + 2 * 2 * 16 + 2 * 16 * 4)
    want = (max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_BF16_FLOPS)
            + max(k2_bytes / PEAK_BYTES, k2_ops / PEAK_BF16_FLOPS))
    assert counts.band_bound_s([c], 2, train=True) == pytest.approx(want, rel=1e-12)
    assert counts.band_bound_s([_conv(band=False)], 2, train=True) == 0.0


def test_forward_flops_by_hand():
    cfg = {"joint_set": {"joint_num": 2}, "posenet_hidden": 4, "posenet_stages": 1,
           "blocks": [[5, 3, 4], [4, 4, 4], [4, 2, 3]], "dense_threshold": 768}
    convs = counts.conv_table(cfg, [10], [30], joint_nnz=4)
    assert [(c.V, c.fin, c.fout, c.band) for c in convs] == [
        (2, 5, 3, False), (2, 3, 4, False), (10, 4, 4, False), (10, 4, 4, False),
        (10, 4, 2, False), (10, 2, 3, False)]
    B = 3
    posenet = 2 * B * (4 * 4 + 2 * 16 + 4 * 6)
    fc = 2 * B * (2 * 4) * (7 * 4)
    mesh = (2 * 2 * 4 * B * 5 + 2 * 2 * B * 15 * 3) + (2 * 2 * 4 * B * 3 + 2 * 2 * B * 9 * 4) \
        + 2 * (2 * 2 * 30 * B * 4 + 2 * 10 * B * 12 * 4) \
        + (2 * 2 * 30 * B * 4 + 2 * 10 * B * 12 * 2) + (2 * 2 * 30 * B * 2 + 2 * 10 * B * 6 * 3)
    regressor = 2 * B * 2 * 10 * 3
    assert counts.forward_flops(cfg, convs, 7, B) == posenet + fc + mesh + regressor
    assert counts.step_flops(cfg, convs, 7, B, train=True) == 3 * (posenet + fc + mesh
                                                                   + regressor)


def test_smpl_bounds_are_chip_smokes():
    cfg = json.loads((BENCH / "configs" / "smpl_h36m17.json").read_text())
    import numpy as np
    with np.load(BENCH / "configs" / cfg["mesh"]) as z:
        faces = z["faces"]
    js = cfg["joint_set"]
    pyr = build_ref_pyramid(faces, js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    convs = counts.conv_table(cfg, pyr.sizes, pyr.nnz, int(pyr.joint_laplacian.nnz))
    assert sum(c.band for c in convs) == 10
    # chip_smoke's per-forward bounds: 0.362 ms (group) + 0.078 ms (commuted)
    assert counts.band_bound_s(convs, 64, train=False) * 1e3 == pytest.approx(0.440, abs=1e-3)
    # the train step's bound, K1 + K2 over the ten band convs: 0.966 ms
    assert counts.band_bound_s(convs, 64, train=True) * 1e3 == pytest.approx(0.966, abs=1e-3)
