"""PyTorch port: `utils/profiling.py` and `data/tools/pw3d_to_coco.py` (CPU).

The roofline functions' operation and byte counts equal the JAX package's
on artifacts both packages pack from one pyramid (dense, band with its strip
form, BCSR levels; 2- and 4-byte operands), their ideal times are at the
H100's rates, and `trace()` writes a Chrome trace on the CPU.  The 3DPW
converter on the synthetic pickle of tests/test_data.py's converter test
(chip_smoke.write_pw3d_sequence) against the JAX converter: integers and
strings equal, floats within 1e-5 (relative above 1); the port's PW3D loads
its JSON.
"""
import json
import os

import pytest
import torch

from pose2mesh_release_tpu.graphs.artifact import pack_pyramid as jax_pack_pyramid
from pose2mesh_release_tpu.utils import profiling as jax_profiling
from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.utils import profiling

import chip_smoke
from test_torch_artifact import fixed_eigsh_start

SKEL = ((0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6))


@pytest.fixture(scope="module")
def artifacts():
    """(JAX artifact, port artifact) per packing: banded with strips at
    dense_threshold 300, BCSR (the JAX package's other sparse form)."""
    _, faces = uv_sphere(770)
    with fixed_eigsh_start():
        pyr = build_pyramid(faces, joint_num=7, skeleton=SKEL, levels=4)
    out = {}
    for name, kw in (("band", {"dense_threshold": 300}),
                     ("bcsr", {"dense_threshold": 300, "sparse_kind": "bcsr"})):
        out[name] = (jax_pack_pyramid(pyr, faces, **kw), pack_pyramid(pyr, faces, device="cpu",
                                                                       **kw))
    return out


CASES = [(fin, fout, m) for fin, fout, m in ((128, 128, 4), (256, 128, 2), (16, 3, 4))]


def _counts(r):
    return (r.flops, r.hbm_bytes, r.intensity)


@pytest.mark.parametrize("packing", ["band", "bcsr"])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_roofline_counts_equal_the_jax_ones(artifacts, packing, dtype_bytes):
    """spmm_roofline, fused_conv_roofline, strip_conv_roofline and
    sparse_conv_roofline per level, and pyramid_roofline: the JAX
    functions' flops, hbm_bytes and intensity exactly; ideal_us at the
    card's rates (profiling.peak_rate and PEAK_BYTES)."""
    art_j, art_t = artifacts[packing]
    kinds = {op.kind for op in art_t.mesh_ops}
    assert kinds == ({"band", "dense"} if packing == "band" else {"bcsr", "dense"})
    peak = profiling.peak_rate(dtype_bytes)
    for op_j, op_t in zip(art_j.mesh_ops, art_t.mesh_ops):
        for fin, fout, m in CASES:
            pairs = [(profiling.spmm_roofline(op_t, 4, fin, dtype_bytes),
                      jax_profiling.spmm_roofline(op_j, 4, fin, dtype_bytes)),
                     (profiling.fused_conv_roofline(op_t, 4, fin, fout, m, dtype_bytes),
                      jax_profiling.fused_conv_roofline(op_j, 4, fin, fout, m, dtype_bytes)),
                     (profiling.sparse_conv_roofline(op_t, 4, fin, fout, dtype_bytes),
                      jax_profiling.sparse_conv_roofline(op_j, 4, fin, fout, dtype_bytes))]
            if op_t.kind == "band" and op_t.strip_h or dtype_bytes == 2:
                # (the JAX strip model counts a level without strips at 2-byte operands)
                pairs.append((profiling.strip_conv_roofline(op_t, 4, fin, fout, dtype_bytes),
                              jax_profiling.strip_conv_roofline(op_j, 4, fin, fout,
                                                                dtype_bytes)))
            for got, want in pairs:
                assert _counts(got) == _counts(want), (op_t.kind, op_t.num_vertices, fin, fout)
                ideal = max(got.flops / peak, got.hbm_bytes / profiling.PEAK_BYTES) * 1e6
                assert got.ideal_us == pytest.approx(ideal, rel=1e-12)
                assert got.bound == ("compute" if got.flops / peak > got.hbm_bytes
                                     / profiling.PEAK_BYTES else "memory")
    got = profiling.pyramid_roofline(art_t, 64, {0: 64, 1: 128, 2: 256})
    want = jax_profiling.pyramid_roofline(art_j, 64, {0: 64, 1: 128, 2: 256})
    assert list(got) == list(want)
    for k in want:
        assert (got[k]["flops"], got[k]["hbm_bytes"]) == (want[k]["flops"],
                                                          want[k]["hbm_bytes"])


def test_card_rates_and_their_readers(artifacts):
    """The H100 rates are defined once: chip_smoke's bound() reads them, and
    a float32 strip conv's count at a level without strips is at 4 bytes
    (the JAX model's fallback drops dtype_bytes there)."""
    _, art_t = artifacts["band"]
    dense = next(op for op in art_t.mesh_ops if op.kind == "dense")
    assert profiling.strip_conv_roofline(dense, 4, 16, 16, 4).hbm_bytes == \
        profiling.fused_conv_roofline(dense, 4, 16, 16, dtype_bytes=4).hbm_bytes == \
        2 * profiling.strip_conv_roofline(dense, 4, 16, 16, 2).hbm_bytes
    assert profiling.PEAK_BF16_FLOPS == 989e12 and profiling.PEAK_BYTES == 3.35e12
    assert profiling.PEAK_3XTF32_FLOPS == 495e12 / 3
    assert chip_smoke.PEAK_BF16_FLOPS is profiling.PEAK_BF16_FLOPS
    ms, by = chip_smoke.bound(int(989e9), int(3.35e6))
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = chip_smoke.bound(int(495e9 / 3), 0, f32=True)
    assert ms == pytest.approx(1.0)
    with pytest.raises(ValueError):
        profiling.peak_rate(8)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """trace(log_dir) profiles the block (CPU activity only without a card)
    and writes a Chrome trace JSON holding its operators."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path / "trace")
    events = json.load(open(path))["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert not any(e.get("cat") == "kernel" for e in events)


def test_pw3d_converter_matches_jax(tmp_path):
    """The port's convert_split (device cpu) and the JAX package's on one
    synthetic 3DPW pickle: the same JSON (chip_smoke.json_diff: integers
    and strings equal, floats 1e-5); the port's PW3D loads it."""
    from pose2mesh_release_tpu.data.tools.pw3d_to_coco import convert_split as jax_convert
    from pose2mesh_release_tpu_torch.body.smpl import SMPL
    from pose2mesh_release_tpu_torch.data.pw3d import PW3D
    from pose2mesh_release_tpu_torch.data.tools.pw3d_to_coco import convert_split

    chip_smoke.write_pw3d_sequence(str(tmp_path))
    jstats = jax_convert(str(tmp_path), "test", str(tmp_path / "jax.json"))
    stats = convert_split(str(tmp_path), "test", str(tmp_path / "3DPW_latest_test.json"),
                          device="cpu")
    assert stats == jstats and stats["images"] == 3 and stats["annotations"] > 0
    got = json.load(open(tmp_path / "3DPW_latest_test.json"))
    want = json.load(open(tmp_path / "jax.json"))
    assert chip_smoke.json_diff(got, want) == []
    ds = PW3D("test", data_dir=str(tmp_path), mesh_model=SMPL(), build_graph=False,
              device="cpu")
    assert len(ds) == stats["annotations"]
    inputs, _, _ = ds[0]
    assert inputs["pose2d"].shape == (19, 2)


def test_pw3d_converter_cli(tmp_path, capsys):
    """python -m pose2mesh_release_tpu_torch.data.tools.pw3d_to_coco --root
    --split --out --device: the file and its counts; --device defaults to
    cuda, which this CPU-only torch refuses."""
    from pose2mesh_release_tpu_torch.data.tools import pw3d_to_coco
    chip_smoke.write_pw3d_sequence(str(tmp_path))
    out = str(tmp_path / "out.json")
    pw3d_to_coco.main(["--root", str(tmp_path), "--split", "test", "--out", out,
                       "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    assert len(json.load(open(out))["images"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pw3d_to_coco.main(["--root", str(tmp_path), "--out", out])
