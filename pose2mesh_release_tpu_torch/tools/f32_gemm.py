"""The float32 GEMM splits on the card beside their yardstick: the projection
of the group and commuted deploy convs and of K1, and K2's dx and dW
(csrc/gemm_f32.cuh), at the shapes of chip_smoke's phase 14.

    python -m pose2mesh_release_tpu_torch.tools.f32_gemm [--kernels]

Run from the repository's root: it takes chip_smoke's shape lists
(MAIN_PATH_CONVS, TRAIN_CONVS, K2_TRAIN_CONV), its inputs (`conv_case`),
timer (`cuda_ms`) and GEMM helpers (`gemm_pairs`, `gemm_library`,
`gemm_bound`).  Prints the card's name and power limit, then one line `GEMM {...}` per
split of one SMPL pass (and the band_k 2 level's train conv): the float32
torch.matmul of the same shapes (TF32 off; the port never calls it) and the
split's bound at the 3xTF32 rate, and `PASS {...}`, per kernel and split
the sums over the pass; before any kernel runs.  Then builds the kernels
and prints every instance's ptxas lines (registers, spills, wgmma notes);
with --kernels the GEMM and PASS lines again, with each split's launches
timed apart through the launchers (CUDA events, 20 runs; not counted as
launches) and the whole call against its plain version on the same float32
inputs (relative L2, F32_KERNEL_TOL).  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess

import torch

import chip_smoke as cs
from ..body.smpl import SMPL
from ..data.joint_sets import HUMAN36
from ..deploy import build_artifact
from ..ops import _build
from ..ops import fused_cheby as fc
from ..ops import fused_cheby_train as ft


def ptxas_lines() -> list:
    """Every kernel instance's ptxas lines of the build."""
    out = []
    for stem, text in _build.build_log.items():
        fn = ""
        for line in text.splitlines():
            props = re.search(r"Function properties for (\S+)", line)
            if props:
                fn = cs.kernel_label(props.group(1))
            elif any(w in line for w in ("registers", "spill", "error", "wgmma")):
                out.append(f"ptxas {stem} {fn}: {line.strip()}")
    return out


def deploy_split(op, name, fin, fout, ep, gen, kernels: bool) -> dict:
    """The projection split of one group or commuted deploy conv."""
    f32 = torch.float32
    band = op.band_val.to("cuda", f32)
    x, W, b, skip, skip_w = cs.conv_case(op, fin, fout, ep, gen, f32)
    relu = ep != "final"
    M, V = x.shape[0] * cs.BATCH, op.num_vertices * cs.BATCH
    fs = 0 if skip_w is None else skip.shape[-1]
    row = {"kernel": name, "V": op.num_vertices, "fin": fin, "fout": fout, "epilogue": ep}
    if kernels:
        if name == "fused_cheby_conv":
            run, _ = fc.conv_launcher(band, x, W, b, relu, skip, skip_w)
            stage = fc.CONV_STAGES["proj"]
            got = fc.fused_cheby_conv(band, x, W, b, relu=relu, skip=skip, skip_w=skip_w)
            want = fc.fused_cheby_conv_plain(band, x, W, b, relu=relu, skip=skip,
                                             skip_w=skip_w)
        else:
            run, _ = fc.commuted_launcher(band, x, W, b, relu)
            stage = fc.COMMUTED_STAGES["proj"]
            got = fc.fused_cheby_conv_commuted(band, x, W, b, relu=relu)
            want = fc.fused_cheby_conv_commuted_plain(band, x, W, b, relu=relu)
        n = op.num_vertices
        row["rel_l2"] = {"y": cs.rel_l2(got[:n], want[:n])}
        row["ms"] = {"proj": cs.cuda_ms(lambda: run(stage), 20)}
    return splits(row, name, M, V, fin, fout, fs)


def train_split(op, fin, fout, fold, stats, gen, kernels: bool) -> list:
    """K1's projection split and K2's dx and dW of one train conv."""
    f32, dev, V = torch.float32, "cuda", op.num_vertices
    band = op.band_val.to(dev, f32)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + shift

    x = randn(V, cs.BATCH, fin, scale=0.5)
    W = randn(3 * fin, fout, scale=1.0 / math.sqrt(3 * fin))
    b, g = randn(fout, scale=0.1), randn(V, cs.BATCH, fout)
    in_fold = (randn(fin, scale=0.25, shift=1.0), randn(fin, scale=0.1)) if fold else None
    info = {"V": V, "fin": fin, "fout": fout, "in_fold": fold, "emit_stats": stats}
    k1 = {"kernel": "fused_cheby_conv_train", **info}
    k2 = {"kernel": "fused_cheby_conv_bwd", **info}
    if kernels:
        run, _ = ft.train_launcher(band, x, W, b, in_fold, stats, False)
        k1["ms"] = {"proj": cs.cuda_ms(lambda: run(ft.TRAIN_STAGES["proj"]), 20)}
        got = ft.fused_cheby_conv_train(band, x, W, b, in_fold=in_fold, emit_stats=stats)
        want = ft.fused_cheby_conv_train_plain(band, x, W, b, in_fold=in_fold,
                                               emit_stats=stats)
        got, want = (got, want) if stats else ((got,), (want,))
        k1["rel_l2"] = {n: cs.rel_l2(a, r) for n, a, r in zip(("y", "sum_y", "sum_y2"), got,
                                                                 want)}
        run, _ = ft.bwd_launcher(band, g, x, W, in_fold)
        k2["ms"] = {s: cs.cuda_ms(lambda m=ft.BWD_STAGES[s]: run(m), 20) for s in ("dx", "dW")}
        got = ft.fused_cheby_conv_bwd(band, g, x, W, in_fold=in_fold)
        want = ft.fused_cheby_conv_bwd_plain(band, g, x, W, in_fold=in_fold)
        k2["rel_l2"] = {n: cs.rel_l2(a, r) for n, a, r in zip(("dx", "dW", "db", "ds", "dc"),
                                                                 got, want)}
    M = V * cs.BATCH
    return [splits(k1, k1["kernel"], M, M, fin, fout), splits(k2, k2["kernel"], M, M, fin, fout)]


def splits(row, name, M, V_rows, fin, fout, fs=0) -> dict:
    """The row's library ms and bound per split, printed as a GEMM line."""
    row["library_ms"], row["bound_ms"] = {}, {}
    for split, pairs in cs.gemm_pairs(name, M, fin, fout, fs=fs).items():
        row["library_ms"][split] = cs.gemm_library(pairs)
        row["bound_ms"][split] = cs.gemm_bound(pairs, M, V_rows)[0]
    row["ok"] = max(row.get("rel_l2", {"": 0.0}).values()) <= cs.F32_KERNEL_TOL
    print("GEMM " + json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the float32 GEMM splits beside torch.matmul")
    p.add_argument("--kernels", action="store_true",
                   help="also time the kernels' splits and check them against plain")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("f32_gemm needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    art = build_artifact(SMPL().face, HUMAN36, 9, torch.device("cpu"))
    by_v = {op.num_vertices: op for op in art.mesh_ops}
    one_pass(by_v, False)  # the yardsticks alone, before any kernel runs
    _build.build_all()
    print("\n".join(ptxas_lines()), flush=True)
    if args.kernels:
        bad = [r for r in one_pass(by_v, True) if not r["ok"]]
        if bad:
            raise SystemExit(f"float32 GEMM check failed: {bad}")
    return 0


def one_pass(by_v, kernels: bool) -> list:
    """The GEMM lines of one SMPL pass and the band_k 2 level's train conv,
    then the PASS line of the pass's sums; returns every row."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = [deploy_split(by_v[V], name, fin, fout, ep, gen, kernels)
            for V, name, fin, fout, ep in cs.MAIN_PATH_CONVS]
    for V, fin, fout, fold, stats in cs.TRAIN_CONVS:
        rows += train_split(by_v[V], fin, fout, fold, stats, gen, kernels)
    total = {}
    for r in rows:
        for split, lib in r["library_ms"].items():
            d = total.setdefault(r["kernel"], {}).setdefault(
                split, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
            d["library_ms"] += lib
            d["bound_ms"] += r["bound_ms"][split]
            d["ms"] += r.get("ms", {}).get(split, 0.0)
    print("PASS " + json.dumps(total), flush=True)
    return rows + train_split(cs.k2_level(3475), *cs.K2_TRAIN_CONV, gen, kernels)


if __name__ == "__main__":
    raise SystemExit(main())
