"""Launch-plan sweep of the float32 hop engine (csrc/band_hop_f32.cuh) on the
card: the times behind `ops.hop.hop_plan`'s float32 plan.

    python -m pose2mesh_release_tpu_torch.tools.hop_sweep

Run from the repository's root: it takes chip_smoke's random band_k 2
level (`k2_level`) and its CUDA-event timer (`cuda_ms`).  For each hop
shape of the SMPL unfused forward (the stand-in SMPL pyramid's band
levels at batch 64: K4 on x (Vp, 64 * F)) and a random band_k 2 level of
3475 rows, times one float32 hop through the C entry point
`p2m_banded_hop` (CUDA events, 20 launches after a warm-up) at runs of
items from a grid of sixteen blocks an SM down to one, and runs of 1, 2,
4 and 8 chunks, beside the plan `hop_plan` picks; each configuration's
result is held against the plain version once (relative L2).  Prints the
card's name and power limit, one line `SWEEP {...}` per configuration
(ms, the bound's ms) and, per shape,
`BEST {...}` with the ms of one torch.sparse.mm of the level's CSR
Laplacian on the same x beside.  Launches here are not counted by the
wrapper.  Needs the card.
"""
from __future__ import annotations

import json
import subprocess

import torch

from chip_smoke import cuda_ms, k2_level
from ..body.smpl import SMPL
from ..data.joint_sets import HUMAN36
from ..deploy import build_artifact
from ..ops import hop as hp
from ..ops.fused_cheby import _ptr, _stream
from ..utils.profiling import PEAK_BYTES

BATCH = 64
# the unfused forward's hops: (level vertex count, input channels)
SHAPES = [(981, 256), (1849, 256), (1849, 128), (3475, 128), (6890, 128), (6890, 64)]
BLOCKS_PER_SM = (16, 12, 8, 6, 4, 3, 2, 1)


def library_ms(band, x) -> float:
    """One torch.sparse.mm of the band's Laplacian (CSR, float32) with x."""
    import warnings
    nbd, nt, T, _ = band.shape
    d, t, r, c = torch.nonzero(band, as_tuple=True)
    with warnings.catch_warnings():  # torch's notes on its beta sparse support
        warnings.simplefilter("ignore", UserWarning)
        L = torch.sparse_coo_tensor(torch.stack([t * T + r, (t + d - nbd // 2) * T + c]),
                                    band[d, t, r, c], (nt * T, nt * T)).coalesce()
        L = L.to_sparse_csr()
    return cuda_ms(lambda: torch.sparse.mm(L, x), 20)


def sweep(op, F: int, sms: int, lib) -> list:
    band = op.band_val.to("cuda", torch.float32)
    nbd, nt = band.shape[:2]
    V, Vp, C = op.num_vertices, op.padded_vertices, BATCH * F
    g = torch.Generator(device="cuda").manual_seed(F)
    x = torch.randn(Vp, C, generator=g, device="cuda")
    out = torch.empty_like(x)
    want = hp.hop_plain(band, x)
    nnz = int(torch.count_nonzero(band))
    bound_ms = (2 * V * C * 4 + nnz * 4) / PEAK_BYTES * 1e3
    plan = hp.hop_plan(nt, hp.band_span(nbd // 2), C, sms, 4)
    results = []
    cc = plan.cc
    nch = -(-C // cc)
    items = nt * nch
    runs = {-(-items // (sms * b)) for b in BLOCKS_PER_SM} | {1, 2, 4, 8, plan.per_block}
    for per_block in sorted(runs):
        grid = -(-items // per_block)

        def launch():
            err = lib.p2m_banded_hop(_ptr(band), _ptr(x), _ptr(out), Vp, nt, nbd // 2, C,
                                     cc, grid, per_block, 1, _stream(x))
            if err:
                raise RuntimeError(lib.p2m_banded_hop_error_string(err).decode())

        launch()
        torch.cuda.synchronize()
        err = float((out[:V] - want[:V]).norm() / want[:V].norm())
        row = {"V": V, "band_k": nbd // 2, "F": F, "C": C, "cc": cc, "per_block": per_block,
               "grid": grid, "ms": cuda_ms(launch, 20), "bound_ms": bound_ms,
               "xy_bytes": 2 * V * C * 4, "rel_l2": err,
               "plan": per_block == plan.per_block}
        print("SWEEP " + json.dumps(row), flush=True)
        if err > 1e-5:
            raise SystemExit(f"the float32 hop disagrees with its plain version: {row}")
        results.append(row)
    best = min(results, key=lambda r: r["ms"])
    chosen = next(r for r in results if r["plan"])
    print("BEST " + json.dumps({"V": V, "F": F, "best": best, "plan_ms": chosen["ms"],
                                "library_ms": library_ms(band, x)}), flush=True)
    return results


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("hop_sweep needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    art = build_artifact(SMPL().face, HUMAN36, 9, torch.device("cpu"))
    by_v = {op.num_vertices: op for op in art.mesh_ops}
    sms = hp.sm_count(torch.device("cuda"))
    lib = hp._hop_lib()
    for V, F in SHAPES:
        sweep(by_v[V], F, sms, lib)
    sweep(k2_level(3475), 128, sms, lib)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
