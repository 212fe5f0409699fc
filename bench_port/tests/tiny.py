"""A cell at a size a CPU test holds: a 302-vertex UV sphere, 4 levels
(dense_threshold 100, so the two finest levels are band levels), narrow
blocks, PoseNet 64, batch 4, the program on the CPU (the kernels' plain
versions)."""
from __future__ import annotations

import copy
import json

import numpy as np

from bench_port.harness import BENCH, Cell, cell_metrics

TINY_BLOCKS = [[5, 8, 16, 16], [16, 16, 32], [32, 32, 32], [32, 16, 16], [16, 8, 3]]


def tiny_mesh(vertices: int = 302, joints: int = 17, seed: int = 0):
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    verts, faces = uv_sphere(vertices)
    rng = np.random.default_rng(seed)
    w = rng.random((joints, vertices)) ** 8
    return {"faces": faces.astype(np.int32),
            "template": (verts * np.array([0.3, 0.2, 0.9])).astype(np.float32),
            "j_regressor": (w / w.sum(1, keepdims=True)).astype(np.float32)}


def tiny_cell(kind: str = "serve", batch: int = 4, limits=None) -> Cell:
    with open(BENCH / "configs" / "smpl_h36m17.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(name="tiny", num_vertices=302, levels=4, blocks=TINY_BLOCKS,
               posenet_hidden=64, dense_threshold=100)
    from bench_port.reference.pyramid import build_ref_pyramid
    mesh = tiny_mesh()
    js = cfg["joint_set"]
    pyr = build_ref_pyramid(mesh["faces"], js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    cfg["coarse_vertices"] = pyr.sizes[-1]
    mix = "serve_b64.json" if kind == "serve" else "train_b64.json"
    with open(BENCH / "traffic" / mix) as f:
        traffic = json.load(f)
    traffic.update(batch=batch, pool=3, warmup=1, trace_steps=2)
    if kind == "serve":
        traffic["check_requests"] = 2
    with open(BENCH.parent / "BENCHMARK.json") as f:
        manifest = json.load(f)
    name = "smpl_h36m17.serve_b64" if kind == "serve" else "smpl_h36m17.train_b64"
    return Cell(name=name, cfg=cfg, mesh=mesh, traffic=traffic, limits=limits or {},
                end_to_end=cell_metrics(manifest["end_to_end"], name),
                per_layer=cell_metrics(manifest["per_layer"], name))



TINY_SMPL_BLOCKS = [[5, 8, 16, 16], [16, 16, 32], [32, 32, 32], [32, 32, 32], [32, 32, 32],
                    [32, 32, 32], [32, 16, 16], [16, 16, 16], [16, 16, 16], [16, 8, 3]]
TINY_ANNOTATIONS = {"Human36M": 24, "COCO": 8, "MuCo": 12}
# the loader-fed cell's per-layer metric of its own, as BENCHMARK.json would list it
LOADER_WAIT = {"name": "loader_wait_ms.train", "unit": "ms", "better": "lower",
               "source": "host_clock", "layer": "loader", "moves": "train_samples_per_s"}


def tiny_loader_cell(limits: dict, batch: int = 4, workers: int = 2) -> Cell:
    """The loader-fed cell of configuration smpl_coco19 and mix
    train_loader_b64 at a size a CPU test holds: the SMPL body and its
    9-level datasets' pyramid as they are (the datasets fix them), narrow
    blocks, PoseNet 64, a few dozen stand-in samples, batch 4, two loader
    threads; the metrics of smpl_h36m17.train_b64 and the loader's wait."""
    with open(BENCH / "configs" / "smpl_coco19.json") as f:
        cfg = json.load(f)
    cfg.update(blocks=TINY_SMPL_BLOCKS, posenet_hidden=64, annotations=dict(TINY_ANNOTATIONS))
    with np.load(BENCH / "configs" / cfg["mesh"]) as z:
        mesh = {k: z[k] for k in z.files}
    with open(BENCH / "traffic" / "train_loader_b64.json") as f:
        traffic = json.load(f)
    traffic.update(batch=batch, workers=workers, warmup=1, trace_steps=2)
    with open(BENCH.parent / "BENCHMARK.json") as f:
        manifest = json.load(f)
    like = "smpl_h36m17.train_b64"
    return Cell(name="smpl_coco19.train_loader_b64", cfg=cfg, mesh=mesh, traffic=traffic,
                limits=dict(limits), end_to_end=cell_metrics(manifest["end_to_end"], like),
                per_layer=cell_metrics(manifest["per_layer"], like) + [LOADER_WAIT])
