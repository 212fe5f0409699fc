"""The frozen inputs equal what today's stand-in recipe gives: each
configuration's mesh file (faces, template, regressor) against the port's
stand-in bodies, and the reference's pyramid, from the frozen coarsening,
against the port's pyramid and packed artifact on the same faces."""
import json

import numpy as np
import pytest

from bench_port.harness import BENCH
from bench_port.reference.graph_build import build_pyramid as frozen_build
from bench_port.reference.pyramid import build_ref_pyramid

CONFIGS = ("smpl_h36m17", "mano_freihand21")


def _load(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    with np.load(BENCH / "configs" / cfg["mesh"]) as z:
        return cfg, {k: z[k] for k in z.files}


def _stand_in(body):
    if body == "smpl":
        from pose2mesh_release_tpu_torch.body.smpl import SMPL
        s = SMPL()
        return s.face, s.v_template, s.joint_regressor_h36m
    from pose2mesh_release_tpu_torch.body.mano import MANO
    m = MANO()
    return m.face, np.asarray(m.params.v_template), m.joint_regressor_mano


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_mesh_is_the_stand_in(name):
    cfg, mesh = _load(name)
    faces, template, reg = _stand_in(cfg["body"])
    assert np.array_equal(mesh["faces"], faces)
    assert np.array_equal(mesh["template"], template.astype(np.float32))
    assert np.array_equal(mesh["j_regressor"], reg.astype(np.float32))
    assert mesh["template"].shape == (cfg["num_vertices"], 3)
    assert mesh["j_regressor"].shape == (cfg["joint_set"]["joint_num"], cfg["num_vertices"])


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_pyramid_is_the_ports(name):
    import torch
    from pose2mesh_release_tpu_torch.graphs.artifact import pack_pyramid
    from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
    cfg, mesh = _load(name)
    js = cfg["joint_set"]
    args = dict(joint_num=js["joint_num"], skeleton=[tuple(e) for e in js["skeleton"]],
                flip_pairs=[tuple(e) for e in js["flip_pairs"]], levels=cfg["levels"],
                extra_joint_edges=[tuple(e) for e in js["extra_edges"]])
    faces = mesh["faces"].astype(np.int64)
    mine, port = frozen_build(faces, **args), build_pyramid(faces, **args)
    assert len(mine.mesh_laplacians) == len(port.mesh_laplacians)
    for a, b in zip(mine.mesh_laplacians, port.mesh_laplacians):
        assert abs(a - b).max() < 1e-12
    for a, b in zip(mine.orders, port.orders):
        assert np.array_equal(a, b)
    assert np.array_equal(mine.vertex_slot, port.vertex_slot)
    assert abs(mine.joint_laplacian - port.joint_laplacian).max() < 1e-12

    ref = build_ref_pyramid(faces, js["joint_num"], js["skeleton"], js["flip_pairs"],
                            js["extra_edges"], cfg["levels"])
    art = pack_pyramid(port, faces, dense_threshold=cfg["dense_threshold"],
                       block_size=cfg["block_size"], device="cpu")
    assert ref.sizes == [op.num_vertices for op in art.mesh_ops]
    assert cfg["coarse_vertices"] == ref.sizes[-1]
    for op, nnz in zip(art.mesh_ops, ref.nnz):
        t = op.band_val if op.kind == "band" else op.dense
        assert int(torch.count_nonzero(t)) == nnz
