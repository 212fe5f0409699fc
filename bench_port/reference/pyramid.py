"""The reference's own graph pyramid, from the configuration's frozen mesh
and the frozen coarsening beside this file.

Each mesh level keeps the real vertices of the coarsening's binary-tree
layout, in tree order; the coarsest level keeps every slot, fakes included,
because the FC layer's output covers them.  This is the port's semantics
(its packer drops the same fake vertices), worked out here without its
reordering or packing: the operators stay scipy matrices in tree order, and
the upsample between levels is the tree's parent map (slot s -> s // 2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import scipy.sparse as sp

from .graph_build import build_pyramid

__all__ = ["RefPyramid", "build_ref_pyramid"]


@dataclass
class RefPyramid:
    """laplacians[k]: the rescaled Laplacian of mesh level k (finest first)
    over its kept rows; joint_laplacian: the joint graph's (unrescaled);
    up[k][r]: the level-(k+1) row of level-k row r's parent; vertex_row[v]:
    the finest-level row of original vertex v."""

    laplacians: List[sp.csr_matrix]
    joint_laplacian: sp.csr_matrix
    up: List[np.ndarray]
    vertex_row: np.ndarray

    @property
    def sizes(self) -> List[int]:
        return [L.shape[0] for L in self.laplacians]

    @property
    def nnz(self) -> List[int]:
        return [int(L.nnz) for L in self.laplacians]


def build_ref_pyramid(faces: np.ndarray, joint_num: int,
                      skeleton: Sequence[Sequence[int]],
                      flip_pairs: Sequence[Sequence[int]],
                      extra_edges: Sequence[Sequence[int]], levels: int) -> RefPyramid:
    pyr = build_pyramid(np.asarray(faces, np.int64), joint_num=joint_num,
                        skeleton=[tuple(e) for e in skeleton],
                        flip_pairs=[tuple(e) for e in flip_pairs], levels=levels,
                        extra_joint_edges=[tuple(e) for e in extra_edges])
    n = len(pyr.mesh_laplacians)
    keeps, pos = [], []
    for k in range(n):
        P = pyr.mesh_laplacians[k].shape[0]
        keep = (np.flatnonzero(np.asarray(pyr.orders[k]) < pyr.real_sizes[k])
                if k < n - 1 else np.arange(P, dtype=np.int64))
        p = np.full(P, -1, np.int64)
        p[keep] = np.arange(len(keep))
        keeps.append(keep)
        pos.append(p)
    laps = [sp.csr_matrix(pyr.mesh_laplacians[k])[keeps[k]][:, keeps[k]].astype(np.float64)
            for k in range(n)]
    up = [pos[k + 1][keeps[k] // 2] for k in range(n - 1)]
    vertex_row = pos[0][pyr.vertex_slot]
    if any((u < 0).any() for u in up) or (vertex_row < 0).any():
        raise ValueError("a real vertex maps to a dropped slot")
    return RefPyramid(laplacians=laps, joint_laplacian=sp.csr_matrix(pyr.joint_laplacian),
                      up=up, vertex_row=vertex_row)
