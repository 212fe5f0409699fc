"""Device-ready graph operator artifacts (PyTorch).

Turns the host-side scipy pyramid (`graphs.build.GraphPyramid`) into the
constant tensors the MeshNet forward consumes.  Each mesh level is reordered
for minimal bandwidth (reverse Cuthill-McKee over a spectral relabeling),
then stored either

  * dense: the (V, V) matrix, for levels with V <= dense_threshold, or
  * band: strict block-banded form, `band_val[d, t]` the (T, T) block at
    block-row t, block-column t + d - band_k, with the tile count padded at
    pack time so a whole level runs at `padded_vertices` rows.

Pooling (the x2 nearest upsample between levels) and the final
un-permutation to the original vertex order are index gathers (`up_idx`,
`vertex_gather`).  The numpy packing mirrors the JAX package's
`graphs/artifact.py` value for value; BCSR, ELL, strip and face tables are
not part of this port yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..device import resolve_device
from .build import GraphPyramid

__all__ = ["LevelOperator", "PyramidArtifact", "pack_pyramid"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _empty() -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32)


@dataclass(frozen=True)
class LevelOperator:
    """One pyramid level's rescaled Laplacian.

    kind == "dense": `dense` is the (V, V) matrix.
    kind == "band": `band_val` is (2*band_k+1, nt, T, T); out-of-range
        blocks are zero and nt*T >= V is the pack-time padded row count.
    """

    dense: torch.Tensor = dataclasses.field(default_factory=_empty)
    band_val: torch.Tensor = dataclasses.field(default_factory=_empty)
    kind: str = "dense"
    num_vertices: int = 0
    block_size: int = 128
    band_k: int = 0

    @property
    def padded_vertices(self) -> int:
        if self.kind == "band":
            return int(self.band_val.shape[1]) * self.block_size
        return self.num_vertices

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "LevelOperator":
        """Move to `device`; `dtype` casts the operator values (the compute
        dtype of the convs that read them)."""
        def mv(t):
            return t.to(device=device, dtype=dtype or t.dtype)
        return dataclasses.replace(self, dense=mv(self.dense),
                                   band_val=mv(self.band_val))


@dataclass(frozen=True)
class PyramidArtifact:
    """All constants the MeshNet needs for one mesh/joint-set config.

    mesh_ops: per-level operators, finest first.
    joint_op: the joint-graph operator (dense, unrescaled Laplacian).
    up_idx[k]: level-(k+1) device position of each level-k device position.
    vertex_gather: device position of each original mesh vertex.
    faces: (F, 3) triangle faces in original vertex order.
    """

    mesh_ops: Tuple[LevelOperator, ...]
    joint_op: LevelOperator
    up_idx: Tuple[torch.Tensor, ...]
    vertex_gather: torch.Tensor
    faces: torch.Tensor
    joint_num: int = 0
    num_vertices: int = 0

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "PyramidArtifact":
        """Move every tensor to `device`; `dtype` casts the Laplacians only
        (index tensors keep their integer type)."""
        return dataclasses.replace(
            self,
            mesh_ops=tuple(op.to(device, dtype) for op in self.mesh_ops),
            joint_op=self.joint_op.to(device, dtype),
            up_idx=tuple(u.to(device) for u in self.up_idx),
            vertex_gather=self.vertex_gather.to(device),
            faces=self.faces.to(device),
        )


def _pack_band(L: sp.csr_matrix, T: int) -> Tuple[np.ndarray, int]:
    """(V, V) sparse matrix -> band_val (2*band_k+1, nt, T, T), band_k.

    The tile count is rounded up to a multiple of a row-tile group (8 tiles
    for band_k >= 2, else 4) with all-zero blocks, so the feature maps of a
    level keep one padded row count through all of its convs."""
    L = sp.csr_matrix(L)
    V = L.shape[0]
    nt = _cdiv(V, T)
    coo = L.tocoo()
    band_k = int(np.abs(coo.row // T - coo.col // T).max()) if coo.nnz else 0
    group = 8 if band_k >= 2 else 4
    if nt > group:
        nt = _cdiv(nt, group) * group
    band_val = np.zeros((2 * band_k + 1, nt, T, T), dtype=np.float32)
    t, ct = coo.row // T, coo.col // T
    band_val[ct - t + band_k, t, coo.row % T, coo.col % T] = coo.data
    return band_val, band_k


def _make_level_op(L: sp.csr_matrix, kind: str, block_size: int) -> LevelOperator:
    L = sp.csr_matrix(L, dtype=np.float64)
    V = L.shape[0]
    if kind == "dense":
        return LevelOperator(
            dense=torch.from_numpy(L.toarray().astype(np.float32)),
            kind="dense", num_vertices=V, block_size=block_size)
    if kind != "band":
        raise NotImplementedError(f"level kind {kind!r} is not ported yet")
    band_val, band_k = _pack_band(L, block_size)
    return LevelOperator(
        band_val=torch.from_numpy(band_val), kind="band", num_vertices=V,
        block_size=block_size, band_k=band_k)


def _min_bandwidth_order(adj: sp.csr_matrix, T: int) -> np.ndarray:
    """Bandwidth-minimizing vertex order: the best of plain RCM, RCM over a
    spectral (Fiedler-vector) relabeling, and, while the scalar bandwidth
    still exceeds one tile, RCM over seeded random relabelings.

    The Fiedler solve starts from a fixed seeded vector, so the order is the
    same on every call (ARPACK's own start vector depends on earlier calls in
    the process)."""
    adj = sp.csr_matrix(adj)

    def bw_of(order):
        P = adj[order][:, order].tocoo()
        return int(np.abs(P.row - P.col).max()) if P.nnz else 0

    def rcm_from(relab):
        sub = adj[relab][:, relab]
        r = np.asarray(reverse_cuthill_mckee(sub, symmetric_mode=True),
                       dtype=np.int64)
        return relab[r]

    best = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True),
                      dtype=np.int64)
    best_bw = bw_of(best)
    try:
        from scipy.sparse.linalg import eigsh
        deg = np.asarray(adj.sum(axis=1)).ravel()
        lap = sp.diags(deg) - adj.astype(np.float64)
        v0 = np.random.default_rng(0).uniform(-1.0, 1.0, adj.shape[0])
        vals, vecs = eigsh(lap, k=2, which="SM", maxiter=5000, v0=v0)
        fiedler = vecs[:, np.argsort(vals)[1]]
        cand = rcm_from(np.argsort(fiedler))
        bw = bw_of(cand)
        if bw < best_bw:
            best, best_bw = cand, bw
    except (sp.linalg.ArpackError, ValueError) as e:
        import warnings
        warnings.warn(f"spectral reorder candidate skipped: {e!r}")
    if best_bw > T:
        rng = np.random.default_rng(0)
        for _ in range(16):
            cand = rcm_from(rng.permutation(adj.shape[0]))
            bw = bw_of(cand)
            if bw < best_bw:
                best, best_bw = cand, bw
            if best_bw <= T:
                break
    return best


def pack_pyramid(
    pyr: GraphPyramid,
    faces: Optional[np.ndarray] = None,
    *,
    block_size: int = 128,
    dense_threshold: int = 768,
    device: str | torch.device | None = "cuda",
) -> PyramidArtifact:
    """Pack a host pyramid into the device artifact (float32 operators).

    Levels with V <= dense_threshold are stored dense, the others banded.
    The binary-tree padding vertices of the reference pyramid are isolated
    in every level's graph, so all levels but the coarsest (whose padded
    layout fixes the FC layer's output size) keep real vertices only."""
    dev = resolve_device(device)
    n_levels = len(pyr.mesh_laplacians)
    real_sizes = pyr.real_sizes
    if real_sizes is None:  # legacy pyramids: fakes are the isolated slots
        real_sizes = []
        for k in range(n_levels):
            deg = np.asarray(pyr.mesh_adjacencies[k].sum(axis=0)).ravel()
            real = pyr.orders[k][np.flatnonzero(deg > 0)]
            real_sizes.append(int(real.max()) + 1 if len(real) else 0)

    # layouts[k][p] = padded-tree slot stored at device position p
    layouts: List[np.ndarray] = []
    for k in range(n_levels):
        P = pyr.mesh_laplacians[k].shape[0]
        if k < n_levels - 1:
            keep = np.flatnonzero(np.asarray(pyr.orders[k]) < real_sizes[k])
        else:
            keep = np.arange(P, dtype=np.int64)
        if len(keep) > dense_threshold:
            adj = sp.csr_matrix(pyr.mesh_adjacencies[k])[keep][:, keep]
            rho = _min_bandwidth_order(adj, block_size)
        else:
            rho = np.arange(len(keep), dtype=np.int64)
        layouts.append(keep[rho])

    mesh_ops = []
    for k in range(n_levels):
        lay = layouts[k]
        L = sp.csr_matrix(pyr.mesh_laplacians[k])[lay][:, lay]
        kind = "dense" if L.shape[0] <= dense_threshold else "band"
        mesh_ops.append(_make_level_op(L, kind, block_size))
    joint_op = _make_level_op(pyr.joint_laplacian, "dense", block_size)

    up_idx = []
    for k in range(n_levels - 1):
        lay_f, lay_c = layouts[k], layouts[k + 1]
        pos_c = np.zeros(pyr.mesh_laplacians[k + 1].shape[0], dtype=np.int64)
        pos_c[lay_c] = np.arange(len(lay_c))
        # parent of tree slot s is slot s // 2 one level up
        up_idx.append(torch.from_numpy(pos_c[lay_f // 2]))

    pos0 = np.zeros(pyr.mesh_laplacians[0].shape[0], dtype=np.int64)
    pos0[layouts[0]] = np.arange(len(layouts[0]))
    faces_np = (np.asarray(faces, dtype=np.int64) if faces is not None
                else np.zeros((0, 3), np.int64))
    return PyramidArtifact(
        mesh_ops=tuple(mesh_ops),
        joint_op=joint_op,
        up_idx=tuple(up_idx),
        vertex_gather=torch.from_numpy(pos0[pyr.vertex_slot]),
        faces=torch.from_numpy(faces_np),
        joint_num=pyr.joint_num,
        num_vertices=pyr.num_vertices,
    ).to(dev)
