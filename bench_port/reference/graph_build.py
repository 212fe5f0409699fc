"""The benchmark's frozen copy of the port's graphs/build.py (imports the
frozen `coarsen` beside it).  Left as copied.

Graph construction from mesh faces and joint skeletons.

Reference semantics: the reference's lib/graph_utils.py:37-95 (triangle faces
-> symmetric binary adjacency; skeleton + flip pairs + identity -> joint
adjacency; pyramid orchestration that swaps the coarsest level for the joint
graph and rescales every *mesh* Laplacian — the joint-level Laplacian is left
unrescaled, a reference quirk we preserve because it defines the trained
operator).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from .coarsen import (
    CoarseningResult,
    coarsen,
    invert_permutation,
    lmax,
    normalized_laplacian,
    rescale_laplacian,
)

__all__ = ["mesh_adjacency", "joint_adjacency", "GraphPyramid", "build_pyramid"]


def mesh_adjacency(faces: np.ndarray, num_vertices: int) -> sp.csr_matrix:
    """Triangle faces (T, 3) -> symmetric binary adjacency (V, V).

    Each face contributes its three undirected edges with weight 1 (duplicate
    edges collapse to 1).  Reference: lib/graph_utils.py:37-60.
    """
    faces = np.asarray(faces, dtype=np.int64)
    src = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 0]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 2]])
    ones = np.ones(len(src), dtype=np.float64)
    A = sp.coo_matrix((ones, (src, dst)), shape=(num_vertices, num_vertices))
    A = A.tocsr()
    # Duplicate directed edges (an edge shared by k faces in the same
    # orientation) collapse to count-1 when count > 1 — the reference's
    # `adj - (adj > 1) * 1.0` (graph_utils.py:52).  For manifold meshes this
    # is simply 1 everywhere; we keep the exact rule so pyramids built from
    # arbitrary meshes match the reference bit-for-bit.
    A.data = np.where(A.data > 1.0, A.data - 1.0, A.data)
    A = A.maximum(A.T)  # symmetrize: max(adj, adj.T), graph_utils.py:55
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def joint_adjacency(
    joint_num: int,
    skeleton: Sequence[Tuple[int, int]],
    flip_pairs: Sequence[Tuple[int, int]] = (),
    extra_edges: Sequence[Tuple[int, int]] = (),
) -> sp.csr_matrix:
    """Skeleton bones + left/right flip pairs + self-loops -> joint adjacency.

    Reference: lib/graph_utils.py:63-72 (self-loops via the added identity).
    `extra_edges` supports FreiHAND's horizontal finger connections
    (data/FreiHAND/dataset.py:40).
    """
    A = np.zeros((joint_num, joint_num), dtype=np.float64)
    for i, j in list(skeleton) + list(flip_pairs) + list(extra_edges):
        A[i, j] = 1.0
        A[j, i] = 1.0
    A += np.eye(joint_num)
    return sp.csr_matrix(A)


@dataclass
class GraphPyramid:
    """Raw (scipy) coarsening pyramid for one mesh/joint-set configuration.

    mesh_laplacians: rescaled Chebyshev Laplacians for the *used* mesh levels,
        finest first (SMPL: sizes 12288, 6144, ..., 96 — the unused 48/24
        levels are dropped, mirroring `del graph_L[-2]` and the joint swap in
        the reference meshnet, lib/models/meshnet.py:35 + graph_utils.py:84).
    joint_laplacian: the *unrescaled* normalized joint-graph Laplacian
        (graph_utils.py:90-92 only rescales indices < levels).
    orders: tree permutation per mesh level (slot -> original id), finest
        first; orders[0] maps padded slots to original mesh vertex ids.
    vertex_slot: inverse of orders[0] restricted to real vertices —
        vertex_slot[v] = padded tree slot of original mesh vertex v; this is
        the `graph_perm_reverse` gather used to un-permute network output
        back to SMPL/MANO vertex order (lib/core/base.py:130).
    """

    mesh_laplacians: List[sp.csr_matrix]
    mesh_adjacencies: List[sp.csr_matrix]
    joint_laplacian: sp.csr_matrix
    joint_adjacency: sp.csr_matrix
    orders: List[np.ndarray]
    vertex_slot: np.ndarray
    num_vertices: int
    joint_num: int
    lmaxes: List[float]
    # real (non-fake) vertex count per retained mesh level: tree slots whose
    # original id is < real_sizes[k] are actual graph vertices, the rest are
    # the isolated binary-tree padding vertices (lib/coarsening.py:229-247).
    real_sizes: List[int] = None


def build_pyramid(
    faces: np.ndarray,
    joint_num: int,
    skeleton: Sequence[Tuple[int, int]],
    flip_pairs: Sequence[Tuple[int, int]] = (),
    levels: int = 9,
    extra_joint_edges: Sequence[Tuple[int, int]] = (),
    hem_impl: str = "reference",
) -> GraphPyramid:
    """Build the full coarsening pyramid for a mesh + joint set.

    Matches build_coarse_graphs (lib/graph_utils.py:75-95) composed with the
    meshnet's `del graph_L[-2]`: of the `levels+1` coarsened graphs we keep
    mesh levels 0..levels-2 (SMPL levels=9: sizes 12288..96) and replace the
    rest with the joint graph.

    hem_impl="reference" (default) reproduces the reference coarsener exactly,
    which is required for published-checkpoint compatibility (SMPL finest
    level = 12288 rows); "clean" uses the re-derived textbook HEM.
    """
    num_vertices = int(np.asarray(faces).max()) + 1
    A = mesh_adjacency(faces, num_vertices)
    res: CoarseningResult = coarsen(A, levels, impl=hem_impl)

    # Used mesh levels: 0 .. levels-2 inclusive (drop the two coarsest).
    used = levels - 1
    mesh_Ls: List[sp.csr_matrix] = []
    lmaxes: List[float] = []
    for k in range(used):
        L = res.laplacians[k]
        lam = lmax(L)
        lmaxes.append(lam)
        mesh_Ls.append(rescale_laplacian(L, lam))

    jA = joint_adjacency(joint_num, skeleton, flip_pairs, extra_joint_edges)
    jL = normalized_laplacian(jA)  # intentionally NOT rescaled (see docstring)

    order0 = res.orders[0]
    slot_of = invert_permutation(order0)
    vertex_slot = slot_of[:num_vertices]

    return GraphPyramid(
        mesh_laplacians=mesh_Ls,
        mesh_adjacencies=[res.adjacencies[k] for k in range(used)],
        joint_laplacian=jL,
        joint_adjacency=jA,
        orders=[res.orders[k] for k in range(used)],
        vertex_slot=np.asarray(vertex_slot, dtype=np.int64),
        num_vertices=num_vertices,
        joint_num=joint_num,
        lmaxes=lmaxes,
        real_sizes=[len(res.parents[k]) for k in range(used)],
    )
