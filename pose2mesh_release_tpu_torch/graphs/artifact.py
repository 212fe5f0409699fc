"""Device-ready graph operator artifacts (PyTorch).

Turns the host-side scipy pyramid (`graphs.build.GraphPyramid`) into the
constant tensors the MeshNet forward consumes.  Each mesh level is reordered
for minimal bandwidth (reverse Cuthill-McKee over a spectral relabeling),
then stored as

  * dense: the (V, V) matrix, for levels with V <= dense_threshold, or
  * band: strict block-banded form, `band_val[d, t]` the (T, T) block at
    block-row t, block-column t + d - band_k, with the tile count padded at
    pack time so a whole level runs at `padded_vertices` rows.  Band levels
    also carry the strip form (`_pack_strip`): row tile t of `strip_h` rows
    holds L[rows, o_t : o_t + W] with W about strip_h + 2 * bandwidth and
    the offsets o_t in `strip_off`, built here by `strip_offset`, and,
    with nt >= 2*band_k+1 row tiles, the sliding-window form (`window_cat`:
    `window_val`, `window_off`), or
  * bcsr: padded block-sparse rows (`blk_col`, `blk_val`).

Every kind also carries the ELL form (`ell_idx`, `ell_w`; padded entries
point at their own row with weight 0); dense levels also its rows without
their zero entries (`dense_rows`: `csr_ptr`, `csr_col`, `csr_val`, the table
of `ops.dense_cheby`), derived at pack and load time like the window form.
Pooling (the x2 nearest upsample between levels) and the final
un-permutation to the original vertex order are index gathers (`up_idx`,
`vertex_gather`).  The artifact also carries
the face tables of the face losses' backward (`face_band_tables`,
`face_inverse_tables`).  The numpy packing mirrors the JAX package's
`graphs/artifact.py` value for value, and `save_artifact` /
`load_artifact` read and write its npz format.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from ..device import resolve_device
from .build import GraphPyramid

__all__ = ["LevelOperator", "PyramidArtifact", "pack_pyramid", "save_artifact",
           "load_artifact", "strip_offset", "window_offsets", "window_cat",
           "face_band_tables", "face_inverse_tables"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _empty(*shape: int, dtype: torch.dtype = torch.float32):
    def make() -> torch.Tensor:
        return torch.zeros(shape or (0,), dtype=dtype)
    return dataclasses.field(default_factory=make)


@dataclass(frozen=True)
class LevelOperator:
    """One pyramid level's rescaled Laplacian.

    kind == "dense": `dense` is the (V, V) matrix.
    kind == "band": `band_val` is (2*band_k+1, nt, T, T); out-of-range
        blocks are zero and nt*T >= V is the pack-time padded row count.
        With strip_h > 0 also the strip form: `strip_val` (nt*T, W) with
        strip_val[r, j] = L[r, strip_off[r // strip_h] + j]; band_bw is the
        scalar bandwidth max |r - c|.  With nt >= 2*band_k+1 also the
        window form: `window_val` (nt*T, (2*band_k+1)*T), `window_off`
        (nt,) int32, as `window_cat` builds them.  Both forms are derived
        from the band at pack and load time, not saved.
    kind == "halo": one graph rank's slab of a band level
        (`parallel.sharding.shard_artifact`): `band_val` is (2*band_k+1,
        nt_l + 2*band_k, T, T), the rank's nt_l row tiles between band_k
        zero tiles a side; num_vertices is the whole level's.
    kind == "bcsr": `blk_col[t, b]` is the column tile of the b-th nonzero
        block of row tile t, `blk_val` (nt, maxb, T, T) its values (padding
        blocks are zero and point at column tile 0).
    Every kind: `ell_idx`, `ell_w` (V, D), the neighbours of each row.
    kind == "dense" also: `csr_ptr` (V+1,) int32, `csr_col` (nnz,) int32,
        `csr_val` (nnz,), the ELL form's nonzero entries row by row
        (`dense_rows`, derived at pack and load time, not saved).
    """

    dense: torch.Tensor = _empty()
    band_val: torch.Tensor = _empty()
    kind: str = "dense"
    num_vertices: int = 0
    block_size: int = 128
    band_k: int = 0
    blk_col: torch.Tensor = _empty(dtype=torch.int64)
    blk_val: torch.Tensor = _empty()
    ell_idx: torch.Tensor = _empty(dtype=torch.int64)
    ell_w: torch.Tensor = _empty()
    strip_val: torch.Tensor = _empty(0, 0)
    strip_off: torch.Tensor = _empty(dtype=torch.int32)
    strip_h: int = 0
    band_bw: int = 0
    window_val: torch.Tensor = _empty(0, 0)
    window_off: torch.Tensor = _empty(dtype=torch.int32)
    csr_ptr: torch.Tensor = _empty(dtype=torch.int32)
    csr_col: torch.Tensor = _empty(dtype=torch.int32)
    csr_val: torch.Tensor = _empty()

    @property
    def padded_vertices(self) -> int:
        if self.kind == "band":
            return int(self.band_val.shape[1]) * self.block_size
        if self.kind == "halo":  # this rank's rows
            return int(self.band_val.shape[1] - 2 * self.band_k) * self.block_size
        return self.num_vertices

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "LevelOperator":
        """Move to `device`; `dtype` casts the operator values (the compute
        dtype of the convs that read them), index tables keep their type."""
        moved = {}
        for f in dataclasses.fields(self):
            t = getattr(self, f.name)
            if torch.is_tensor(t):
                cast = dtype if dtype is not None and t.is_floating_point() else t.dtype
                moved[f.name] = t.to(device=device, dtype=cast)
        return dataclasses.replace(self, **moved)


@dataclass(frozen=True)
class PyramidArtifact:
    """All constants the MeshNet needs for one mesh/joint-set config.

    mesh_ops: per-level operators, finest first.
    joint_op: the joint-graph operator (dense, unrescaled Laplacian).
    up_idx[k]: level-(k+1) device position of each level-k device position.
    vertex_gather: device position of each original mesh vertex.
    faces: (F, 3) triangle faces in original vertex order.
    face_inv[c]: (V, Kc) int64, the faces where vertex v is corner c, padded
        with F (a zero pad row of the cotangent): the ELL-inverse gather VJP
        of `core.losses.face_take`.  Empty tuple: none.
    face_perm, face_sel: the banded face-corner tables of
        `core.losses.face_take3_band`.  The (face, corner) pairs are sorted
        by the corner vertex's T-row device tile and padded to a stride W per
        tile: face_perm (nt*W,) int64 rows of the corner-major (3F+1)-row
        cotangent (pad slots point at the zero row 3F), face_sel (nt, T, W)
        float32 0/1 selectors, so the backward is one batched product
        (nt, T, W) @ (nt, W, 3B).  Empty: none.
    """

    mesh_ops: Tuple[LevelOperator, ...]
    joint_op: LevelOperator
    up_idx: Tuple[torch.Tensor, ...]
    vertex_gather: torch.Tensor
    faces: torch.Tensor
    joint_num: int = 0
    num_vertices: int = 0
    face_inv: Tuple[torch.Tensor, ...] = ()
    face_perm: torch.Tensor = _empty(dtype=torch.int64)
    face_sel: torch.Tensor = _empty(0, 0, 0)

    def to(self, device, dtype: Optional[torch.dtype] = None) -> "PyramidArtifact":
        """Move every tensor to `device`; `dtype` casts the Laplacians only
        (index tensors keep their integer type, and face_sel stays float32:
        the face backward's product is float32)."""
        return dataclasses.replace(
            self,
            mesh_ops=tuple(op.to(device, dtype) for op in self.mesh_ops),
            joint_op=self.joint_op.to(device, dtype),
            up_idx=tuple(u.to(device) for u in self.up_idx),
            vertex_gather=self.vertex_gather.to(device),
            faces=self.faces.to(device),
            face_inv=tuple(t.to(device) for t in self.face_inv),
            face_perm=self.face_perm.to(device),
            face_sel=self.face_sel.to(device),
        )


def _pack_ell(L: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V) sparse matrix -> (idx, w) (V, D), D the widest row; row v's
    padded entries point at v with weight 0."""
    L = sp.csr_matrix(L)
    V = L.shape[0]
    widths = np.diff(L.indptr)
    D = max(int(widths.max()) if V else 1, 1)
    idx = np.tile(np.arange(V, dtype=np.int64)[:, None], (1, D))
    w = np.zeros((V, D), dtype=np.float32)
    rows = np.repeat(np.arange(V), widths)
    slot = np.arange(L.nnz) - L.indptr[rows]
    idx[rows, slot] = L.indices
    w[rows, slot] = L.data
    return idx, w


def dense_rows(ell_idx: torch.Tensor, ell_w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A dense level's row-compressed table from its ELL form: csr_ptr
    (V+1,) int32, csr_col (nnz,) int32 and csr_val (nnz,) float32, each
    row's entries of nonzero weight in ELL order.  `ops.dense_cheby` runs
    the backward of its hops as the same hops (the VJP of L x is L^T g), so
    L must be symmetric: raises ValueError where an entry differs from its
    transpose by more than float32 rounding."""
    idx, w = ell_idx.cpu().numpy(), ell_w.detach().cpu().float().numpy()
    V = idx.shape[0]
    keep = w != 0
    rows = np.repeat(np.arange(V), keep.sum(1))
    L = sp.csr_matrix((w[keep].astype(np.float64), (rows, idx[keep])), shape=(V, V))
    gap = abs(L - L.T)
    if gap.nnz and (gap > 1e-6 * abs(L).maximum(abs(L.T))).nnz:
        raise ValueError(f"the dense level's Laplacian ({V} vertices) is not symmetric: "
                         f"max |L - L^T| = {gap.max()}")
    ptr = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int32)
    return dict(csr_ptr=torch.from_numpy(ptr),
                csr_col=torch.from_numpy(idx[keep].astype(np.int32)),
                csr_val=torch.from_numpy(w[keep].astype(np.float32)))


def _pack_bcsr(L: sp.csr_matrix, T: int) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V) sparse matrix -> padded BCSR (blk_col (nt, maxb), blk_val
    (nt, maxb, T, T)): each row tile's nonzero blocks by column tile."""
    coo = sp.csr_matrix(L).tocoo()
    nt = _cdiv(L.shape[0], T)
    key = (coo.row // T) * nt + coo.col // T
    pairs = np.unique(key)
    pt = pairs // nt
    counts = np.bincount(pt, minlength=nt)
    maxb = max(int(counts.max()) if len(pairs) else 1, 1)
    slot = np.arange(len(pairs)) - np.concatenate([[0], np.cumsum(counts)[:-1]])[pt]
    blk_col = np.zeros((nt, maxb), dtype=np.int64)
    blk_col[pt, slot] = pairs % nt
    blk_val = np.zeros((nt, maxb, T, T), dtype=np.float32)
    blk_val[coo.row // T, slot[np.searchsorted(pairs, key)], coo.row % T,
            coo.col % T] = coo.data
    return blk_col, blk_val


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


def strip_offset(t, h: int, W: int, Vp: int, align: int = 16):
    """Window start of h-row tile t (an int or an array of them) in the strip
    layout: a width-W window centred on the tile, floor-aligned to `align`
    rows, clamped in bounds.  The one formula of the offsets: `_pack_strip`
    places the entries by it and `strip_off` holds its values."""
    o = (t * h + (h - W) // 2) // align * align
    return np.clip(o, 0, Vp - W)


def window_offsets(nt: int, k: int, T: int) -> np.ndarray:
    """s_j = clip((j - k) T, 0, nt*T - (2k+1) T) for the nt row tiles."""
    return np.clip((np.arange(nt) - k) * T, 0, (nt - 2 * k - 1) * T).astype(np.int32)


def window_cat(band_val: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2k+1, nt, T, T) block band -> the sliding-window form (win (nt*T,
    (2k+1)*T), offsets (nt,) int32; `ops.window_cheby`), on band_val's
    device and in its dtype."""
    nbd, nt, T, _ = band_val.shape
    k = nbd // 2
    if nt < nbd:
        raise ValueError(f"the window form needs nt >= 2k+1 tiles, got nt={nt}, k={k}")
    cat = band_val.permute(1, 2, 0, 3).reshape(nt, T, nbd * T)
    win = cat.clone()
    for j in range(k):  # top edge: shift left by (k - j) tiles
        sh = (k - j) * T
        win[j] = torch.nn.functional.pad(cat[j, :, sh:], (0, sh))
    for j in range(nt - k, nt):  # bottom edge: shift right
        sh = (j + k + 1 - nt) * T
        win[j] = torch.nn.functional.pad(cat[j, :, :nbd * T - sh], (sh, 0))
    off = torch.from_numpy(window_offsets(nt, k, T)).to(band_val.device)
    return win.reshape(nt * T, nbd * T), off


def _window_form(band_val: torch.Tensor, band_k: int) -> Dict[str, torch.Tensor]:
    """A band level's window-form fields; none under 2*band_k+1 row tiles."""
    if band_val.shape[1] < 2 * band_k + 1:
        return {}
    win, off = window_cat(band_val)
    return dict(window_val=win, window_off=off)


def _pack_strip(L: sp.csr_matrix, T: int, nt: int, h: int,
                align: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """(V, V) sparse matrix -> (strip_val (nt*T, W), offsets (nt*T // h,)):
    strip_val[r, j] = L[r, o_t + j] for t = r // h.  W is the smallest
    multiple of `align` (>= h + 2 * scalar bandwidth) that covers every
    tile's nonzeros after the offsets' alignment; the rows are padded to the
    band pack's nt*T."""
    coo = sp.csr_matrix(L).tocoo()
    Vp = nt * T
    assert Vp % h == 0, (Vp, h)
    b = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0
    W = min(_cdiv(h + 2 * b, align) * align, Vp)
    tiles = np.arange(Vp // h)
    while True:
        offs = strip_offset(tiles, h, W, Vp, align)
        rel = coo.col - offs[coo.row // h]
        if W >= Vp or ((rel >= 0) & (rel < W)).all():
            break
        W = min(W + align, Vp)
    strip = np.zeros((Vp, W), dtype=np.float32)
    strip[coo.row, rel] = coo.data
    return strip, offs.astype(np.int32)


def _make_level_op(L: sp.csr_matrix, kind: str, block_size: int,
                   strip_h: int = 0) -> LevelOperator:
    L = sp.csr_matrix(L, dtype=np.float64)
    V = L.shape[0]
    ell_idx, ell_w = _pack_ell(L)
    common = dict(kind=kind, num_vertices=V, block_size=block_size,
                  ell_idx=torch.from_numpy(ell_idx), ell_w=torch.from_numpy(ell_w))
    if kind == "dense":
        return LevelOperator(dense=torch.from_numpy(L.toarray().astype(np.float32)),
                             **dense_rows(common["ell_idx"], common["ell_w"]), **common)
    if kind == "bcsr":
        blk_col, blk_val = _pack_bcsr(L, block_size)
        return LevelOperator(blk_col=torch.from_numpy(blk_col),
                             blk_val=torch.from_numpy(blk_val), **common)
    if kind != "band":
        raise ValueError(f"unknown level kind {kind!r}")
    band_val, band_k = _pack_band(L, block_size)
    coo = L.tocoo()
    strip = {}
    nt = band_val.shape[1]
    if strip_h and nt * block_size % strip_h == 0:
        strip_val, offs = _pack_strip(L, block_size, nt, strip_h)
        strip = dict(strip_val=torch.from_numpy(strip_val),
                     strip_off=torch.from_numpy(offs), strip_h=strip_h)
    band = torch.from_numpy(band_val)
    return LevelOperator(
        band_val=band, band_k=band_k,
        band_bw=int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0,
        **strip, **_window_form(band, band_k), **common)


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
    ordering: str = "rcm",
    block_size: int = 128,
    dense_threshold: int = 768,
    sparse_kind: str = "band",
    strip_h: int = 128,
    device: str | torch.device | None = "cuda",
) -> PyramidArtifact:
    """Pack a host pyramid into the device artifact (float32 operators).

    ordering: "rcm" reorders each level for minimal bandwidth (the band
        layout needs it); "tree" keeps the reference's binary-tree order,
        fake slots included, and band levels become BCSR.
    Levels with V <= dense_threshold are stored dense, the others as
    `sparse_kind` ("band", with the strip form of `strip_h`-row tiles, 0:
    none; or "bcsr", whose tile is the largest of block_size, 64, 32 that
    divides V, else block_size).
    Under "rcm" the binary-tree padding vertices of the reference pyramid,
    isolated in every level's graph, are dropped on all levels but the
    coarsest (whose padded layout fixes the FC layer's output size)."""
    if ordering not in ("rcm", "tree"):
        raise ValueError(f"ordering={ordering!r}: expected 'rcm' or 'tree'")
    if sparse_kind not in ("band", "bcsr"):
        raise ValueError(f"sparse_kind={sparse_kind!r}: expected 'band' or 'bcsr'")
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
        if ordering == "rcm" and k < n_levels - 1:
            keep = np.flatnonzero(np.asarray(pyr.orders[k]) < real_sizes[k])
        else:
            keep = np.arange(P, dtype=np.int64)
        if ordering == "rcm" and len(keep) > dense_threshold:
            adj = sp.csr_matrix(pyr.mesh_adjacencies[k])[keep][:, keep]
            rho = _min_bandwidth_order(adj, block_size)
        else:
            rho = np.arange(len(keep), dtype=np.int64)
        layouts.append(keep[rho])

    mesh_ops = []
    for k in range(n_levels):
        lay = layouts[k]
        L = sp.csr_matrix(pyr.mesh_laplacians[k])[lay][:, lay]
        V = L.shape[0]
        kind = "dense" if V <= dense_threshold else sparse_kind
        if kind == "band" and ordering != "rcm":
            kind = "bcsr"  # the band layout needs the bandwidth-minimized order
        T = block_size
        if kind == "bcsr":
            T = next((c for c in (block_size, 64, 32) if V % c == 0), block_size)
        mesh_ops.append(_make_level_op(L, kind, T, strip_h=strip_h))
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
    vertex_gather = pos0[pyr.vertex_slot]
    faces_np = (np.asarray(faces, dtype=np.int64) if faces is not None
                else np.zeros((0, 3), np.int64))
    face_perm, face_sel = face_band_tables(faces_np, vertex_gather, pyr.num_vertices,
                                           block_size)
    return PyramidArtifact(
        mesh_ops=tuple(mesh_ops),
        joint_op=joint_op,
        up_idx=tuple(up_idx),
        vertex_gather=torch.from_numpy(vertex_gather),
        faces=torch.from_numpy(faces_np),
        joint_num=pyr.joint_num,
        num_vertices=pyr.num_vertices,
        face_inv=tuple(torch.from_numpy(t)
                       for t in face_inverse_tables(faces_np, pyr.num_vertices)),
        face_perm=torch.from_numpy(face_perm),
        face_sel=torch.from_numpy(face_sel),
    ).to(dev)


def face_band_tables(faces_np: np.ndarray, vertex_gather: np.ndarray, num_v: int,
                     T: int = 128, max_w: int = 1536
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The banded face-corner tables (see `PyramidArtifact`).

    faces_np: (F, 3) original vertex ids; vertex_gather: the device position
    of each original vertex.  Returns (face_perm (nt*W,) int64, face_sel
    (nt, T, W) float32), empty when there are no faces or a tile would need
    W > max_w."""
    F = faces_np.shape[0]
    empty = (np.zeros((0,), np.int64), np.zeros((0, 0, 0), np.float32))
    if F == 0:
        return empty
    dev = np.asarray(vertex_gather)[faces_np]          # (F, 3) device positions
    # tree-ordered artifacts keep fake slots: device positions run past
    # num_v, so the tile grid covers the largest position
    nt = _cdiv(max(num_v, int(dev.max()) + 1), T)
    # corner-major cotangent row of (face f, corner c): c*F + f
    rows = (np.arange(3)[None, :] * F + np.arange(F)[:, None]).reshape(-1)
    pos = dev.reshape(-1)
    order = np.argsort(pos, kind="stable")
    pos_s, rows_s = pos[order], rows[order]
    tiles = pos_s // T
    counts = np.bincount(tiles, minlength=nt)
    W = _cdiv(max(int(counts.max()), 1), 128) * 128
    if W > max_w:
        import warnings
        warnings.warn(f"face_band_tables: per-tile face count {counts.max()} needs "
                      f"W > {max_w}; no face tables")
        return empty
    perm = np.full((nt * W,), 3 * F, np.int64)        # pad -> the zero row
    sel = np.zeros((nt, T, W), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(pos_s)) - starts[tiles]       # slot within its tile
    perm[tiles * W + slot] = rows_s
    sel[tiles, pos_s % T, slot] = 1.0
    return perm, sel


def face_inverse_tables(faces_np: np.ndarray, num_v: int) -> Tuple[np.ndarray, ...]:
    """Per-corner ELL inverse of the face list: table[c][v] lists the faces
    where vertex v is corner c, padded with F (the cotangent's zero pad
    row); int64."""
    F = faces_np.shape[0]
    if F == 0:
        return ()
    out = []
    for c in range(3):
        col = faces_np[:, c].astype(np.int64)
        order = np.argsort(col, kind="stable")
        counts = np.bincount(col, minlength=num_v)
        K = max(int(counts.max()), 1)
        tab = np.full((num_v, K), F, np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(F) - starts[col[order]]
        tab[col[order], pos] = order
        out.append(tab)
    return tuple(out)


_OP_ARRAYS = ("dense", "blk_col", "blk_val", "band_val", "ell_idx", "ell_w", "strip_val")
_INT_ARRAYS = ("blk_col", "ell_idx")


def _np(t: torch.Tensor, index: bool = False) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.int32) if index else t.float()).numpy()


def save_artifact(path: str, art: PyramidArtifact) -> None:
    """Write `art` to an npz in the JAX package's format (index arrays int32,
    operator values float32); the JAX `load_artifact` reads it."""
    out: Dict[str, np.ndarray] = {
        "meta/num_levels": np.int64(len(art.mesh_ops)),
        "meta/joint_num": np.int64(art.joint_num),
        "meta/num_vertices": np.int64(art.num_vertices),
        "vertex_gather": _np(art.vertex_gather, True),
        "faces": _np(art.faces, True),
    }

    def put(prefix: str, op: LevelOperator):
        out[f"{prefix}/kind"] = np.bytes_(op.kind)
        for f in ("num_vertices", "block_size", "band_k", "strip_h", "band_bw"):
            out[f"{prefix}/{f}"] = np.int64(getattr(op, f))
        for f in _OP_ARRAYS:
            out[f"{prefix}/{f}"] = _np(getattr(op, f), f in _INT_ARRAYS)

    for k, op in enumerate(art.mesh_ops):
        put(f"mesh/{k}", op)
    put("joint", art.joint_op)
    for k, up in enumerate(art.up_idx):
        out[f"up/{k}"] = _np(up, True)
    for c, tab in enumerate(art.face_inv):
        out[f"face_inv/{c}"] = _np(tab, True)
    out["face_perm"] = _np(art.face_perm, True)
    out["face_sel"] = _np(art.face_sel)
    np.savez_compressed(path, **out)


def load_artifact(path: str, *, device: str | torch.device | None = "cuda"
                  ) -> PyramidArtifact:
    """Read an npz written by `save_artifact` or by the JAX package; index
    tensors become int64, operators and face_sel float32."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)

    def arr(key: str, index: bool = False) -> torch.Tensor:
        a = z[key]
        return torch.from_numpy(a.astype(np.int64 if index else np.float32))

    def get(prefix: str) -> LevelOperator:
        meta = {f: int(z[f"{prefix}/{f}"]) if f"{prefix}/{f}" in z else 0
                for f in ("num_vertices", "block_size", "band_k", "strip_h", "band_bw")}
        fields = {f: arr(f"{prefix}/{f}", f in _INT_ARRAYS) for f in _OP_ARRAYS
                  if f"{prefix}/{f}" in z}
        if meta["strip_h"]:
            Vp, W = fields["strip_val"].shape
            fields["strip_off"] = torch.from_numpy(strip_offset(
                np.arange(Vp // meta["strip_h"]), meta["strip_h"], W, Vp
            ).astype(np.int32))
        kind = bytes(z[f"{prefix}/kind"]).decode()
        if kind == "band":
            fields.update(_window_form(fields["band_val"], meta["band_k"]))
        if kind == "dense":
            fields.update(dense_rows(fields["ell_idx"], fields["ell_w"]))
        return LevelOperator(kind=kind, **meta, **fields)

    n = int(z["meta/num_levels"])
    return PyramidArtifact(
        mesh_ops=tuple(get(f"mesh/{k}") for k in range(n)),
        joint_op=get("joint"),
        up_idx=tuple(arr(f"up/{k}", True) for k in range(n - 1)),
        vertex_gather=arr("vertex_gather", True),
        faces=arr("faces", True),
        joint_num=int(z["meta/joint_num"]),
        num_vertices=int(z["meta/num_vertices"]),
        face_inv=tuple(arr(f"face_inv/{c}", True) for c in range(3)
                       if f"face_inv/{c}" in z),
        face_perm=(arr("face_perm", True) if "face_perm" in z
                   else torch.zeros(0, dtype=torch.int64)),
        face_sel=(arr("face_sel") if "face_sel" in z else torch.zeros(0, 0, 0)),
    ).to(dev)
