"""PyTorch port: the CPU side of the float32 hop engine (csrc/band_hop_f32.cuh),
which computes the hops of every float32 instance by exact FMAs over each
warp's list of the band's nonzeros.

- `ops.hop.hop_nonzeros`, the mirror of the kernel's list (rows in order,
  columns in order within a row, entries at source rows outside [0, V)
  dropped, batches of F32_LIST_CAP): on the stand-in SMPL and MANO pyramids
  every band level fits one batch (173 entries a warp at most on SMPL's
  6890 level), each list holds exactly the level's nonzeros of its rows,
  the strip form (64-, 128- and 256-row strip tiles) gives the block band's
  lists, the synthetic band_k 2 level takes the batches the plan says and a
  dense band block several.
- A numpy float32 emulation of the kernel's arithmetic (per row, one FMA
  per entry in list order from 0, then the epilogue's IEEE multiplies and
  adds) against `hop_plain` at every SMPL band level and for every
  epilogue (relative L2 <= 1e-6), and against the JAX package's
  `banded_hop` (`_hop_call`, Pallas in interpret mode), as
  tests/test_torch_hop.py runs it.

The kernel itself runs only on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pose2mesh_release_tpu.ops import pallas_cheby as pc
from pose2mesh_release_tpu_torch import deploy
from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36, MANO_SET
from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
from pose2mesh_release_tpu_torch.ops import hop as hp

import chip_smoke
from test_torch_train_kernels import OPS

T = 128
EMULATION_TOL = 1e-6
# SMPL's band levels at the deploy pyramid's dense threshold
SMPL_LEVELS = (6890, 3475, 1849, 981)


@pytest.fixture(scope="module")
def pyramids():
    cpu = torch.device("cpu")
    return {"smpl": deploy.build_artifact(SMPL().face, HUMAN36, 9, cpu),
            "mano": deploy.build_artifact(MANO().face, MANO_SET, 6, cpu)}


def band_ops(art) -> dict:
    return {op.num_vertices: op for op in art.mesh_ops if op.kind == "band"}


def lists(layout, band_val, V) -> list:
    return [hp.hop_nonzeros(layout, band_val, t, w, V)
            for t in range(layout.nt) for w in range(8)]


def to_csr(band_val, V) -> sp.csr_matrix:
    """The operator the block band (2k+1, nt, T, T) holds, (V, V)."""
    bv = np.asarray(band_val, dtype=np.float32)
    nbd = bv.shape[0]
    d, t, r, c = np.nonzero(bv)
    row, col = t * T + r, (t + d - nbd // 2) * T + c
    keep = (row < V) & (col >= 0) & (col < V)
    return sp.csr_matrix((bv[d, t, r, c][keep], (row[keep], col[keep])), shape=(V, V))


@pytest.mark.parametrize("model", ["smpl", "mano"])
def test_every_level_fits_one_batch(pyramids, model):
    """Each warp's list at every band level of the stand-in pyramids fits
    one batch of F32_LIST_CAP entries; the lists hold the level's nonzeros
    exactly once; SMPL's 6890 level peaks at 173 entries a warp."""
    for V, op in band_ops(pyramids[model]).items():
        got = lists(hp.hop_layout(op.band_val.shape[1], op.band_k), op.band_val, V)
        assert all(n.batches == 1 and n.roff[-1] <= hp.F32_LIST_CAP for n in got), V
        assert sum(n.roff[-1] for n in got) == int(torch.count_nonzero(op.band_val)), V
        if (model, V) == ("smpl", 6890):
            assert max(n.roff[-1] for n in got) == 173


@pytest.mark.parametrize("V", SMPL_LEVELS)
def test_list_order_is_rows_then_columns(pyramids, V):
    """A warp's entries: its rows in order, each row's nonzero columns
    ascending, the values of L; roff delimits the rows (17 offsets)."""
    op = band_ops(pyramids["smpl"])[V]
    nt = op.band_val.shape[1]
    L = to_csr(op.band_val.numpy(), V)
    for t in range(nt):
        for w in range(8):
            n = hp.hop_nonzeros(hp.hop_layout(nt, op.band_k), op.band_val, t, w, V)
            assert len(n.roff) == 17 and list(n.roff) == sorted(n.roff)
            for r in range(16):
                v = t * T + 16 * w + r
                lo, hi = n.roff[r], n.roff[r + 1]
                if v >= V:
                    assert lo == hi
                    continue
                row = L.getrow(v)
                order = np.argsort(row.indices)
                np.testing.assert_array_equal(n.src[lo:hi], row.indices[order])
                np.testing.assert_array_equal(n.val[lo:hi], row.data[order])


@pytest.mark.parametrize("h", [64, 128, 256])
@pytest.mark.parametrize("V", [6890, 3475])
def test_strip_form_lists_equal_the_block_bands(pyramids, V, h):
    """The strip form at h-row strip tiles (the engine's strip layout through
    its offsets) gives every warp the block band's list."""
    op = band_ops(pyramids["smpl"])[V]
    nt = op.band_val.shape[1]
    so = _make_level_op(to_csr(op.band_val.numpy(), V), "band", T, strip_h=h)
    strip = hp.hop_layout(nt, op.band_k, off=so.strip_off.tolist(), h=h,
                          wd=so.strip_val.shape[1])
    for a, b in zip(lists(hp.hop_layout(nt, op.band_k), op.band_val, V),
                    lists(strip, so.strip_val, op.padded_vertices)):
        assert a.roff == b.roff
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.val, b.val)


def test_band_k2_levels_take_the_plans_batches():
    """The synthetic band_k 2 level fits one batch a warp; a dense 128 x 128
    band block (two of them in row tile 1, as the card's tests shape it)
    gives its warps 16 rows x 256 entries, in ceil(4096 / cap) batches of
    the plan's capacity."""
    op = chip_smoke.k2_level(3475)
    nt = op.band_val.shape[1]
    lay = hp.hop_layout(nt, 2)
    got = lists(lay, op.band_val, op.num_vertices)
    assert {n.batches for n in got} == {1}
    plan = hp.hop_plan(nt, hp.band_span(2), 64 * 128, 132, 4)
    assert plan.cap == hp.F32_LIST_CAP
    band = op.band_val.clone()
    band[1:3, 1] = torch.randn(2, T, T, generator=torch.Generator().manual_seed(0))
    dense = hp.hop_nonzeros(lay, band, 1, 3, op.num_vertices)
    assert dense.roff[-1] >= 16 * 256
    assert dense.batches == -(-dense.roff[-1] // plan.cap) > 1


def test_entries_outside_the_rows_are_dropped():
    """Values at source rows >= V (a band's pad columns) or < 0 (a strip
    layout whose window starts above row 0) give no entry; rows >= V none."""
    V, nt = 200, 2
    band = torch.zeros(3, nt, T, T)
    band[1, 1, 0, :] = 1.0  # row 128 over columns 128 .. 255: 200 .. 255 are pad
    band[1, 1, 100, 5] = 2.0  # row 228 >= V
    n = hp.hop_nonzeros(hp.hop_layout(nt, 1), band, 1, 0, V)
    np.testing.assert_array_equal(n.src, np.arange(128, V))
    assert n.roff[1] == V - 128 and n.roff[-1] == V - 128
    assert hp.hop_nonzeros(hp.hop_layout(nt, 1), band, 1, 6, V).roff[-1] == 0
    strip = torch.ones(nt * T, 32)
    lay = hp.HopLayout(32, tuple((-16,) * 8 for _ in range(nt)), 2, 1, True)
    n = hp.hop_nonzeros(lay, strip, 0, 0, V)
    assert n.roff[1] == 16 and set(n.src[:16].tolist()) == set(range(16))


# ---- the kernel's arithmetic, emulated in numpy --------------------------

def fma32(a, b, c):
    """float32 fma(a, b, c): the product exact in float64, one rounding of
    the sum (to float64, then to float32: equal to the single rounding
    but for rare double-rounding ties)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(
        np.float32)


def emulate(layout, band_val, x, V, alpha=1.0, beta=0.0, add=None, relu=False, post=None):
    """y (V, C) as the float32 engine computes it: each row's sum from 0,
    one FMA per entry of its warp's list in order, then y = alpha * acc
    (+ beta * add) (ReLU) (+ post), each step rounded to float32."""
    rows, pos, src, val = [], [], [], []
    for (t, w), n in zip(np.ndindex(layout.nt, 8), lists(layout, band_val, V)):
        r = np.repeat(np.arange(16), np.diff(n.roff))
        rows.append(t * T + 16 * w + r)
        pos.append(np.arange(n.roff[-1]) - np.asarray(n.roff)[r])  # the entry's place in its row
        src.append(n.src)
        val.append(n.val)
    rows, pos, src, val = (np.concatenate(a) for a in (rows, pos, src, val))
    acc = np.zeros((V, x.shape[1]), dtype=np.float32)
    for k in range(int(pos.max()) + 1):
        sel = pos == k
        acc[rows[sel]] = fma32(val[sel][:, None], x[src[sel]], acc[rows[sel]])
    y = (np.float32(alpha) * acc).astype(np.float32)
    if add is not None:
        y = (y + (np.float32(beta) * add[:V]).astype(np.float32)).astype(np.float32)
    if relu:
        y = np.maximum(y, np.float32(0))
    if post is not None:
        y = (y + post[:V]).astype(np.float32)
    return y


def plain_epilogue(band_val, x, alpha=1.0, beta=0.0, add=None, relu=False, post=None):
    y = alpha * hp.hop_plain(torch.from_numpy(np.asarray(band_val)), torch.from_numpy(x))
    if add is not None:
        y = y + beta * torch.from_numpy(add)
    if relu:
        y = torch.relu(y)
    if post is not None:
        y = y + torch.from_numpy(post)
    return y.numpy()


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (alpha, beta, add, relu, post) of each epilogue: K4; the second hop of
# K1, K2 and the group conv (kHopAdd, 2 L z1 - x); the commuted conv's
# second hop (kHopF32Add with the ReLU); the strip conv's commuted order with
# a skip (kHopSkipAdd and kHopSkipProj alike: a float32 operand after the ReLU)
EPILOGUES = {"hop": (1.0, 0.0, False, False, False),
             "add": (2.0, -1.0, True, False, False),
             "f32_add_relu": (1.0, 1.0, True, True, False),
             "post": (1.0, 1.0, True, True, True)}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("V", SMPL_LEVELS)
def test_emulation_matches_hop_plain(pyramids, V, epilogue):
    """The kernel's order and epilogue, emulated, within 1e-6 of the plain
    version at each SMPL band level (C = 16 columns)."""
    op = band_ops(pyramids["smpl"])[V]
    alpha, beta, with_add, relu, with_post = EPILOGUES[epilogue]
    rng = np.random.default_rng(V)
    x, add, post = (rng.standard_normal((V, 16)).astype(np.float32) for _ in range(3))
    kw = dict(alpha=alpha, beta=beta, add=add if with_add else None, relu=relu,
              post=post if with_post else None)
    band = op.band_val.numpy()
    got = emulate(hp.hop_layout(band.shape[1], op.band_k), band, x, V, **kw)
    assert rel_l2(got, plain_epilogue(band, x, **kw)) <= EMULATION_TOL


@pytest.mark.parametrize("op_name", sorted(OPS))
def test_emulation_matches_the_jax_hop(op_name):
    """The emulated kernel == the JAX package's banded_hop (`_hop_call`,
    Pallas in interpret mode) on tests/test_torch_hop.py's operators."""
    op = OPS[op_name]()
    V = op.num_vertices
    x = np.random.default_rng(3).standard_normal((V, 2, 16)).astype(np.float32)
    jax.clear_caches()
    want = np.asarray(jax.jit(lambda u: pc.banded_hop(op, u))(jnp.asarray(x)))
    band = np.asarray(op.band_val)
    got = emulate(hp.hop_layout(band.shape[1], band.shape[0] // 2), band, x.reshape(V, -1), V)
    assert rel_l2(got, want.reshape(V, -1)) <= EMULATION_TOL
