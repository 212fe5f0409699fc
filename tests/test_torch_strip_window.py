"""PyTorch port: the strip (K5) and window (K6) deploy convs' plain versions
against the JAX package's Pallas kernels `fused_conv_flat_strip` and
`fused_conv_flat_window` (interpret mode), CPU f32, plus `window_cat`, the
flat_impl routing and the wrappers' CPU rules; and the hop engine's
addressing of the strip form and of the window form, which is the strip
form with T-row tiles (`hop.hop_layout`, the map csrc/band_hop.cuh reads the
operator through), walked tile by tile as the engine walks it through its
staged source rows, against the JAX `_pack_strip` / `strip_offset`
placement, `_window_cat` and block band hop; the strip and band forms' equal
sets of nonzero 16 x 16 sub-tiles; and the engine's ring sized from the
staged span.

Operators: the synthetic band of tests/test_pallas.py:129 (768 rows at
band_k 1 and 2) in the strip form of 64-, 128- and 256-row tiles.  Every
epilogue (ReLU, skip add, skip projection, the final conv without ReLU) in
both strip orders.  Tolerance rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose2mesh_release_tpu.graphs.artifact import _make_level_op as jax_level_op
from pose2mesh_release_tpu.graphs.artifact import strip_offset as jax_strip_offset
from pose2mesh_release_tpu.ops.pallas_strip import fused_conv_flat_strip
from pose2mesh_release_tpu.ops.pallas_window import _window_cat, fused_conv_flat_window
from pose2mesh_release_tpu.ops.spmm import spmm_band as jax_spmm_band
from pose2mesh_release_tpu_torch.graphs.artifact import _make_level_op
from pose2mesh_release_tpu_torch.ops import hop as hp
from pose2mesh_release_tpu_torch.ops import strip_cheby as sc
from pose2mesh_release_tpu_torch.ops import window_cheby as wc
from pose2mesh_release_tpu_torch.models.meshnet import flat_route

from test_torch_fused_cheby import band_laplacian

TOL = dict(rtol=1e-4, atol=1e-5)
B = 2
EPILOGUES = ("relu", "skip_add", "skip_proj", "final")


def level(k: int, strip_h: int = 128):
    """(JAX operator, port operator) of band_laplacian(k)."""
    L = band_laplacian(k)
    return (jax_level_op(L, "band", 128, strip_h=strip_h),
            _make_level_op(L, "band", 128, strip_h=strip_h))


def conv_inputs(Vp, F, Fo, epilogue, seed):
    """numpy inputs, the JAX wrapper's keywords (flat layout) and the port's."""
    rng = np.random.default_rng(seed)
    Fs = 24 if epilogue == "skip_proj" else Fo
    x = (rng.standard_normal((Vp, B, F)) * 0.3).astype(np.float32)
    W = (rng.standard_normal((3 * F, Fo)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(Fo) * 0.1).astype(np.float32)
    skip = (rng.standard_normal((Vp, B, Fs)) * 0.3).astype(np.float32)
    skip_w = (rng.standard_normal((Fs, Fo)) * 0.1).astype(np.float32)
    jkw, tkw = {"relu": epilogue != "final"}, {"relu": epilogue != "final"}
    if epilogue in ("skip_add", "skip_proj"):
        jkw["skip"] = jnp.asarray(skip.reshape(Vp, -1))
        tkw["skip"] = torch.from_numpy(skip)
    if epilogue == "skip_proj":
        jkw["skip_w"] = jnp.asarray(skip_w)
        tkw["skip_w"] = torch.from_numpy(skip_w)
    if epilogue == "final":
        jkw["out_3d"] = True
    return x, W, b, jkw, tkw


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("strip_h", [64, 128])
@pytest.mark.parametrize("mode", ["basis", "commuted"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_strip_conv_plain_matches_pallas(k, strip_h, mode, epilogue, monkeypatch):
    op_j, op_t = level(k, strip_h)
    Vp, V = op_t.padded_vertices, op_t.num_vertices
    assert op_t.strip_h == strip_h and op_t.strip_val.shape[1] < (2 * k + 1) * 128
    F, Fo = (32, 48) if mode == "basis" else (48, 16)
    assert sc.strip_mode(F, Fo) == mode
    x, W, b, jkw, tkw = conv_inputs(Vp, F, Fo, epilogue, seed=k + strip_h)
    monkeypatch.setenv("P2M_STRIP_MODE", mode)
    ref = fused_conv_flat_strip(op_j, jnp.asarray(x.reshape(Vp, -1)), B, jnp.asarray(W),
                                jnp.asarray(b), **jkw)
    ref = np.asarray(ref).reshape(Vp, B, Fo)[:V]

    Wt = torch.from_numpy(W)
    if mode == "commuted":  # the wrapper takes the commuted weights formed
        W3 = Wt.reshape(3, F, Fo)
        Wt = torch.cat([W3[0] - W3[2], W3[1], W3[2]])
    got = sc.strip_cheby_conv(op_t.strip_val, op_t.strip_off, strip_h,
                              torch.from_numpy(x), Wt, torch.from_numpy(b), mode=mode,
                              **tkw)
    assert got.shape == (Vp, B, Fo) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_window_conv_plain_matches_pallas(k, epilogue):
    op_j, op_t = level(k)
    Vp, V = op_t.padded_vertices, op_t.num_vertices
    x, W, b, jkw, tkw = conv_inputs(Vp, 32, 48, epilogue, seed=10 + k)
    ref = fused_conv_flat_window(op_j, jnp.asarray(x.reshape(Vp, -1)), B,
                                 jnp.asarray(W), jnp.asarray(b), **jkw)
    ref = np.asarray(ref).reshape(Vp, B, 48)[:V]
    win, woff = wc.window_cat(op_t.band_val)
    got = wc.window_cheby_conv(win, woff, torch.from_numpy(x), torch.from_numpy(W),
                               torch.from_numpy(b), **tkw)
    assert got.shape == (Vp, B, 48)
    np.testing.assert_allclose(got[:V].numpy(), ref, **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_window_cat_matches_jax(k):
    """The sliding-window form equals the JAX `_window_cat` (its shifted edge
    tiles included), and its offsets are the JAX kernel's s_j."""
    op_j, op_t = level(k)
    win, woff = wc.window_cat(op_t.band_val)
    np.testing.assert_array_equal(win.numpy(), np.asarray(_window_cat(op_j.band_val, 128)))
    nt, T = op_t.band_val.shape[1], 128
    want = np.clip(np.arange(nt) * T - k * T, 0, nt * T - (2 * k + 1) * T)
    np.testing.assert_array_equal(woff.numpy(), want)


def square_level(k: int, nt: int):
    """(JAX operator, port operator) of band_laplacian(k, nt): V = nt*T."""
    L = band_laplacian(k, nt=nt)
    op_j, op_t = jax_level_op(L, "band", 128), _make_level_op(L, "band", 128)
    assert op_t.band_k == k and op_t.band_val.shape[1] == nt
    return op_j, op_t


@pytest.mark.parametrize("k,nt", [(1, 3), (1, 4), (2, 5), (2, 7)])
def test_engine_window_addressing_matches_window_offsets(k, nt):
    """hop_layout's map of the window form, the strip layout at h = T: warp
    w's sub-tile j of row tile t starts at win[t*T + 16w, 16j] and multiplies
    x rows woff[t] + 16j .., with woff = window_offsets, every warp of a tile
    staging the same (2k+1) T rows; the block band's map names the same
    operator entries and the same x rows wherever its block is in range."""
    T = 128
    woff = wc.window_offsets(nt, k, T)
    win_l, band_l = hp.hop_layout(nt, k, woff), hp.hop_layout(nt, k)
    assert win_l == hp.hop_layout(nt, k, woff, h=T, wd=(2 * k + 1) * T)
    assert (win_l.strip, win_l.ld, win_l.nsub) == (True, (2 * k + 1) * T, 8 * (2 * k + 1))
    assert (band_l.strip, band_l.ld, band_l.nsub) == (False, T, 8 * (2 * k + 1))
    assert win_l.span == band_l.span == hp.band_span(k)
    _, op = square_level(k, nt)
    win, _ = wc.window_cat(op.band_val)
    flat_win, flat_band = win.reshape(-1), op.band_val.reshape(-1)
    for t in range(nt):
        assert win_l.subtiles(t) == list(range(8 * (2 * k + 1)))
        assert win_l.staged(t) == (int(woff[t]), 8 * (2 * k + 1))
        for w in range(8):
            for j in range(8 * (2 * k + 1)):
                off, src = win_l.subtile(t, w, j)
                assert (off, src) == ((t * T + 16 * w) * (2 * k + 1) * T + 16 * j,
                                      int(woff[t]) + 16 * j)
                if j not in band_l.subtiles(t):
                    continue
                boff, bsrc = band_l.subtile(t, w, j)
                if bsrc != src:  # an edge tile: the window's entries are shifted
                    continue
                rows = torch.arange(16)[:, None] * win_l.ld + torch.arange(16)[None, :]
                brows = torch.arange(16)[:, None] * band_l.ld + torch.arange(16)[None, :]
                assert torch.equal(flat_win[off + rows], flat_band[boff + brows])


STRIP_CASES = [(k, h) for k in (1, 2) for h in (64, 128, 256)]


def strip_level(k: int, h: int):
    """(JAX operator, port operator, offsets) of band_laplacian(k) in the
    strip form of h-row tiles, the offsets from the JAX strip_offset."""
    op_j, op_t = level(k, h)
    Vp, W = op_t.strip_val.shape
    assert op_t.strip_h == h and Vp % h == 0
    off = np.asarray(jax_strip_offset(np.arange(Vp // h), h, W, Vp, 16))
    np.testing.assert_array_equal(op_t.strip_off.numpy(), off)
    np.testing.assert_array_equal(op_t.strip_val.numpy(), np.asarray(op_j.strip_val))
    return op_j, op_t, off


@pytest.mark.parametrize("k,h", STRIP_CASES)
def test_engine_strip_addressing_matches_the_jax_pack(k, h):
    """hop_layout's map of the strip form: warp w's sub-tile j of row tile t
    starts at S[t*T + 16w, 16j] and multiplies x rows off[(t*T + 16w) / h] +
    16j .., and its 16 x 16 entries are L's there, as the JAX `_pack_strip`
    places them by `strip_offset`; every source group lies in the row tile's
    staged span."""
    T = 128
    op_j, op_t, off = strip_level(k, h)
    Vp, W = op_t.strip_val.shape
    lay = hp.hop_layout(Vp // T, k, off, h=h, wd=W)
    assert (lay.strip, lay.ld, lay.nsub) == (True, W, W // 16)
    L = np.zeros((Vp, Vp), np.float32)
    L[:op_t.num_vertices, :op_t.num_vertices] = band_laplacian(k).toarray()
    flat = np.asarray(op_j.strip_val).reshape(-1)
    sub = np.arange(16)[:, None] * W + np.arange(16)[None, :]
    for t in range(Vp // T):
        vmin, groups = lay.staged(t)
        assert groups <= lay.span <= hp.MAX_SPAN
        for w in range(8):
            r0 = t * T + 16 * w
            assert lay.src[t][w] == off[r0 // h]
            assert (lay.src[t][w] - vmin) // 16 + lay.nsub <= groups
            for j in lay.subtiles(t):
                o, src = lay.subtile(t, w, j)
                assert (o, src) == (r0 * W + 16 * j, int(off[r0 // h]) + 16 * j)
                np.testing.assert_array_equal(flat[o + sub], L[r0:r0 + 16, src:src + 16])


def engine_walk(flat, lay: hp.HopLayout, x: np.ndarray) -> np.ndarray:
    """L x as the hop engine walks it: for each row tile t, warp w and
    sub-tile j it reads that is not all zero (at lay.subtile's offset, row
    stride lay.ld), times the 16 x rows of staged group
    (src[t][w] - vmin) / 16 + j of the tile's ring, which starts at x row
    vmin (rows outside x read as zero); float64."""
    T, nt = 128, lay.nt
    flat = flat.double().numpy()
    y = np.zeros((nt * T, x.shape[1]))
    sub = np.arange(16)[:, None] * lay.ld + np.arange(16)[None, :]
    for t in range(nt):
        vmin, groups = lay.staged(t)
        for w in range(8):
            for j in lay.subtiles(t):
                off, src = lay.subtile(t, w, j)
                a = flat[off + sub]
                if not a.any():
                    continue
                g = (lay.src[t][w] - vmin) // 16 + j
                assert 0 <= g < groups
                r = vmin + 16 * g + np.arange(16)
                assert r[0] == src
                ok = (r >= 0) & (r < x.shape[0])
                y[t * T + 16 * w:t * T + 16 * w + 16] += a @ (x[np.clip(r, 0, len(x) - 1)]
                                                              * ok[:, None])
    return y


@pytest.mark.parametrize("k,nt", [(1, 3), (1, 4), (2, 5), (2, 7)])
def test_engine_walk_of_the_window_form_matches_the_jax_hop(k, nt):
    """z = L x walked over the window form (nt = 2k+1 included: every tile an
    edge tile) and over the block band equals the JAX block band hop on the
    JAX `_window_cat`'s operator."""
    op_j, op_t = square_level(k, nt)
    Vp = nt * 128
    x = np.random.default_rng(k + nt).standard_normal((Vp, 6)).astype(np.float32)
    ref = np.asarray(jax_spmm_band(op_j, jnp.asarray(x)))
    win_j = torch.from_numpy(np.asarray(_window_cat(op_j.band_val, 128)).copy())
    woff = wc.window_offsets(nt, k, 128)
    got_win = engine_walk(win_j.reshape(-1), hp.hop_layout(nt, k, woff), x)
    got_band = engine_walk(op_t.band_val.reshape(-1), hp.hop_layout(nt, k), x)
    np.testing.assert_allclose(got_win, ref, **TOL)
    np.testing.assert_allclose(got_band, ref, **TOL)


@pytest.mark.parametrize("k,h", STRIP_CASES)
def test_engine_walk_of_the_strip_form_matches_the_jax_hop(k, h):
    """z = L x walked over the strip form through the staged rows equals the
    JAX block band hop on the same operator."""
    op_j, op_t, off = strip_level(k, h)
    Vp, W = op_t.strip_val.shape
    V = op_t.num_vertices
    x = np.zeros((Vp, 6), np.float32)  # the deploy layout: pad rows zero
    x[:V] = np.random.default_rng(10 * k + h).standard_normal((V, 6))
    ref = np.asarray(jax_spmm_band(op_j, jnp.asarray(x[:V])))
    got = engine_walk(op_t.strip_val.reshape(-1), hp.hop_layout(Vp // 128, k, off, h=h, wd=W),
                      x)
    np.testing.assert_allclose(got[:V], ref, **TOL)
    assert not got[V:].any()


def nonzero_subtiles(flat, lay: hp.HopLayout) -> set:
    """{(row tile, warp, global 16-column group)} of the nonzero sub-tiles
    the engine multiplies."""
    sub = np.arange(16)[:, None] * lay.ld + np.arange(16)[None, :]
    flat = flat.numpy()
    return {(t, w, src // 16) for t in range(lay.nt) for w in range(8)
            for j in lay.subtiles(t)
            for off, src in [lay.subtile(t, w, j)] if flat[off + sub].any()}


@pytest.mark.parametrize("k,h", STRIP_CASES)
def test_strip_and_band_forms_have_the_same_nonzero_subtiles(k, h):
    """Both forms put their columns on one 16-aligned grid (strip offsets are
    multiples of 16, band blocks of 128), so the engine multiplies the same
    nonzero 16 x 16 sub-tiles whichever form it reads."""
    _, op_t, off = strip_level(k, h)
    Vp, W = op_t.strip_val.shape
    nt = Vp // 128
    strip = nonzero_subtiles(op_t.strip_val.reshape(-1), hp.hop_layout(nt, k, off, h=h, wd=W))
    band = nonzero_subtiles(op_t.band_val.reshape(-1), hp.hop_layout(nt, k))
    assert strip == band and len(strip) > 0


@pytest.mark.parametrize("k,h", STRIP_CASES)
def test_hop_plan_sizes_the_ring_from_the_strip_span(k, h):
    """The wrapper's span (strip_cheby.strip_span: W / 16 without reading the
    offsets where h is a multiple of T) is the layout's, and hop_plan's ring
    holds that many 16-row groups; a span over 64 groups is refused."""
    _, op_t, off = strip_level(k, h)
    Vp, W = op_t.strip_val.shape
    lay = hp.hop_layout(Vp // 128, k, off, h=h, wd=W)
    assert sc.strip_span(op_t.strip_off, h, W) == lay.span <= hp.MAX_SPAN
    assert lay.span == W // 16 if h % 128 == 0 else lay.span > W // 16
    for C in (16, 96, 6 * 128):
        p = hp.hop_plan(Vp // 128, lay.span, C, 132)
        assert p.smem == hp.hop_smem(p.cc, lay.span) == 2 * lay.span * 16 * (p.cc + 8) * 2
    with pytest.raises(ValueError):
        hp.hop_plan(Vp // 128, hp.MAX_SPAN + 1, 96, 132)


def test_flat_route_follows_the_jax_dispatch():
    _, op = level(1)
    assert [flat_route(op, i) for i in ("group", "strip", "window")] == \
        ["group", "strip", "window"]
    no_strip = _make_level_op(band_laplacian(1), "band", 128, strip_h=0)
    assert flat_route(no_strip, "strip") == "group"
    small = _make_level_op(band_laplacian(2, nt=4), "band", 128)  # nt 4 < 2k+1
    assert small.band_val.shape[1] < 5 and flat_route(small, "window") == "group"
    with pytest.raises(ValueError):
        flat_route(op, "strips")


def test_cpu_tensors_take_the_plain_path():
    _, op = level(1, 64)
    Vp = op.padded_vertices
    g = torch.Generator().manual_seed(0)
    x = torch.randn(Vp, B, 16, generator=g)
    W, b = torch.randn(48, 16, generator=g) * 0.1, torch.randn(16, generator=g)
    before = (dict(sc.launches), dict(wc.launches))
    y = sc.strip_cheby_conv(op.strip_val, op.strip_off, 64, x, W, b, mode="basis",
                            relu=True, skip=x)
    torch.testing.assert_close(y, sc.strip_cheby_conv_plain(
        op.strip_val, op.strip_off, 64, x, W, b, mode="basis", relu=True, skip=x),
        rtol=0, atol=0)
    win, woff = wc.window_cat(op.band_val)
    yw = wc.window_cheby_conv(win, woff, x, W, b, relu=False)
    torch.testing.assert_close(yw, wc.window_cheby_conv_plain(win, woff, x, W, b,
                                                              relu=False), rtol=0, atol=0)
    assert (dict(sc.launches), dict(wc.launches)) == before
    with pytest.raises(ValueError):  # unknown mode
        sc.strip_cheby_conv(op.strip_val, op.strip_off, 64, x, W, b, mode="auto",
                            relu=True)
    with pytest.raises(ValueError):  # offsets of another tile height
        sc.strip_cheby_conv(op.strip_val, op.strip_off, 128, x, W, b, mode="basis",
                            relu=True)
    with pytest.raises(ValueError):  # skip-add of another width
        wc.window_cheby_conv(win, woff, x, W[:, :8], b[:8], relu=True, skip=x)
