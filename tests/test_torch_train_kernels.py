"""PyTorch port: the training convs' plain versions and autograd Functions
against the JAX package's Pallas kernels (interpret mode, jitted), CPU f32.

K1 (`fused_cheby_conv_train`) in its four forms against the JAX public
wrappers `fused_cheby_project`, `..._stats`, `..._folded` and
`..._folded_stats`, values and gradients (the BatchNorm-like loss of
tests/test_pallas.py::test_fused_stats_kernel_matches), on synthetic band
operators with band_k in {1, 2} and on a packed uv_sphere level whose row
count (770) is not a multiple of the 128-row tile.  K2
(`fused_cheby_conv_bwd`), with and without the fold, against
`_fused_bwd_call`.  Tolerances: rtol 1e-3 as tests/test_pallas.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose2mesh_release_tpu.body.synthetic import uv_sphere
from pose2mesh_release_tpu.graphs.artifact import pack_pyramid
from pose2mesh_release_tpu.graphs.build import build_pyramid
from pose2mesh_release_tpu.ops import pallas_cheby as pc
from pose2mesh_release_tpu_torch.ops import fused_cheby_train as ft

from test_torch_fused_cheby import band_op

B, F, FOUT = 2, 16, 8
TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def sphere_op():
    """The finest level of the uv_sphere(770) pyramid packed as a band (as
    tests/test_pallas.py's band_op fixture): 770 rows in 8 tiles of 128."""
    _, faces = uv_sphere(770)
    pyr = build_pyramid(faces, joint_num=7, skeleton=[(0, 1), (1, 2)], levels=4)
    op = pack_pyramid(pyr, dense_threshold=128, sparse_kind="band").mesh_ops[0]
    assert op.kind == "band" and op.num_vertices % 128
    return op


OPS = {"k1": lambda: band_op(1), "k2": lambda: band_op(2), "sphere770": sphere_op}

JAX_FNS = {
    "plain": pc.fused_cheby_project,
    "stats": pc.fused_cheby_project_stats,
    "folded": pc.fused_cheby_project_folded,
    "folded_stats": pc.fused_cheby_project_folded_stats,
}
PORT_FNS = {
    "plain": ft.fused_cheby_project,
    "stats": ft.fused_cheby_project_stats,
    "folded": ft.fused_cheby_project_folded,
    "folded_stats": ft.fused_cheby_project_folded_stats,
}


def inputs(V, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((V, B, F)).astype(np.float32),
            "W": (rng.standard_normal((3 * F, FOUT)) * 0.1).astype(np.float32),
            "b": (rng.standard_normal(FOUT) * 0.1).astype(np.float32),
            "s": rng.uniform(0.5, 1.5, F).astype(np.float32),
            "c": (rng.standard_normal(F) * 0.1).astype(np.float32)}


def bn_like_loss(xp, y, s1, s2, n):
    """tests/test_pallas.py:469-481: BatchNorm from the sums, then a loss
    reading the normalized y."""
    mean = s1 / n
    var = s2 / n - mean * mean
    var = xp.maximum(var, 0.0 * var)
    yn = (y - mean) / xp.sqrt(var + 1e-5)
    return (yn ** 2).mean() + xp.maximum(yn, 0.0 * yn).sum() * 1e-3


def run_jax(op, variant, a):
    names = ["x", "W", "b"] + (["s", "c"] if "folded" in variant else [])
    fn = JAX_FNS[variant]

    def loss(*args):
        out = fn(op, *args)
        if "stats" in variant:
            y, s1, s2 = out
        else:
            y = out
            s1, s2 = y.sum((0, 1)), (y * y).sum((0, 1))
        return bn_like_loss(jnp, y, s1, s2, y.shape[0] * B), out

    (val, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True))(
            *(jnp.asarray(a[n]) for n in names))
    return float(val), jax.tree.map(np.asarray, out), [np.asarray(g) for g in grads]


def run_port(op, variant, a):
    names = ["x", "W", "b"] + (["s", "c"] if "folded" in variant else [])
    band = torch.tensor(np.asarray(op.band_val))
    args = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    out = PORT_FNS[variant](band, *args)
    if "stats" in variant:
        y, s1, s2 = out
    else:
        y = out
        s1, s2 = y.sum((0, 1)), (y * y).sum((0, 1))
    val = bn_like_loss(torch, y, s1, s2, y.shape[0] * B)
    grads = torch.autograd.grad(val, args)
    out = tuple(o.detach().numpy() for o in out) if isinstance(out, tuple) \
        else out.detach().numpy()
    return float(val.detach()), out, [g.numpy() for g in grads]


@pytest.mark.parametrize("op_name,variant", [
    (o, v) for o in ("k1", "k2") for v in JAX_FNS] + [("sphere770", "folded_stats")])
def test_train_conv_matches_pallas(op_name, variant):
    """Values (y and the stat sums) and the gradients wrt x, W, b (and the
    fold's scale and shift) of the port's autograd Function == jax.grad of
    the JAX wrapper."""
    op = OPS[op_name]()
    a = inputs(op.num_vertices, seed=len(variant) + op.band_k)
    val_j, out_j, g_j = run_jax(op, variant, a)
    val_t, out_t, g_t = run_port(op, variant, a)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-4)
    for got, want in zip(*((out_t, out_j) if "stats" in variant
                          else ((out_t,), (out_j,)))):
        np.testing.assert_allclose(got, want, **TOL)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("op_name", sorted(OPS))
@pytest.mark.parametrize("fold", [False, True])
def test_bwd_plain_matches_pallas(op_name, fold):
    """The plain K2 == `_fused_bwd_call` (interpret): dx, dW basis-major,
    db, and with the fold ds and dc."""
    op = OPS[op_name]()
    V = op.num_vertices
    a = inputs(V, seed=20 + fold)
    g = np.random.default_rng(30).standard_normal((V, B, FOUT)).astype(np.float32)
    in_fold = (jnp.asarray(a["s"]), jnp.asarray(a["c"])) if fold else None
    want = jax.jit(lambda g, x, W, f: pc._fused_bwd_call(
        op.band_val, g, x, W, op.block_size, in_fold=f))(
            jnp.asarray(g), jnp.asarray(a["x"]), jnp.asarray(a["W"]), in_fold)
    tf = (torch.from_numpy(a["s"]), torch.from_numpy(a["c"])) if fold else None
    got = ft.fused_cheby_conv_bwd(torch.tensor(np.asarray(op.band_val)),
                                  torch.from_numpy(g), torch.from_numpy(a["x"]),
                                  torch.from_numpy(a["W"]), in_fold=tf)
    assert len(got) == len(want) == (5 if fold else 3)
    for name, t, j in zip(("dx", "dW", "db", "ds", "dc"), got, want):
        assert t.dtype == torch.float32, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL, err_msg=name)


def test_cpu_tensors_take_the_plain_path():
    """On the CPU the wrappers run the plain versions, launch nothing, and
    check their inputs."""
    op = band_op(1)
    band = torch.tensor(np.asarray(op.band_val))
    a = {k: torch.from_numpy(v) for k, v in inputs(op.num_vertices, seed=3).items()}
    before = dict(ft.launches)
    y, s1, s2 = ft.fused_cheby_conv_train(band, a["x"], a["W"], a["b"],
                                          in_fold=(a["s"], a["c"]), emit_stats=True)
    ref = ft.fused_cheby_conv_train_plain(band, a["x"], a["W"], a["b"],
                                          in_fold=(a["s"], a["c"]), emit_stats=True)
    for got, want in zip((y, s1, s2), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ft.launches == before
    with pytest.raises(ValueError):  # more rows than the operator's tiles
        ft.fused_cheby_conv_train(band, torch.zeros(band.shape[1] * 128 + 1, B, F),
                                  a["W"], a["b"])
    with pytest.raises(ValueError):  # W of the wrong fan-in
        ft.fused_cheby_conv_bwd(band, torch.zeros(op.num_vertices, B, FOUT), a["x"],
                                a["W"][:-1])


class _FakeLib:
    """Records the ctypes signatures a `_*_lib()` loader sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, type("Fn", (), {})())


def _c_parameters():
    """{name: [parameter declaration]} of every extern "C" int function in the
    port's CUDA sources."""
    import re
    from pathlib import Path
    csrc = Path(ft.__file__).resolve().parents[1] / "csrc"
    params = {}
    for src in csrc.glob("*.cu"):
        for name, decl in re.findall(r'extern "C" int (p2m_\w+)\((.*?)\)\s*\{',
                                     src.read_text(), re.S):
            params[name] = [" ".join(p.split()) for p in decl.split(",")]
    return params


def _c_entry_points():
    """{name: [ctypes type per parameter]} of every extern "C" int function in
    the port's CUDA sources."""
    import ctypes
    return {name: [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
            for name, params in _c_parameters().items()}


LOADERS = [
    ("fused_cheby", "_fused_lib"), ("fused_cheby", "_commuted_lib"),
    ("fused_cheby_train", "_train_lib"), ("fused_cheby_train", "_bwd_lib"),
    ("hop", "_hop_lib"), ("strip_cheby", "_strip_lib"), ("dense_cheby", "_lib")]


@pytest.mark.parametrize("module,loader", LOADERS)
def test_ctypes_signatures_match_the_cuda_sources(monkeypatch, module, loader):
    """The argument types each wrapper declares for ctypes are those of the C
    entry point it calls (a wrong count or width would pass pointers as
    32-bit ints on the card)."""
    import importlib
    mod = importlib.import_module(f"pose2mesh_release_tpu_torch.ops.{module}")
    fake = _FakeLib()
    monkeypatch.setattr(mod, "load_library", lambda stem: fake)
    getattr(mod, loader).__wrapped__()
    sigs = _c_entry_points()
    entries = [n for n in fake.fns if not n.endswith("_error_string")]
    assert len(entries) == 1
    assert fake.fns[entries[0]].argtypes == sigs[entries[0]], entries[0]


def test_every_cuda_entry_point_has_a_loader(monkeypatch):
    """Each extern "C" launch function of csrc/ is declared by one loader."""
    import importlib
    declared = set()
    for module, loader in LOADERS:
        mod = importlib.import_module(f"pose2mesh_release_tpu_torch.ops.{module}")
        fake = _FakeLib()
        monkeypatch.setattr(mod, "load_library", lambda stem: fake)
        getattr(mod, loader).__wrapped__()
        declared |= {n for n in fake.fns if not n.endswith("_error_string")}
    assert declared == set(_c_entry_points())


ENTRY_POINTS = ["p2m_fused_cheby_conv", "p2m_fused_cheby_conv_commuted", "p2m_train_conv",
                "p2m_fused_cheby_bwd", "p2m_banded_hop", "p2m_strip_cheby_conv",
                "p2m_dense_cheby"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_every_entry_point_takes_f32_before_the_stream(entry):
    """Every kernel has a float32 instance: each launch function ends with
    `int f32, void* stream`, and its loader declares one more int than a
    bf16-only signature would (the ctypes test above holds the count)."""
    params = _c_parameters()
    assert set(params) == set(ENTRY_POINTS)
    assert params[entry][-2:] == ["int f32", "void* stream"], params[entry][-2:]
