"""PyTorch port: the dense levels' Chebyshev basis (`ops/dense_cheby.py`,
csrc/dense_cheby.cu) on the joint graph and every dense mesh level of the
stand-in SMPL (17 joints; 520 / 276 / 148 / 88 vertices) and MANO (21
joints; 395 / 208 / 108 / 76) artifacts, bf16 and float32.

CPU (tier 1): the wrapper on CPU tensors is `chebyshev_stack` (bit for bit,
forward and gradient); the kernel's arithmetic in plain PyTorch over the ELL
form (`dense_cheby_plain`, `dense_cheby_bwd_plain`: dx = R(R(g0 - g2) +
R(L (g1 + 2 R(L g2))))) against `chebyshev_stack` and autograd through it,
the oracle of the card tests; the row table (`graphs.artifact.dense_rows`)
and the ELL form equal `op.dense`, each dense level is symmetric and an
asymmetric one is refused; the table through an npz; the launch plan; the
wrapper's refusals; the `p2m.dense_conv` span in both MeshNet forms.

CUDA (marker `cuda`, skipped elsewhere): the kernel against the plain
versions at every level's conv widths, batch 1 and 64, forward and backward,
odd column counts and an unaligned input; the graphed eval and train steps
count the wrapper's calls on the calls that ran the step's Python only, and
give the eager step's answers.  On the card, without the JAX-importing
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_cheby.py

Tolerance: two sums of the same products in another order, each rounded at
the same points, differ by at most an ulp of the result plus the float32
rounding of the sum; per element, |got - want| <= eps (|want| + scale) with
scale the sum of the terms' magnitudes (|L| |x| for z1, 2 |L| |z1| + |x| for
z2, |g0| + |g2| + |L| (|g1| + 2 |L| |g2|) for dx), eps 2^-7 in bf16 (an ulp
at most) and 1e-6 in float32.  z2 is held against the plain z2 of the
kernel's own z1, so that a z1 one ulp apart is not counted twice.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pose2mesh_release_tpu_torch.body.mano import MANO
from pose2mesh_release_tpu_torch.body.smpl import SMPL
from pose2mesh_release_tpu_torch.data.joint_sets import HUMAN36, MANO_SET
from pose2mesh_release_tpu_torch.deploy import build_artifact
from pose2mesh_release_tpu_torch.graphs.artifact import (
    dense_rows, load_artifact, pack_pyramid, save_artifact,
)
from pose2mesh_release_tpu_torch.graphs.build import build_pyramid
from pose2mesh_release_tpu_torch.models.meshnet import MANO_BLOCKS, SMPL_BLOCKS
from pose2mesh_release_tpu_torch.ops import dense_cheby as dc
from pose2mesh_release_tpu_torch.ops.cheby import chebyshev_stack
from pose2mesh_release_tpu_torch.ops.spmm import spmm

DTYPES = [torch.bfloat16, torch.float32]
EPS = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-6}


@pytest.fixture(scope="module")
def bodies():
    """{body: (artifact float32 on the CPU, {vertices: the Fin of its convs})}."""
    out = {}
    for name, face, joints, levels, blocks in (
            ("smpl", SMPL().face, HUMAN36, 9, SMPL_BLOCKS),
            ("mano", MANO().face, MANO_SET, 6, MANO_BLOCKS)):
        art = build_artifact(face, joints, levels, torch.device("cpu"))
        ops = (art.joint_op,) + art.mesh_ops[::-1] + (art.mesh_ops[0],)
        fins = {}
        for op, chans in zip(ops, blocks):
            if op.kind == "dense":
                fins.setdefault(op.num_vertices, set()).update(chans[:-1])
        out[name] = (art, {v: sorted(f) for v, f in fins.items()})
    return out


def _dense_ops(art):
    return [op for op in (art.joint_op,) + art.mesh_ops if op.kind == "dense"]


def _abs_hop(op, t):
    """|L| |t| in float32 for t (V, ...)."""
    return (op.dense.float().abs() @ t.float().abs().reshape(t.shape[0], -1)).reshape(t.shape)


def _check(got, want, scale, eps, what):
    got, want = got.detach().float(), want.detach().float()
    tol = eps * (want.abs() + scale.detach().float())
    bad = (got - want).abs() > tol
    worst = float(((got - want).abs() / tol).max())
    assert not bad.any(), (f"{what}: {int(bad.sum())} of {bad.numel()} elements out of "
                           f"bounds (worst {worst:.2f} x its bound)")


def _check_stack(op, x, got, eps, what):
    """The stack `got` of x against the plain version: x itself, z1 against
    the plain z1, z2 against the plain z2 of got's own z1."""
    Fin = x.shape[-1]
    got = got.reshape(x.shape[:-1] + (Fin, 3))
    want = dc.dense_cheby_plain(op, x).reshape(got.shape)
    assert torch.equal(got[..., 0], x), f"{what}: x"
    _check(got[..., 1], want[..., 1], _abs_hop(op, x), eps, f"{what}: z1")
    z1 = got[..., 1]
    want2 = dc.dense_cheby_plain(op, z1)
    want_z2 = (2.0 * want2.reshape(got.shape)[..., 1].float() - x.float()).to(x.dtype)
    _check(got[..., 2], want_z2, 2 * _abs_hop(op, z1) + x.float().abs(), eps, f"{what}: z2")


def _check_dx(op, g, got, want, eps, what):
    g3 = g.reshape(g.shape[:-1] + (g.shape[-1] // 3, 3)).float().abs()
    scale = g3[..., 0] + g3[..., 2] + _abs_hop(op, g3[..., 1] + 2 * _abs_hop(op, g3[..., 2]))
    _check(got, want, scale, eps, what)


# ---- CPU: the plain versions --------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("body", ["smpl", "mano"])
def test_wrapper_on_cpu_is_chebyshev_stack(bodies, body, dtype):
    """A CPU tensor takes `chebyshev_stack` itself: the stack and x's
    gradient bit for bit, on every dense level at its conv widths."""
    art, fins = bodies[body]
    art = art.to("cpu", dtype)
    g = torch.Generator().manual_seed(0)
    for op in _dense_ops(art):
        for fin in fins[op.num_vertices]:
            x = torch.randn(op.num_vertices, 3, fin, generator=g).to(dtype)
            xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
            got, want = dc.dense_cheby_stack(op, xa), chebyshev_stack(op, xb, 3)
            assert torch.equal(got, want)
            gy = torch.randn(got.shape, generator=g).to(dtype)
            got.backward(gy)
            want.backward(gy)
            assert torch.equal(xa.grad, xb.grad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("body", ["smpl", "mano"])
def test_plain_kernel_forms_match_chebyshev_stack(bodies, body, dtype):
    """The kernel's forward and backward in plain PyTorch over the ELL form
    against `chebyshev_stack` and autograd through it (the card tests'
    oracle), within the sum-order bound of the module note."""
    art, fins = bodies[body]
    art = art.to("cpu", dtype)
    g = torch.Generator().manual_seed(1)
    for op in _dense_ops(art):
        for fin in fins[op.num_vertices]:
            what = f"{body} {dtype} V={op.num_vertices} Fin={fin}"
            x = torch.randn(op.num_vertices, 4, fin, generator=g).to(dtype).requires_grad_(True)
            ref = chebyshev_stack(op, x, 3)
            _check_stack(op, x.detach(), ref, EPS[dtype], f"{what} forward")
            gy = torch.randn(ref.shape, generator=g).to(dtype)
            (dx,) = torch.autograd.grad(ref, x, gy)
            _check_dx(op, gy, dc.dense_cheby_bwd_plain(op, gy), dx, EPS[dtype],
                      f"{what} backward")


@pytest.mark.parametrize("body", ["smpl", "mano"])
def test_rows_are_the_dense_matrix_and_symmetric(bodies, body):
    """Each dense level's row table and its ELL form read back to `op.dense`
    exactly, in float32 and after the cast to bf16; L is symmetric."""
    art, _ = bodies[body]
    for dtype in DTYPES:
        for op in _dense_ops(art.to("cpu", dtype)):
            V = op.num_vertices
            D = op.dense
            assert torch.equal(D, D.T), f"{body} V={V} not symmetric"
            assert op.csr_ptr.dtype == op.csr_col.dtype == torch.int32
            assert op.csr_val.dtype == dtype and op.csr_ptr.numel() == V + 1
            rows = torch.repeat_interleave(torch.arange(V), op.csr_ptr.diff().long())
            table = torch.zeros(V, V, dtype=dtype)
            table[rows, op.csr_col.long()] = op.csr_val
            assert torch.equal(table, D)
            assert bool((op.csr_val != 0).all())
            ell = torch.zeros(V, V, dtype=dtype)
            ell.index_put_((torch.arange(V)[:, None].expand_as(op.ell_idx), op.ell_idx),
                           op.ell_w, accumulate=True)
            assert torch.equal(ell, D)


def test_dense_rows_refuses_an_asymmetric_level():
    idx = torch.tensor([[0, 1], [1, 0]])
    assert dense_rows(idx, torch.tensor([[1.0, 0.5], [1.0, 0.5]]))["csr_ptr"].tolist() == [0, 2, 4]
    with pytest.raises(ValueError, match="not symmetric"):
        dense_rows(idx, torch.tensor([[1.0, 0.5], [1.0, 0.25]]))


def test_rows_derived_again_at_load(tmp_path):
    """The table is not saved: `load_artifact` derives it as `pack_pyramid`
    does, and `.to` carries it (the values in the compute dtype)."""
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    _, faces = uv_sphere(770)
    pyr = build_pyramid(faces, joint_num=7, skeleton=[(0, 1), (1, 2), (2, 3), (3, 4), (1, 5),
                                                      (5, 6)], levels=3)
    art = pack_pyramid(pyr, faces, dense_threshold=500, device="cpu")
    path = str(tmp_path / "art.npz")
    save_artifact(path, art)
    got = load_artifact(path, device="cpu")
    for a, b in zip(_dense_ops(art), _dense_ops(got)):
        for f in ("csr_ptr", "csr_col", "csr_val"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert all(op.csr_val.dtype == torch.bfloat16
               for op in _dense_ops(got.to("cpu", torch.bfloat16)))
    assert not any(op.csr_ptr.numel() for op in got.mesh_ops if op.kind == "band")


@pytest.mark.parametrize("V,nnz,C,esize,want,threads", [
    (520, 3634, 64 * 256, 2, 64, 1024),   # SMPL's widest level, batch 64: 256 blocks
    (520, 3634, 64 * 256, 4, 32, 1024),   # float32: a warp's row run stays 128 bytes
    (88, 562, 64 * 64, 2, 16, 704),       # the widest slice whose grid covers 132 SMs
    (17, 61, 5, 2, 2, 128),               # the joint graph at batch 1: the narrowest
    (520, 3634, 256, 4, 2, 544),          # batch 1 at 256 channels: a thread a row
    (1024, 7200, 64 * 256, 4, 16, 1024),  # the datasets' graph (dense_threshold 1024)
])
def test_dense_plan(V, nnz, C, esize, want, threads):
    plan = dc.dense_plan(V, nnz, C, esize, 132)
    assert plan.w == want and 1 << plan.lw == plan.w and plan.grid == -(-C // want)
    assert plan.threads == threads and threads % 32 == 0 and threads % (want // 2) == 0
    assert plan.smem == dc.dense_smem(V, nnz, want, esize) <= 200 * 1024
    assert dc.dense_smem(V, nnz, want, esize) == -(-(8 * nnz + 4 * (V + 1)) // 16) * 16 \
        + 2 * V * want * esize
    with pytest.raises(ValueError, match="does not fit"):
        dc.dense_plan(8192, 60000, C, esize, 132)


def _meta_op(op, dtype):
    return dataclasses.replace(op, csr_ptr=op.csr_ptr.to("meta"), csr_col=op.csr_col.to("meta"),
                               csr_val=op.csr_val.to("meta", dtype))


@pytest.mark.parametrize("dtype,error", [
    (torch.bfloat16, "no kernel for device meta"), (torch.float32, "no kernel for device meta"),
    (torch.float16, "takes bfloat16 or float32"),
])
def test_wrapper_refusals(bodies, dtype, error):
    """Neither the CPU's plain version nor the card: a meta tensor is
    refused, as is float16; so is a band level and a row count not V."""
    art, _ = bodies["mano"]
    op = art.joint_op
    x = torch.empty(op.num_vertices, 2, 5, dtype=dtype, device="meta")
    with pytest.raises(ValueError if error.startswith("no kernel") else TypeError,
                       match=error):
        dc.dense_cheby_stack(_meta_op(op, dtype), x)
    with pytest.raises(ValueError, match="dense level"):
        dc.dense_cheby_stack(art.mesh_ops[0], torch.zeros(art.mesh_ops[0].num_vertices, 2, 5))
    with pytest.raises(ValueError, match="dense level"):
        dc.dense_cheby_stack(op, torch.zeros(op.num_vertices + 1, 2, 5))


def test_cuda_entry_points_raise_without_cuda(bodies):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    from pose2mesh_release_tpu_torch.deploy import deploy_forward_on
    art, _ = bodies["mano"]
    with pytest.raises(RuntimeError, match="CUDA"):
        deploy_forward_on(art, np.ones((21, art.num_vertices), np.float32) / art.num_vertices,
                          mano=True, device="cuda")


@pytest.mark.parametrize("form", ["deploy", "training"])
def test_dense_conv_spans(form):
    """One `p2m.dense_conv` a dense conv in both forms, naming its dtype and
    vertices, inside its block's span; the CPU launches no kernel."""
    from pose2mesh_release_tpu_torch.body.synthetic import uv_sphere
    from pose2mesh_release_tpu_torch.models.pose2mesh import Pose2Mesh
    from pose2mesh_release_tpu_torch.utils.profiling import record_spans
    J, skel = 7, [(0, 1), (1, 2), (2, 3), (3, 4), (1, 5), (5, 6)]
    _, faces = uv_sphere(770)
    art = pack_pyramid(build_pyramid(faces, joint_num=J, skeleton=skel, levels=3), faces,
                       dense_threshold=500, device="cpu")
    blocks = ((5, 8, 8), (8, 8, 8), (8, 16, 8), (8, 4, 3))
    model = Pose2Mesh(J, art.mesh_ops[-1].num_vertices, posenet_hidden=16, blocks=blocks,
                      device="cpu", inference_fused=form == "deploy")
    before = dict(dc.launches)
    with record_spans() as log:
        with torch.no_grad():
            model(art, torch.randn(2, J, 2))
    spans = log.spans
    dense = [s for s in spans if s.name == "p2m.dense_conv"]
    assert [s.attrs for s in dense] == [{"dtype": "float32", "vertices": J}] * 2 + [
        {"dtype": "float32", "vertices": 444}] * 2
    assert all(spans[s.parent].name == "p2m.meshnet.block"
               and spans[s.parent].attrs["kind"] == "dense" for s in dense)
    assert dc.launches == before


# ---- CUDA: the kernel --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("body", ["smpl", "mano"])
def test_kernel_matches_plain(bodies, body, dtype, batch):
    """Forward and backward on every dense level at its conv widths: against
    the plain versions, and against `chebyshev_stack` and autograd through
    it on the card (the parent's path); one launch a call."""
    dev = _cuda()
    art, fins = bodies[body]
    art = art.to(dev, dtype)
    g = torch.Generator(device=dev).manual_seed(2)
    for op in _dense_ops(art):
        for fin in fins[op.num_vertices]:
            what = f"{body} {dtype} B={batch} V={op.num_vertices} Fin={fin}"
            x = torch.randn(op.num_vertices, batch, fin, generator=g, device=dev).to(dtype)
            xk = x.clone().requires_grad_(True)
            before = dict(dc.launches)
            got = dc.dense_cheby_stack(op, xk)
            assert dc.launches["dense_cheby_stack"] == before["dense_cheby_stack"] + 1
            _check_stack(op, x, got.detach(), EPS[dtype], f"{what} vs plain")
            xr = x.clone().requires_grad_(True)
            ref = chebyshev_stack(op, xr, 3)
            _check(got[..., 1::3], ref[..., 1::3], _abs_hop(op, x), EPS[dtype],
                   f"{what}: z1 vs chebyshev_stack")
            z1 = got[..., 1::3].detach()
            _check(got[..., 2::3], (2.0 * spmm(op, z1) - x), 2 * _abs_hop(op, z1) + x.abs(),
                   EPS[dtype], f"{what}: z2 vs the parent's hop of the kernel's z1")
            gy = torch.randn(got.shape, generator=g, device=dev).to(dtype)
            (dx,) = torch.autograd.grad(got, xk, gy)
            assert dc.launches["dense_cheby_stack_bwd"] == before["dense_cheby_stack_bwd"] + 1
            _check_dx(op, gy, dx, dc.dense_cheby_bwd_plain(op, gy), EPS[dtype],
                      f"{what}: dx vs plain")
            (dx_ref,) = torch.autograd.grad(ref, xr, gy)
            _check_dx(op, gy, dx, dx_ref, EPS[dtype], f"{what}: dx vs autograd")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_odd_and_unaligned_columns(bodies, dtype):
    """C odd (batch 1 and 3 at 5 channels: scalar accesses, the last pair
    half out of range) and an x whose first element is not pair-aligned."""
    dev = _cuda()
    art, _ = bodies["smpl"]
    art = art.to(dev, dtype)
    g = torch.Generator(device=dev).manual_seed(3)
    for op in _dense_ops(art):
        V = op.num_vertices
        for shape in ((V, 1, 5), (V, 3, 5), (V, 2, 33)):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            _check_stack(op, x, dc.dense_cheby_stack(op, x), EPS[dtype], f"V={V} {shape}")
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            xu = buf[1:].view(shape)
            xu.copy_(x)
            assert xu.is_contiguous() and xu.data_ptr() % (2 * x.element_size())
            assert torch.equal(dc.dense_cheby_stack(op, xu), dc.dense_cheby_stack(op, x))
            gy = torch.randn(shape[:-1] + (3 * shape[-1],), generator=g, device=dev).to(dtype)
            xk = x.clone().requires_grad_(True)
            (dx,) = torch.autograd.grad(dc.dense_cheby_stack(op, xk), xk, gy)
            _check_dx(op, gy, dx, dc.dense_cheby_bwd_plain(op, gy), EPS[dtype],
                      f"V={V} {shape} dx")


@pytest.mark.cuda
def test_graphed_eval_counts_eager_calls_only():
    """SMPL bf16 and float32, batch 64: the first call (eager) and the
    capture run the wrapper 11 times each, a replay none; every answer the
    eager step's."""
    _cuda()
    from pose2mesh_release_tpu_torch.core.train import make_eval_step
    from pose2mesh_release_tpu_torch.deploy import smpl_deploy_forward
    for dtype in DTYPES:
        d = smpl_deploy_forward(dtype=dtype, device="cuda", seed=0)
        eager = make_eval_step(d.model, d.j_regressor, device="cuda", graph=False)
        g = torch.Generator().manual_seed(7)
        reqs = [torch.randn(64, 17, 2, generator=g).cuda() for _ in range(4)]
        counts = []
        for x in reqs:
            before = dc.launches["dense_cheby_stack"]
            got = d.eval_step(d.art_compute, x)
            counts.append(dc.launches["dense_cheby_stack"] - before)
            want, again = eager(d.art_compute, x), eager(d.art_compute, x)
            for a, w, e in zip(got, want, again):
                assert torch.equal(a, w) or float((a - w).abs().max()) <= float(
                    (e - w).abs().max())
        assert counts == [11, 11, 0, 0], counts


@pytest.mark.cuda
def test_graphed_train_counts_eager_calls_only():
    """MANO bf16, batch 64: the eager first step and the capture each run 11
    forward calls and one backward call a dense conv whose input needs a
    gradient, the replays none; the replayed step's losses the eager step's."""
    _cuda()
    from pose2mesh_release_tpu_torch.core.train import make_train_step
    from pose2mesh_release_tpu_torch.train_setup import mano_train_setup
    runs = {}
    for graph in (True, False):
        s = mano_train_setup(dtype=torch.bfloat16, device="cuda", seed=0, batch=64)
        step = make_train_step(s.state.model, s.state.optimizer, s.j_regressor,
                               device="cuda", graph=graph)
        state, counts, losses = s.state, [], []
        for _ in range(4):
            before = dict(dc.launches)
            state, out = step(state, s.art_compute, s.batch, 1e-3, True, s.generator)
            losses.append({k: v.clone() for k, v in out.items()})
            counts.append(tuple(dc.launches[k] - before[k] for k in sorted(before)))
        torch.cuda.synchronize()
        runs[graph] = counts, losses
    counts, losses = runs[True]
    fwd, bwd = counts[0]
    assert fwd == 11 and 10 <= bwd <= 11, counts
    assert counts == [counts[0], counts[0], (0, 0), (0, 0)], counts
    assert runs[False][0] == [counts[0]] * 4
    for i, (a, b) in enumerate(zip(losses, runs[False][1])):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-7,
                                       msg=lambda m: f"step {i} {k}: {m}")
