"""The plain reference against the port, float32 on the CPU at a small size
(the port's kernels run their plain versions there).  The reference builds
its own pyramid in tree order from the frozen coarsening; the port packs its
own (RCM-reordered band levels).  Readings when written: serve outputs
within 1.8e-7, the first step's losses within 1.5e-7 and its worst
gradient leaf within 2.4e-6 (seeds 1-3), so the limits below leave 40x or more."""
import statistics

import pytest
import torch

from bench_port.control import RefServe, RefTrain
from bench_port.generator import serve_pool, train_pool
from bench_port.system import ServeSystem, TrainSystem
from bench_port.tests.tiny import tiny_cell
from bench_port.weights import make_state_dict

CPU = torch.device("cpu")
# read 4.0e-4 and 3.9e-4 on seeds 1, 2
SHARE = 4e-3


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_serves_as_the_port(seed):
    c = tiny_cell("serve", batch=8)
    c.cfg["compute_dtype"] = "float32"
    sd = make_state_dict(c.cfg, c.cfg["coarse_vertices"], seed, CPU)
    prog = ServeSystem(c.cfg, c.mesh, sd, CPU)
    ref = RefServe(c.cfg, c.mesh, sd, CPU, precision="f32")
    x = serve_pool(c.mesh, c.traffic, seed, CPU)[0]
    for a, b in zip(prog.step(x), ref.step(x)):
        assert a.shape == b.shape
        assert float((a - b).norm() / b.norm()) < 1e-5


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_trains_as_the_port(seed):
    c = tiny_cell("train", batch=8)
    c.cfg["compute_dtype"] = "float32"
    sd = make_state_dict(c.cfg, c.cfg["coarse_vertices"], seed, CPU)
    prog = TrainSystem(c.cfg, c.mesh, sd, CPU, 5)
    ref = RefTrain(c.cfg, c.mesh, sd, CPU, 5, precision="f32")
    batch = train_pool(c.mesh, c.traffic, seed, CPU)[0]
    lp, lr = prog.step(batch), ref.step(batch)
    for k in ("total", "vertex", "normal", "edge", "reg_joint", "lift_joint"):
        assert abs(float(lp[k]) - float(lr[k])) <= 1e-5 * abs(float(lr[k])) + 1e-12, k
    gp, gr = prog.grad_norms_from_state(), ref.grad_norms_from_state()
    assert set(gp) == set(gr)
    med = statistics.median(gr.values())
    assert max(abs(gp[k] - gr[k]) / max(gr[k], med) for k in gr) < 1e-4
    # after RMSprop's first step, about lr * sign(g) an element: elements whose
    # gradient is round-off move either way in either (SHARE: the reading)
    pp, pr = prog.named_parameters(), ref.named_parameters()
    off = sum(int(((pp[k].detach() - pr[k]).abs() > 1e-4).sum()) for k in gr)
    share = off / sum(pr[k].numel() for k in gr)
    assert share < SHARE


def test_fp8_control_rounds_to_e4m3():
    from bench_port.reference.model import fake_fp8
    t = torch.tensor([448.0, 1.0, 0.3, -2.0])
    q = fake_fp8(t)
    assert torch.equal(q, t.to(torch.float8_e4m3fn).float())
    u = torch.randn(1000) * 1e-3
    rel = float((fake_fp8(u) - u).norm() / u.norm())
    assert 1e-3 < rel < 0.1   # 3 mantissa bits under a per-tensor scale
    x = torch.tensor([1.0, 0.3, -2.0], requires_grad=True)
    g = torch.tensor([57344.0, 0.3, 1.1])
    fake_fp8(x).backward(g)   # the gradient in e5m2, as fp8 training's hybrid recipe
    assert torch.equal(x.grad, g.to(torch.float8_e5m2).float())
