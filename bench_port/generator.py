"""The one traffic generator: reads a mix's parameters (`traffic/<mix>.json`)
and drives the system under test with them.

Every input comes from one recipe, `bodies`: per sample the configuration's
frozen template turned about its long axis (yaw uniform in +-yaw_range),
tilted about the other two (N(0, tilt_std^2) radians each) and scaled
(uniform in scale_range), plus N(0, noise_m^2) per coordinate: a mesh in
metres.  Its joints are the mesh's vertices at each frozen regressor row's
heaviest vertex, x 1000 (mm), and the 2D pose their x/y / 500, as the
port's `train_setup.batch_from_mesh` scales them (the stand-in regressors'
rows spread over the surface, so their regressed joints all lie near the
centroid).  Samples of a batch differ by whole-body turns, so batch
statistics are those of real poses, not of one pose and its noise.

kind "serve": a closed loop of one client.  Each request is a batch of
`batch` 2D poses in pinned host memory, cycled from a pool of `pool`
distinct batches made at set-up (the deploy weights' BatchNorm running
statistics are set to their batch statistics on `bn_statistics_rows` more
poses of the recipe, as a trained model's match its activations); it is
copied to the card, run through the
eval step, and the mesh, the regressed joints and the lifted pose are
copied back to the host before the next request is sent.  A seeded
reservoir keeps `check_requests` answers, each request as likely as any
other, for the comparison with the reference.

kind "train": training steps, cycled over a pool of `pool` distinct batches
made on the card at set-up (the mesh as the target, the joints as both 3D
pose targets, the 2D pose as the input, all-ones masks).  The first
`check_steps` steps are the ones compared with the reference, `warmup` more
follow in set-up, then the window's.  Steps are sent back to back, as
`Trainer` sends them; the window closes with one synchronize.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .weights import sub_seed

__all__ = ["bodies", "serve_pool", "statistics_poses", "train_pool", "Reservoir", "ServeLoop",
           "train_window"]


def _no_span(name: str):
    return contextlib.nullcontext()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rotations(n: int, traffic: Dict, g: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(n, 3, generator=g, device=device, dtype=torch.float64)
    z = torch.randn(n, 2, generator=g, device=device, dtype=torch.float64)
    yaw = (2.0 * u[:, 0] - 1.0) * float(traffic["yaw_range"])
    pitch, roll = z[:, 0] * float(traffic["tilt_std"]), z[:, 1] * float(traffic["tilt_std"])
    lo, hi = traffic["scale_range"]
    scale = float(lo) + (float(hi) - float(lo)) * u[:, 1]

    def rot(angle, i, j):
        R = torch.zeros(n, 3, 3, dtype=torch.float64, device=device)
        k = 3 - i - j
        R[:, k, k] = 1.0
        R[:, i, i], R[:, j, j] = torch.cos(angle), torch.cos(angle)
        R[:, i, j], R[:, j, i] = -torch.sin(angle), torch.sin(angle)
        return R
    return scale[:, None, None] * (rot(yaw, 0, 1) @ rot(pitch, 0, 2) @ rot(roll, 1, 2))


def bodies(mesh: Dict[str, np.ndarray], traffic: Dict, n: int, g: torch.Generator,
           device) -> Tuple[torch.Tensor, torch.Tensor]:
    """n meshes (n, V, 3) metres and their joints (n, J, 3) mm, float32."""
    tmpl = torch.as_tensor(mesh["template"], dtype=torch.float64, device=device)
    idx = torch.as_tensor(np.argmax(mesh["j_regressor"], axis=1), device=device)
    R = _rotations(n, traffic, g, device)
    m = torch.einsum("nij,vj->nvi", R, tmpl)
    m = m + float(traffic["noise_m"]) * torch.randn(m.shape, generator=g, device=device,
                                                    dtype=torch.float64)
    joints = m.index_select(1, idx) * 1000.0
    return m.float(), joints.float()


def serve_pool(mesh: Dict[str, np.ndarray], traffic: Dict, seed: int,
               device: torch.device) -> torch.Tensor:
    """(pool, batch, J, 2) float32 poses in host memory (pinned with a card)."""
    P, B = int(traffic["pool"]), int(traffic["batch"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    _, joints = bodies(mesh, traffic, P * B, g, device)
    pool = (joints[..., :2] / 500.0).reshape(P, B, -1, 2).cpu()
    return pool.pin_memory() if device.type == "cuda" else pool


def statistics_poses(mesh: Dict[str, np.ndarray], traffic: Dict, seed: int,
                     device: torch.device) -> torch.Tensor:
    """`bn_statistics_rows` poses (n, J, 2) of the traffic's recipe, apart
    from the requests, for the deploy weights' BatchNorm statistics."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 6))
    _, joints = bodies(mesh, traffic, int(traffic["bn_statistics_rows"]), g, device)
    return joints[..., :2] / 500.0


def train_pool(mesh: Dict[str, np.ndarray], traffic: Dict, seed: int,
               device: torch.device) -> List[Dict[str, torch.Tensor]]:
    P, B = int(traffic["pool"]), int(traffic["batch"])
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    meshes, joints = bodies(mesh, traffic, P * B, g, device)
    V, J = meshes.shape[1], joints.shape[1]
    ones_v = torch.ones(B, V, 3, device=device)
    ones_j = torch.ones(B, J, 3, device=device)
    out = []
    for p in range(P):
        pose = joints[p * B:(p + 1) * B].contiguous()
        out.append({"pose2d": (pose[..., :2] / 500.0).contiguous(),
                    "mesh": meshes[p * B:(p + 1) * B].contiguous(),
                    "mesh_valid": ones_v, "reg_pose3d": pose, "reg_pose3d_valid": ones_j,
                    "lift_pose3d": pose, "lift_pose3d_valid": ones_j})
    return out


class Reservoir:
    """Keeps k of the requests seen, each with the same chance (Algorithm
    R, drawn from the seed), in k + 1 preallocated host buffer sets: the
    request in flight writes into `target`, which is swapped into the kept
    set when its request is chosen."""

    def __init__(self, k: int, make_buffers: Callable[[], tuple], seed: int):
        self.k = k
        self.rng = np.random.default_rng(sub_seed(seed, 5))
        self.spare = [make_buffers() for _ in range(k + 1)]
        self.kept: List[Optional[tuple]] = [None] * k   # (buffers, request index)
        self.target = self.spare.pop()

    def offer(self, i: int) -> None:
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        if slot >= self.k:
            return
        old = self.kept[slot]
        self.kept[slot] = (self.target, i)
        self.target = old[0] if old is not None else self.spare.pop()

    def items(self):
        return [kv for kv in self.kept if kv is not None]


@dataclass
class WindowRecord:
    requests: int = 0
    items: int = 0            # meshes or samples
    t_start: float = 0.0
    t_end: float = 0.0
    latencies: List[float] = field(default_factory=list)
    dispatch: List[float] = field(default_factory=list)
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class ServeLoop:
    """The closed loop over `system.step`; request i sends pool[i % pool]."""

    def __init__(self, system, pool_host: torch.Tensor, traffic: Dict, seed: int,
                 device: torch.device, out_shapes):
        self.system, self.pool, self.dev = system, pool_host, device
        pin = device.type == "cuda"

        def buffers():
            return tuple(torch.empty(s, dtype=torch.float32, pin_memory=pin)
                         for s in out_shapes)
        self.reservoir = Reservoir(int(traffic["check_requests"]), buffers, seed)
        self.i = 0

    def request(self, keep: bool, label: bool = False):
        """One request: (latency s, dispatch s, its end on the host clock);
        `label` marks its phases for the profiler."""
        span = torch.profiler.record_function if label else _no_span
        t0 = time.perf_counter()
        x = self.pool[self.i % self.pool.shape[0]]
        with span("bench.h2d"):
            x = x.to(self.dev, non_blocking=True)
        with span("bench.step"):
            outs = self.system.step(x)
        t1 = time.perf_counter()
        with span("bench.d2h"):
            for b, o in zip(self.reservoir.target, outs):
                b.copy_(o, non_blocking=True)
            sync(self.dev)
        t2 = time.perf_counter()
        if keep:
            self.reservoir.offer(self.i)
        self.i += 1
        return t2 - t0, t1 - t0, t2

    def window(self, seconds: float, batch: int) -> WindowRecord:
        rec = WindowRecord()
        rec.t_start = time.perf_counter()
        while True:
            lat, disp, t_done = self.request(keep=True)
            rec.latencies.append(lat)
            rec.dispatch.append(disp)
            rec.requests += 1
            if t_done - rec.t_start >= seconds:
                break
        rec.t_end = t_done
        rec.items = rec.requests * batch
        return rec


def train_window(step: Callable[[int], Dict[str, torch.Tensor]], first: int, seconds: float,
                 batch: int, device: torch.device) -> WindowRecord:
    """Steps first, first + 1, ... until `seconds` have passed on the host,
    then one synchronize; a step whose total loss is not finite failed."""
    rec = WindowRecord()
    totals = []
    i = first
    rec.t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        losses = step(i)
        t1 = time.perf_counter()
        totals.append(losses["total"])
        rec.dispatch.append(t1 - t0)
        i += 1
        if t1 - rec.t_start >= seconds:
            break
    sync(device)
    rec.t_end = time.perf_counter()
    rec.requests = i - first
    rec.items = rec.requests * batch
    rec.failed = int((~torch.isfinite(torch.stack(totals).float())).sum())
    return rec
