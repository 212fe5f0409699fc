"""The float32 band convs' least time a forward (counts_f32: 4-byte
operands, operations at the 3xTF32 rate) over their measured device time a
forward: the profiler's time of the kernels named here, the float32 deploy
convs' (group and commuted: the float32 hop's list pass and its FFMA
engine, the float32 projection GEMM), over the traced segment's steps, %."""
from bench_port.counts_f32 import metric_bound_s
from bench_port.trace import kernel_seconds

KERNELS = ("band_hop_f32_lists", "band_hop_f32_kernel", "cheby_proj_f32_kernel")


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.steps:
        return None
    measured = kernel_seconds(t, KERNELS) / t.steps
    if measured <= 0:
        return None
    bound = metric_bound_s("band_roofline_f32.serve", run.band_bound_s_per_step)
    return None if bound is None else 100.0 * bound / measured
