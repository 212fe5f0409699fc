"""The band convs' least time a forward (counts.band_bound_s) over their
measured device time a forward: the profiler's time of the kernels named
here, the deploy convs' (group and commuted: the hop engine and the
projection GEMM), over the traced segment's steps, %."""
from bench_port.trace import kernel_seconds

KERNELS = ("band_hop_kernel", "cheby_proj_kernel")


def read(run):
    t = run.trace
    if run.kind != "serve" or t is None or not t.steps:
        return None
    measured = kernel_seconds(t, KERNELS) / t.steps
    if measured <= 0:
        return None
    return 100.0 * run.band_bound_s_per_step / measured
