"""The band convs' least time a training step (counts.band_bound_s: K1
and K2 of each) over their measured device time a step: the profiler's
time of the kernels named here (K1: the fold pass, the hop engine, the
projection GEMM and its statistics' reduction; K2: the hop engine, dx, dW
and dW's reduction), over the traced segment's steps, %."""
from bench_port.trace import kernel_seconds

KERNELS = ("fold_kernel", "band_hop_kernel", "cheby_proj_kernel", "reduce_partials",
           "bwd_dx_kernel", "bwd_dw_kernel", "dw_reduce_kernel")


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.steps:
        return None
    measured = kernel_seconds(t, KERNELS) / t.steps
    if measured <= 0:
        return None
    return 100.0 * run.band_bound_s_per_step / measured
