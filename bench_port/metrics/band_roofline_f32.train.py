"""The float32 band convs' least time a training step (counts_f32: K1 and
K2 of each at 4-byte operands, operations at the 3xTF32 rate) over their
measured device time a step: the profiler's time of the kernels named here
(K1: the fold pass, the float32 hop's list pass and FFMA engine, the
float32 projection GEMM and its statistics' reduction; K2: the hops, the
float32 dx and dW GEMMs and dW's reduction), over the traced segment's
steps, %."""
from bench_port.counts_f32 import metric_bound_s
from bench_port.trace import kernel_seconds

KERNELS = ("fold_kernel", "band_hop_f32_lists", "band_hop_f32_kernel", "cheby_proj_f32_kernel",
           "reduce_partials", "bwd_dx_f32_kernel", "bwd_dw_f32_kernel", "dw_reduce_kernel")


def read(run):
    t = run.trace
    if run.kind != "train" or t is None or not t.steps:
        return None
    measured = kernel_seconds(t, KERNELS) / t.steps
    if measured <= 0:
        return None
    bound = metric_bound_s("band_roofline_f32.train", run.band_bound_s_per_step)
    return None if bound is None else 100.0 * bound / measured
