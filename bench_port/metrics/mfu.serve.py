"""The model's operations of every step in the untraced window (counts.py:
the forward's, 3x for a training step) over the window, against the bf16
peak (peaks.py), %."""
from bench_port.peaks import PEAK_BF16_FLOPS


def read(run):
    w = run.window
    if run.kind != "serve" or w.seconds <= 0 or run.flops_per_step <= 0:
        return None
    return 100.0 * run.flops_per_step * w.requests / w.seconds / PEAK_BF16_FLOPS
