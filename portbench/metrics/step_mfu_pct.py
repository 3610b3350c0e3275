"""The step's share of the card's bf16 peak (989 TFLOP/s): the step's
model FLOPs (``harness/counts.py``) times the steps of the run's untraced
window, over the window's seconds."""

from portbench.harness.counts import BF16_PEAK_FLOPS, step_flops


def read(run):
    p = run.prog
    return 100.0 * step_flops(run.settings) * p.attempted / p.window_s / BF16_PEAK_FLOPS
