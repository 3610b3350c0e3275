"""The share of the untraced window in which no kernel ran on the device,
at pixray's default checkin cadence: one less the device's busy seconds
per step, from the traced walk of whole checkin cycles (the union of its
kernels' intervals over its steps: blocks, eager steps and checkin
renders), times the window's steps per second.  The walk's own seconds
are not used: the profiler's host cost widens the gaps in it."""

from portbench.harness.trace import idle_pct


def read(run):
    return idle_pct(run.trace, run.prog.attempted / run.prog.window_s)
