"""Host milliseconds per step in the program's ``block.draw`` span: the
host's draws and the packing of each block's steps into the staging
buffer, over the blocks whose first step falls in the untraced window
(``harness/spans.py``); nothing for a program without block records."""

from portbench.harness.spans import per_step_ms


def read(run):
    return per_step_ms(run, "draw_s")
