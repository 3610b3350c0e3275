"""Host milliseconds per step that the program waits on the card: its
``block.stage_wait`` span (the staging buffer's copy event) plus its
``block.loss_wait`` span (the block's losses), over the blocks whose first
step falls in the untraced window and whose losses reached the host
(``harness/spans.py``); nothing for a program without block records."""

from portbench.harness.spans import per_step_ms


def read(run):
    return per_step_ms(run, "stage_wait_s", "loss_wait_s")
