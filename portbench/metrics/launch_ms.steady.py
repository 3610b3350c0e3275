"""Host milliseconds per step in the program's ``block.launch`` span: the
graph replay's launch, the pinned loss buffers, their copies and the done
event, over the blocks whose first step falls in the untraced window
(``harness/spans.py``); nothing for a program without block records."""

from portbench.harness.spans import per_step_ms


def read(run):
    return per_step_ms(run, "launch_s")
