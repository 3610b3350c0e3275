"""Host seconds of the program's ``block.capture`` spans in set-up: the
graph captures (warm-up step, capture, instantiate) of the blocks whose
first step comes before the untraced window (``harness/spans.py``); part
of ``setup_s``.  Nothing without block records."""

from portbench.harness.spans import setup_blocks


def read(run):
    blocks = setup_blocks(run)
    return sum(b.capture_s for b in blocks) if blocks else None
