"""What the program's own instruments left for the readers: the host spans
and block records of ``pixray_tpu_torch.engine.profiling``.

A reader takes the block records of the run's engine (the engine of the
newest record) whose first step falls in the untraced window: steps
``warmup_steps`` to ``warmup_steps + attempted`` of the cell's traffic.
Per step is a record's seconds over its steps, summed over the records.
A program without these instruments gives None to every reader.
"""

from __future__ import annotations


def profiling():
    """The program's profiling module where it has the block records, else None."""
    from pixray_tpu_torch.engine import profiling as P

    return P if hasattr(P, "BLOCKS") else None


def _engine_blocks() -> list:
    """The block records of the run's engine (the newest record's)."""
    P = profiling()
    if P is None or not P.BLOCKS:
        return []
    engine = P.BLOCKS[-1].engine
    return [b for b in P.BLOCKS if b.engine == engine]


def window_blocks(run) -> list:
    """The block records of the run's engine whose first step is in the untraced window."""
    first = int(run.cell.traffic["warmup_steps"])
    return [b for b in _engine_blocks() if first <= b.first < first + run.prog.attempted]


def setup_blocks(run) -> list:
    """The block records of the run's engine dispatched in set-up (first step before the window)."""
    return [b for b in _engine_blocks() if b.first < int(run.cell.traffic["warmup_steps"])]


def per_step_ms(run, *fields):
    """Host ms per step of the window's blocks in the records' ``fields``
    (summed); a field still None (a block whose losses never came to the
    host) leaves its block out.  None without blocks."""
    blocks = [b for b in window_blocks(run) if all(getattr(b, f) is not None for f in fields)]
    steps = sum(b.n for b in blocks)
    if not steps:
        return None
    return 1e3 * sum(getattr(b, f) for b in blocks for f in fields) / steps

