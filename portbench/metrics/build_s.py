"""Host seconds of the program's ``build`` span: the engine's build (the
drawer and its model, the towers built and loaded, the prompt tables and
text encoding, the step and its optimizer), part of ``setup_s``; nothing
for a program without the span."""

from portbench.harness.spans import profiling


def read(run):
    P = profiling()
    return None if P is None else P.TIMER.last.get("build")
