"""steps_per_s: the steps whose work the window dispatched (every one
finished by its closing synchronize) over the window's host seconds."""


def read(run):
    return run.prog.attempted / run.prog.window_s
