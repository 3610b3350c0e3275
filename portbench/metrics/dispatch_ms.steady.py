"""Host milliseconds per step inside the engine's block dispatch
(``Engine._dispatch_block``: draws, staging, upload, replay launch), over
the steps of the blocks the window dispatched; nothing where it dispatched none."""


def read(run):
    p = run.prog
    return 1e3 * p.dispatch_s / p.dispatch_steps if p.dispatch_steps else None
