"""Host milliseconds per checkin in the program's ``checkin`` span (the
losses printed, the canvas rendered and brought to the host, its PNG
files written), over the checkins of the traced walk; nothing where the
walk made none, or for a program without the span."""


def read(run):
    t = run.trace
    span = None if t is None else t.get("spans", {}).get("checkin")
    return 1e3 * span["s"] / span["n"] if span and span["n"] else None
