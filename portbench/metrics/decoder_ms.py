"""Device milliseconds per step between the markers around the VQGAN
drawer's ``synth`` forward and its backward (``layers/decoder.json``)."""

LAYERS = ("decoder",)  # the marked layers it reads


def read(run):
    t = run.trace
    return None if t is None else t["layer_ms"].get("decoder")
