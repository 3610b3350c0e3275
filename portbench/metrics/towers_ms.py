"""Device milliseconds per step between the markers around every
perceptor's ``image_fn`` forward and its backward (``layers/towers.json``)."""

LAYERS = ("towers",)  # the marked layers it reads


def read(run):
    t = run.trace
    return None if t is None else t["layer_ms"].get("towers")
