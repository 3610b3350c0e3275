"""setup_s: host seconds from the process's start to the first timed step:
imports, the weights, the engine's build, the warm-up steps (the first
block's capture among them), ended by a synchronize."""


def read(run):
    return run.prog.setup_s
