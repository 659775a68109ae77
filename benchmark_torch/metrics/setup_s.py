"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernel library's load (or build), the model, the inputs
and the warm-up of the cell's own shapes (host clock)."""


def read(run):
    return run.setup_s
