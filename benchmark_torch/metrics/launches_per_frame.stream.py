"""Device kernels per frame, aten's and the program's, as the profiler counts them."""


def read(run):
    if run.trace is None or not run.window.frames:
        return None
    return len(run.trace.kernels()) / len(run.window.frames)
