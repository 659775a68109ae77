"""The device's idle share of the whole traced window, in %: 1 - the union
of its kernels' and copies' intervals over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
