"""Device ms per call of every kernel that is not one of the program's
hand-written ones (the ops glue: aten's kernels), from the profiler."""

from benchmark_torch.common.trace import named


def read(run):
    if run.trace is None:
        return None
    glue = [op for op in run.trace.kernels()
            if not any(named([op], k) for k in run.own_kernels)]
    return 1e3 * sum(e - s for _, s, e in glue) / run.window.calls
