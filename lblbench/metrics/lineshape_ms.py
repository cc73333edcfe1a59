"""Device milliseconds a call spends in the line-shape kernels (the names
that ``lblbench/kernels/*.json`` list for the layer), from the trace."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(run.lineshape)
    return seconds / run.trace.calls * 1e3 if seconds > 0 else None
