"""Device milliseconds a call spends in every other kernel: the stacked
lines pipeline's assembly and glue, and the continua."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(lambda name: not run.lineshape(name))
    return seconds / run.trace.calls * 1e3 if seconds > 0 else None
