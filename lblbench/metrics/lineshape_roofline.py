"""The line-shape kernels' share of their roofline, in %: the least time
the chip needs for the line-shape work of one call (counted from the
inputs alone, ``lblbench/harness/counting.py``, at the H100 SXM's FP32 and
HBM peaks) over the kernels' device time per call."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.kernel_s(run.lineshape) / run.trace.calls
    if seconds <= 0:
        return None
    return 100.0 * run.work["seconds"] / seconds
