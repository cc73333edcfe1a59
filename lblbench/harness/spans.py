"""The program's own host spans in a traced run, as host milliseconds a
call.

While a profiler records, each stage timer of ``pylbl_tpu_torch`` (its
``utils/observability.py`` ``metrics.timed``) opens the range
``pylbl.<stage>`` on the profiler's clock.  A span metric is the union of
the named ranges' intervals inside the traced calls (their ``CALL``
ranges), divided by the number of calls; ``host_other_ms`` is the calls'
time outside every span that the other metrics read, so the metrics of
``SPANS`` partition a call's host time.  Each returns None where the trace
holds no ``pylbl.`` range (a program that opens none, as the harness's
control).
"""
from . import trace as trace_mod

PREFIX = "pylbl."
# Stages each span metric reads; host_other_ms reads what none of them do.
SPANS = {
    "molecules_ms": ("molecules.load",),
    "lines_build_ms": ("lines.build",),
    "continua_build_ms": ("continua.build",),
    "enqueue_ms": ("lines.run", "continua.run"),
    "output_host_ms": ("output",),
}


def _calls(trace):
    return trace_mod._merged([c for c in trace.cpu if c[0] == trace_mod.CALL],
                             *trace.window)


def _inside(trace, stages):
    """Microseconds of the calls covered by the ranges of ``stages``."""
    names = {PREFIX + s for s in stages}
    spans = [c for c in trace.cpu if c[0] in names]
    return sum(trace_mod._union(spans, lo, hi) for lo, hi in _calls(trace))


def _traced(run):
    return run.trace is not None and any(
        c[0].startswith(PREFIX) for c in run.trace.cpu)


def read(run, metric):
    """Host ms a call inside the spans of ``SPANS[metric]``, or None."""
    if not _traced(run):
        return None
    return _inside(run.trace, SPANS[metric]) / run.trace.calls / 1e3


def other(run):
    """Host ms a call outside every span of ``SPANS``, or None."""
    if not _traced(run):
        return None
    stages = [s for each in SPANS.values() for s in each]
    calls_us = sum(hi - lo for lo, hi in _calls(run.trace))
    return (calls_us - _inside(run.trace, stages)) / run.trace.calls / 1e3
