"""Blocks a call of ``compute_absorption`` runs its states in: the
program's ``pylbl.absorption.block`` ranges that start inside the traced
calls, over the calls.  None where the trace holds no such range (a
program that runs no blocks, as the harness's control)."""
from lblbench.harness import spans

BLOCK = spans.PREFIX + "absorption.block"


def read(run):
    if run.trace is None:
        return None
    starts = [lo for name, lo, _ in run.trace.cpu if name == BLOCK]
    if not starts:
        return None
    calls = spans._calls(run.trace)
    inside = sum(any(lo <= s < hi for lo, hi in calls) for s in starts)
    return inside / run.trace.calls
