"""Host milliseconds a call waits for its blocks' copies to the host
(``pylbl.output.wait``, inside ``pylbl.output``): the part of the copy
back that the next block's work did not hide, and in a call of one block
the kernels still running when the host is done.  None where the trace
holds no such range."""
from lblbench.harness import spans

WAIT = "output.wait"


def read(run):
    if run.trace is None or not any(
            name == spans.PREFIX + WAIT for name, _, _ in run.trace.cpu):
        return None
    return spans._inside(run.trace, (WAIT,)) / run.trace.calls / 1e3
