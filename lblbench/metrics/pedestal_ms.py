"""Host milliseconds a call spends in the stacked pedestal remover
(``pylbl.lines.pedestal``, inside ``pylbl.lines.run``, so inside
``enqueue_ms`` too): its float64 line physics and kernels issued, and any
wait for the card or host work it does.  None where the trace holds no
such range: a program that opens none, or a call without the pedestal."""
from lblbench.harness import spans

STAGE = "lines.pedestal"


def read(run):
    if run.trace is None or not any(
            name == spans.PREFIX + STAGE for name, _, _ in run.trace.cpu):
        return None
    return spans._inside(run.trace, (STAGE,)) / run.trace.calls / 1e3
