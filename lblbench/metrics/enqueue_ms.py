"""Host milliseconds a call spends issuing the device work: the stacked
lines function's call (``pylbl.lines.run``, with the envelope guard's host
read) and the continua, cross sections and per-gas sums
(``pylbl.continua.run``)."""
from lblbench.harness import spans


def read(run):
    return spans.read(run, "enqueue_ms")
