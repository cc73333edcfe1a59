"""Host milliseconds a call spends building the continua's and cross
sections' device evaluators (``pylbl.continua.build``)."""
from lblbench.harness import spans


def read(run):
    return spans.read(run, "continua_build_ms")
