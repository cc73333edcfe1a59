"""Host milliseconds a call spends handing the spectrum back
(``pylbl.output``: the device-to-host copy, the float64 cast and the
reshape)."""
from lblbench.harness import spans


def read(run):
    return spans.read(run, "output_host_ms")
