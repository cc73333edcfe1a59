"""Host milliseconds a call spends loading each gas's backend objects
(``pylbl.molecules.load``: the lines engine, continua and cross sections
of every gas of a new ``Spectroscopy``)."""
from lblbench.harness import spans


def read(run):
    return spans.read(run, "molecules_ms")
