"""Host milliseconds a call spends building the stacked lines function
(``pylbl.lines.build``: stacking, plans and upload of the line constants,
and the pedestal remover)."""
from lblbench.harness import spans


def read(run):
    return spans.read(run, "lines_build_ms")
