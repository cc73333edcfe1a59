"""Host milliseconds a call spends outside the spans that the other span
metrics read: the new ``Spectroscopy``'s constructor, the harness's own
dataset and reshape, and what no span labels yet."""
from lblbench.harness import spans


def read(run):
    return spans.other(run)
