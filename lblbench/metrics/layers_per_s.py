"""Layers whose total absorption spectrum came back on the host, over the
window's seconds (the window: first timed call to the end of the last)."""


def read(run):
    return run.states_per_call * len(run.calls) / run.window_s
