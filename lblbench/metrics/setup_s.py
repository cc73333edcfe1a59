"""Seconds from the start of the process to the start of the window."""


def read(run):
    return run.setup_s
