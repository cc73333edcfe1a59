"""Device milliseconds a call spends copying from the device to the host
(the spectrum handed back)."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.copy_s("DtoH")
    return seconds / run.trace.calls * 1e3 if seconds > 0 else None
