"""Structured logging, metrics and profiling hooks.

Counterpart of pylbl_tpu/utils/observability.py:

- a package logger (``pylbl_tpu_torch``) with a single opt-in
  configurator,
- a process-wide metrics registry of counters and stage timers (``Gas``
  records ``lines.absorption``, ``lines.pedestal`` and
  ``lines.absorption_batch`` and the counters ``lines.processed``,
  ``lines.point_evals`` and ``lines.grid_points``); a timer is host clock
  around a block that ends with the device-to-host copy, so on the card it
  covers the synchronised work.  ``Spectroscopy`` times its layers
  (``spectroscopy.init``, ``absorption``, ``molecules.load``,
  ``lines.build``, ``lines.run``, ``continua.build``, ``continua.run``,
  ``output`` and their parts) and counts the per-instance work it builds
  (``lines.builds``, ``lines.shared_hits``, ``continua.builds``,
  ``molecules.loaded``, ``database.pack_reads``),
- each stage timer is also a span: while a ``torch.profiler`` records, it
  opens the range ``pylbl.<stage>``, on the profiler's clock beside the
  card's work,
- a ``torch.profiler`` trace context writing TensorBoard traces.
"""
import contextlib
import logging
import threading
import time

import torch

logger = logging.getLogger("pylbl_tpu_torch")
# Name of a stage's range in a profiler trace: SPAN_PREFIX + stage.
SPAN_PREFIX = "pylbl."


def configure_logging(level=logging.INFO):
    """Opt-in console logging with a structured one-line format."""
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
    return logger


class Metrics:
    """Thread-safe counters and stage timers."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters = {}
        self.timers = {}

    def count(self, name, value=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    @contextlib.contextmanager
    def timed(self, stage):
        """Times the block into the ``stage`` timer and, only while a
        profiler records, opens the range ``SPAN_PREFIX + stage`` over it
        (the test costs far less than a range with no profiler)."""
        span = torch.profiler.record_function(SPAN_PREFIX + stage) \
            if torch.autograd._profiler_enabled() \
            else contextlib.nullcontext()
        start = time.perf_counter()
        try:
            with span:
                yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                total, calls = self.timers.get(stage, (0.0, 0))
                self.timers[stage] = (total + elapsed, calls + 1)

    def rate(self, counter, stage):
        """counter / total-stage-seconds, or None."""
        with self._lock:
            total, _ = self.timers.get(stage, (0.0, 0))
            value = self.counters.get(counter, 0)
        return value / total if total > 0 else None

    def snapshot(self):
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timers": {k: {"seconds": v[0], "calls": v[1]}
                           for k, v in self.timers.items()},
            }

    def reset(self):
        with self._lock:
            self.counters.clear()
            self.timers.clear()


metrics = Metrics()


@contextlib.contextmanager
def profiler_trace(log_dir):
    """Captures a ``torch.profiler`` trace of a region into ``log_dir``
    (TensorBoard's trace handler format): host activity, and the card's
    when CUDA is available.  Yields the ``profile``, whose
    ``key_averages()`` sum the region's events once it has ended."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(
                     str(log_dir))) as prof:
        yield prof
