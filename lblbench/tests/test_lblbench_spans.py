"""The span metrics on a made-up timeline, and on a traced run of a tiny
cell on the CPU."""
import time
from types import SimpleNamespace

import pytest

from lblbench.harness import main, spans, spec, trace
from lblbench.harness.system import System
from lblbench.tests.tiny import ROOT, run, tiny_cell

METRICS = ("molecules_ms", "lines_build_ms", "continua_build_ms",
           "enqueue_ms", "output_host_ms", "host_other_ms")


def read(metric, t):
    return spec.reader(ROOT, metric)(SimpleNamespace(trace=t))


def timeline(cpu):
    """Two calls, 0-100 and 100-200 us, with ``cpu``'s ranges inside."""
    ranges = [(trace.CALL, 0.0, 100.0), (trace.CALL, 100.0, 200.0)]
    return trace.Trace(kernels=[], copies=[], cpu=ranges + cpu, calls=2,
                       window=(0.0, 200.0))


def test_span_metrics_on_a_timeline():
    t = timeline([
        ("pylbl.spectroscopy.init", 0.0, 4.0),
        ("pylbl.absorption", 5.0, 95.0),
        # Opened before the first call: only its part inside counts.
        ("pylbl.molecules.load", -10.0, 10.0),
        ("pylbl.lines.build", 20.0, 50.0),
        ("pylbl.lines.plan", 25.0, 40.0),
        ("pylbl.lines.run", 50.0, 60.0),
        ("pylbl.lines.guard", 52.0, 54.0),
        ("pylbl.lines.run", 62.0, 70.0),
        ("pylbl.continua.run", 58.0, 75.0),
        ("pylbl.output", 80.0, 90.0),
        ("aten::mul", 81.0, 82.0),
        ("pylbl.absorption", 105.0, 195.0),
        ("pylbl.molecules.load", 105.0, 115.0),
        ("pylbl.continua.build", 115.0, 135.0),
        ("pylbl.lines.run", 135.0, 150.0),
        ("pylbl.output", 150.0, 194.0),
        # Outside every call.
        ("pylbl.output", 200.0, 260.0),
    ])
    got = {m: read(m, t) for m in METRICS}
    # Microseconds over two calls, in ms.
    want = {"molecules_ms": (10 + 10) / 2e3,
            "lines_build_ms": 30 / 2e3,
            "continua_build_ms": 20 / 2e3,
            "enqueue_ms": (25 + 15) / 2e3,
            "output_host_ms": (10 + 44) / 2e3}
    want["host_other_ms"] = 200 / 2e3 - sum(want.values())
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(100 / 1e3)


def test_span_metrics_read_nothing_without_spans():
    t = timeline([("aten::mul", 10.0, 20.0),
                  ("lblbench.sample", 100.0, 101.0)])
    assert all(read(m, t) is None for m in METRICS)
    assert all(read(m, None) is None for m in METRICS)


def test_span_metrics_partition_a_traced_tiny_run():
    class Timed(System):
        seconds = []

        def __call__(self, request):
            start = time.perf_counter()
            try:
                return super().__call__(request)
            finally:
                Timed.seconds.append(time.perf_counter() - start)

    result = run(tiny_cell("col60-0p1.column"), traced=True, factory=Timed)
    got = {m: result["metrics"][m]["value"] for m in METRICS}
    # Every call of the window takes the stacked lines pipeline that the
    # warm call built and left on the Database: no build in the window.
    assert got["lines_build_ms"] == 0
    assert all(v > 0 for m, v in got.items() if m != "lines_build_ms")
    # The harness's warm calls come first; the rest are the window's.
    window = Timed.seconds[main.WARM_CALLS:]
    mean_ms = sum(window) / len(window) * 1e3
    assert sum(got.values()) == pytest.approx(mean_ms, rel=0.01)
    assert set(spans.SPANS) | {"host_other_ms"} == set(METRICS)
