"""The reader of ``pedestal_ms`` (the host ms of the stacked pedestal
remover, ``pylbl.lines.pedestal``) on a made-up timeline and on a traced
tiny run of the cell that takes the pedestal out."""
from types import SimpleNamespace

import pytest

from lblbench.harness import spec, trace
from lblbench.tests.tiny import ROOT, run, tiny_cell


def read(metric, t):
    return spec.reader(ROOT, metric)(SimpleNamespace(trace=t))


def timeline(cpu):
    """Two calls, 0-100 and 100-200 us, with ``cpu``'s ranges inside."""
    ranges = [(trace.CALL, 0.0, 100.0), (trace.CALL, 100.0, 200.0)]
    return trace.Trace(kernels=[], copies=[], cpu=ranges + cpu, calls=2,
                       window=(0.0, 200.0))


def test_pedestal_ms_on_a_timeline():
    """``pedestal_ms`` reads the ``pylbl.lines.pedestal`` ranges (inside
    ``pylbl.lines.run``) a call, and None without them."""
    t = timeline([
        ("pylbl.lines.run", 10.0, 40.0),
        ("pylbl.lines.pedestal", 20.0, 38.0),
        ("pylbl.lines.run", 110.0, 150.0),
        ("pylbl.lines.pedestal", 120.0, 146.0),
        # Outside every call.
        ("pylbl.lines.pedestal", 210.0, 260.0),
    ])
    assert read("pedestal_ms", t) == pytest.approx((18 + 26) / 2e3)
    assert read("enqueue_ms", t) == pytest.approx((30 + 40) / 2e3)
    assert read("pedestal_ms", timeline([("pylbl.lines.run", 10.0, 40.0)])) \
        is None
    assert read("pedestal_ms", None) is None


def test_pedestal_ms_in_a_traced_tiny_run():
    """The cell that takes the pedestal out reports ``pedestal_ms``, a part
    of ``enqueue_ms``; the cells without it do not list the metric."""
    cell = tiny_cell("col60-0p1.default")
    assert "pedestal_ms" in {m["name"] for m in cell.per_layer}
    assert "pedestal_ms" not in {
        m["name"] for m in tiny_cell("col60-0p1.column").per_layer}
    result = run(cell, traced=True)
    got = {m: v["value"] for m, v in result["metrics"].items()}
    assert result["correct"]
    assert 0 < got["pedestal_ms"] < got["enqueue_ms"]
