"""The readers of the blocked ``compute_absorption`` (``blocks_per_call``,
``fetch_wait_ms``) on a made-up timeline and on traced tiny runs, and the
cell that runs more states than the card holds."""
import time
from types import SimpleNamespace

import pytest

from lblbench.harness import main, spec, trace
from lblbench.harness.system import System
from lblbench.tests.tiny import ROOT, run, tiny_cell

SPAN_METRICS = ("molecules_ms", "lines_build_ms", "continua_build_ms",
                "enqueue_ms", "output_host_ms", "host_other_ms")


def read(metric, t):
    return spec.reader(ROOT, metric)(SimpleNamespace(trace=t))


def timeline(cpu):
    """Two calls, 0-100 and 100-200 us, with ``cpu``'s ranges inside."""
    ranges = [(trace.CALL, 0.0, 100.0), (trace.CALL, 100.0, 200.0)]
    return trace.Trace(kernels=[], copies=[], cpu=ranges + cpu, calls=2,
                       window=(0.0, 200.0))


def test_block_readers_on_a_timeline():
    t = timeline([
        ("pylbl.absorption", 5.0, 95.0),
        ("pylbl.absorption.block", 10.0, 40.0),
        ("pylbl.output", 38.0, 40.0),
        ("pylbl.absorption.block", 40.0, 70.0),
        ("pylbl.output", 70.0, 80.0),
        ("pylbl.output.wait", 70.0, 75.0),
        ("pylbl.output", 80.0, 94.0),
        ("pylbl.output.wait", 80.0, 90.0),
        # A thread's wait beside the first: the union counts once.
        ("pylbl.output.wait", 85.0, 92.0),
        ("pylbl.absorption", 105.0, 195.0),
        ("pylbl.absorption.block", 110.0, 150.0),
        ("pylbl.output.wait", 160.0, 190.0),
        # Outside every call: neither counted.
        ("pylbl.absorption.block", 200.0, 230.0),
        ("pylbl.output.wait", 200.0, 260.0),
    ])
    assert read("blocks_per_call", t) == pytest.approx(3 / 2)
    assert read("fetch_wait_ms", t) == pytest.approx((5 + 12 + 30) / 2e3)


def test_block_readers_read_nothing_without_the_ranges():
    for cpu in ([("aten::mul", 10.0, 20.0)],
                [("pylbl.absorption", 5.0, 95.0),
                 ("pylbl.output", 80.0, 90.0)]):
        t = timeline(cpu)
        assert read("blocks_per_call", t) is None
        assert read("fetch_wait_ms", t) is None
    assert read("blocks_per_call", None) is None
    assert read("fetch_wait_ms", None) is None


def test_the_blocked_cell_loads():
    cell = spec.cell(ROOT, "col60-0p01.sites8")
    assert cell.chips == 1 and cell.config["name"] == "rfmip8-0p01"
    assert cell.config["sites"] == 8 and cell.config["grid"]["step"] == 0.01
    assert not spec.remove_pedestal(cell.config)
    assert cell.limits == {"rel_err": 4e-3}
    names = {m["name"] for m in cell.per_layer}
    assert {"blocks_per_call", "fetch_wait_ms"} <= names
    entry, = [c for c in spec.load(ROOT)["configs"]
              if c["name"] == "rfmip8-0p01"]
    assert set(entry["reduced"]) == set(cell.config["reduced_why"])


@pytest.mark.parametrize("states", [None, 5])
def test_blocks_in_a_traced_tiny_run(monkeypatch, states):
    """A tiny two-site run reads one block a call; with the budget forced
    to ``states`` states a block, three (12 states), and the six span
    metrics still sum to the mean call."""
    from pylbl_tpu_torch import spectroscopy

    if states is not None:
        monkeypatch.setattr(spectroscopy, "block_bytes", lambda *a: (1, 0))
        monkeypatch.setattr(spectroscopy, "block_budget",
                            lambda device: states)

    class Timed(System):
        seconds = []

        def __call__(self, request):
            start = time.perf_counter()
            try:
                return super().__call__(request)
            finally:
                Timed.seconds.append(time.perf_counter() - start)

    result = run(tiny_cell("col60-0p01.sites8", sites=2), traced=True,
                 factory=Timed)
    assert result["correct"]
    got = result["metrics"]
    assert got["blocks_per_call"]["value"] == (1 if states is None else 3)
    assert got["fetch_wait_ms"]["value"] >= 0
    window = Timed.seconds[main.WARM_CALLS:]
    mean_ms = sum(window) / len(window) * 1e3
    assert sum(got[m]["value"] for m in SPAN_METRICS) \
        == pytest.approx(mean_ms, rel=0.01)
