"""A run whose timed path is broken underneath comes out not correct: once
for each fault a cell of one chip can have.  The run skips its look for a
card and drives the rest on the CPU at a small size."""
import numpy as np
import pytest

from lblbench.harness.system import System
from lblbench.tests.tiny import run, tiny_cell


def broken(fault):
    class Broken(System):
        calls = 0
        last = None

        def __init__(self, *args):
            super().__init__(*args)
            if fault == "no_pedestal":
                # The program run as with remove_pedestal=False: the
                # pedestal left in the spectrum.
                self.remove_pedestal = False

        def __call__(self, request):
            out = super().__call__(request)
            Broken.calls += 1
            if fault == "unchanged":
                # The step hands back its output buffer untouched.
                return np.zeros_like(out)
            if fault == "half_batch":
                # Half of the layers left out, the mean of the rest in
                # their place.
                half = out.shape[0] // 2
                out[half:] = out[:half].mean(axis=0)
                return out
            if fault == "altered":
                # One layer's spectrum altered where it is produced.
                out[Broken.calls % out.shape[0]] *= 1.01
                return out
            if fault == "no_pedestal":
                return out
            if fault == "stale":
                # A result cached across requests: from the second call on,
                # the answer to the request before.
                stale, Broken.last = Broken.last, out
                return out if stale is None else stale
            raise ValueError(fault)
    return Broken


@pytest.mark.parametrize("name", ["col60-0p1.column", "col60-0p1.sites8",
                                  "col60-0p1.default"])
def test_sound_run_is_correct(name):
    result = run(tiny_cell(name, sites=2 if "sites" in name else None))
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "stale"])
@pytest.mark.parametrize("name", ["col60-0p1.column", "col60-0p1.sites8",
                                  "col60-0p1.default"])
def test_fault_is_not_correct(name, fault):
    result = run(tiny_cell(name, sites=2 if "sites" in name else None),
                 factory=broken(fault))
    assert not result["correct"]
    assert result["failed"] > 0


def test_pedestal_left_in_is_not_correct():
    """The cell that takes the pedestal out fails a program that leaves it
    in, under its floored check."""
    cell = tiny_cell("col60-0p1.default")
    assert cell.config["remove_pedestal"] and "rel_err_floor" in cell.limits
    result = run(cell, factory=broken("no_pedestal"))
    assert not result["correct"]
    assert result["failed"] > 0
