"""The stacked lines pipelines a database shares with every
single-device ``Spectroscopy`` over its packs (the ``pipelines`` of
``runtime.reuse.reuse_of``): a new object in the same quantized envelope
builds nothing and returns what a fresh build returns, bit for bit;
anything that changes the build misses; the cache is bounded and dies with
its database."""
import gc
import sys
import threading
import weakref

import numpy as np
import pytest
import torch

from pylbl_tpu_torch import Dataset, Spectroscopy
from pylbl_tpu_torch.database.db import Database
from pylbl_tpu_torch.database.fixtures import synthetic_line_pack
from pylbl_tpu_torch.runtime import reuse
from pylbl_tpu_torch.utils.observability import metrics

torch.set_num_threads(1)

GRID = np.arange(1.0, 200.0, 0.5)
GASES = {"H2O": ("water_vapor", 6.6e-3), "CO2": ("carbon_dioxide", 4e-4)}
# Two columns whose warmest layers share the 290 K, 1 atm envelope bucket.
FIRST = (288.99, 250.0)
SECOND = (288.2, 251.3)


def make_database(path):
    db = Database(path)
    for seed, name in enumerate(GASES):
        db.ingest_line_pack(synthetic_line_pack(name, num_lines=150,
                                                nu_min=0.7, nu_max=220.0,
                                                seed=seed + 1))
    return db


def atmosphere(temperature, scale=1.0):
    data = {"p": (["layer"], np.asarray([98388.0, 5e4]),
                  {"standard_name": "air_pressure", "units": "Pa"}),
            "t": (["layer"], np.asarray(temperature, np.float64),
                  {"standard_name": "air_temperature", "units": "K"})}
    for name, (standard, vmr) in GASES.items():
        data[name.lower()] = (["layer"], np.full(2, vmr * scale), {
            "standard_name": f"mole_fraction_of_{standard}_in_air",
            "units": "mol mol-1"})
    return Dataset(data_vars=data)


def spectroscopy(db, temperature=FIRST, grid=GRID, **kwargs):
    return Spectroscopy(atmosphere(temperature, scale=temperature[0] / 289),
                        grid, db, device="cpu", device_mechanisms=True,
                        **kwargs)


def lines_counters():
    counters = metrics.snapshot()["counters"]
    return {k: v for k, v in counters.items()
            if k in ("lines.builds", "lines.shared_hits")}


@pytest.mark.parametrize("output_format", ["all", "total"])
def test_a_hit_returns_what_a_fresh_build_returns(tmp_path, output_format):
    warm = make_database(tmp_path / "warm.db")
    spectroscopy(warm).compute_absorption(output_format)
    metrics.reset()
    hit = spectroscopy(warm, SECOND).compute_absorption(output_format)
    assert lines_counters() == {"lines.shared_hits": 1}
    cold = make_database(tmp_path / "cold.db")
    metrics.reset()
    fresh = spectroscopy(cold, SECOND).compute_absorption(output_format)
    assert lines_counters() == {"lines.builds": 1}
    assert set(hit.data_vars) == set(fresh.data_vars)
    for name in hit.data_vars:
        assert np.array_equal(hit[name].data, fresh[name].data), name


@pytest.mark.parametrize("change", ["warmer", "grid", "dtype", "database",
                                    "reread"])
def test_what_changes_the_build_misses(tmp_path, change):
    """6 K above the bucket, another grid, another dtype, a new Database
    over the same file, a pack read anew into the same Database."""
    path = tmp_path / "misses.db"
    database = make_database(path)
    spectroscopy(database).compute_absorption("total")
    temperature, grid, kwargs = FIRST, GRID, {}
    if change == "warmer":
        temperature = (296.0, 250.0)
    elif change == "grid":
        grid = np.arange(1.0, 200.0, 0.25)
    elif change == "dtype":
        kwargs["dtype"] = torch.float64
    elif change == "database":
        database = Database(path)
    else:
        database._pack_cache.clear()
    metrics.reset()
    spectroscopy(database, temperature, grid, **kwargs) \
        .compute_absorption("total")
    assert lines_counters() == {"lines.builds": 1}


def test_the_least_recently_used_entry_goes_first(tmp_path):
    database = make_database(tmp_path / "evict.db")
    # Warmest layers in bound + 1 distinct 5 K buckets.
    columns = [(250.0 + 10.0 * i, 240.0)
               for i in range(reuse.STACKED_KEPT + 1)]
    for column in columns:
        spectroscopy(database, column).compute_absorption("total")
    assert len(reuse.reuse_of(database).pipelines) == reuse.STACKED_KEPT
    metrics.reset()
    spectroscopy(database, columns[-1]).compute_absorption("total")
    assert lines_counters() == {"lines.shared_hits": 1}
    metrics.reset()
    spectroscopy(database, columns[0]).compute_absorption("total")
    assert lines_counters() == {"lines.builds": 1}


def test_the_entries_die_with_the_database(tmp_path):
    database = make_database(tmp_path / "life.db")
    spec = spectroscopy(database)
    spec.compute_absorption("total")
    (fn, _, _), = spec._multigas_fns.values()
    constants = weakref.ref(fn.stage.csr_dev[0])
    del spec, fn
    gc.collect()
    assert constants() is not None
    del database
    gc.collect()
    assert constants() is None


def test_threads_share_the_cache():
    """More threads than entries put and get at once under a short switch
    interval: no lookup fails, the bound holds, every hit is its key's."""
    cache = reuse.StackedPipelines()
    errors = []

    def work(worker):
        try:
            for i in range(400):
                key = (worker, i % 6)
                cache.put(key, (), key)
                got = cache.get((worker, (i + 3) % 6))
                assert got is None or got == (worker, (i + 3) % 6)
        except Exception as exc:  # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    assert errors == []
    assert len(cache) == reuse.STACKED_KEPT


class PlainDatabase:
    """A Database-like object: the two reads a Spectroscopy makes."""

    def __init__(self, database):
        self.line_pack = database.line_pack
        self.arts_crossfit = database.arts_crossfit


def test_a_database_without_the_cache_builds_per_object(tmp_path):
    """A Database-like object shares the pipelines as a Database does, and
    its outputs are those of the Database it reads."""
    database = make_database(tmp_path / "plain.db")
    plain = PlainDatabase(database)
    first = spectroscopy(plain)
    first.compute_absorption("total")
    metrics.reset()
    second = spectroscopy(plain, SECOND)
    got = second.compute_absorption("total")
    second.compute_absorption("total")
    assert lines_counters() == {"lines.shared_hits": 1}
    want = spectroscopy(database, SECOND).compute_absorption("total")
    assert np.array_equal(got["absorption"].data, want["absorption"].data)


class SlotsDatabase:
    """A Database-like object that cannot be weakly referenced."""

    __slots__ = ("line_pack", "arts_crossfit")

    def __init__(self, database):
        self.line_pack = database.line_pack
        self.arts_crossfit = database.arts_crossfit


def test_a_database_without_weak_references_shares_nothing(tmp_path):
    """Each object on it takes a fresh reuse of its own: a new object
    builds its pipeline again, and the output is the Database's."""
    database = make_database(tmp_path / "slots.db")
    slots = SlotsDatabase(database)
    assert reuse.reuse_of(slots) is not reuse.reuse_of(slots)
    spectroscopy(slots).compute_absorption("total")
    metrics.reset()
    got = spectroscopy(slots, SECOND).compute_absorption("total")
    assert lines_counters() == {"lines.builds": 1}
    want = spectroscopy(database, SECOND).compute_absorption("total")
    assert np.array_equal(got["absorption"].data, want["absorption"].data)
