"""The port's benchmark entry point against the JAX package's ``bench.py``.

``bench.py`` at the repository root (the JAX bench) is loaded from its file
and never edited.  Here, on the CPU:

- the workloads are identical: the 300,000-line headline pack and the
  seven packs of ``multigas_packs``, array for array, and each stage's
  evaluation and point denominators equal the JAX bench's formulas on the
  same pack, grid and layers;
- each stage's output (``device="cpu"``: the kernels' plain versions, at
  2,000 lines, 2 layers, 1-500 cm-1 at 0.1 and 1-100 cm-1 at 0.01 for
  config 5) against the JAX functions the JAX bench times, the Pallas
  kernels in interpret mode, rel < 5e-6 (tests/test_lineshape_pallas.py);
  config 5's file holds each state's ``fn.total`` bit for bit;
- the timing guard (the cases of tests/test_bench_guard.py, with a fake
  timer in place of CUDA events) and its band from the card's bound;
- the output contract: the compact line last, the JAX keys, an error
  entry and a non-zero exit code for a stage that raises;
- ``fn.inner`` of the stacked pipeline equals ``fn`` bit for bit and skips
  the envelope guard.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pylbl_tpu.database.fixtures import synthetic_line_pack as jsynthetic
from pylbl_tpu.models.lines import internal_grid
from pylbl_tpu.models.lines.physics import kernel_inputs, line_profile_params
from pylbl_tpu.ops import lineshape as jls
from pylbl_tpu.ops import lineshape_pallas as jlp
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch import bench
from pylbl_tpu_torch.models.lines import LinePack
from pylbl_tpu_torch.parallel import lines as tlines

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LINES = 2000
OTHER_LINES = 500
LAYERS = 2
GRID = np.arange(1.0, 500.0, 0.1)
GRID5 = np.arange(1.0, 100.0, 0.01)
# The headline workload's masked evaluations and a count of operations
# that puts its bound rate near the H100's (PERF.md §6).
EVALS = 1.52637233e8
OPS = 1.36e9


def load_jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  REPO / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jbench():
    return load_jax_bench()


def pack_arrays(pack):
    return {f: getattr(pack, f) for f in LinePack._ARRAY_FIELDS}


def assert_packs_equal(got, want):
    assert got.formula == want.formula
    for field, value in pack_arrays(want).items():
        assert np.array_equal(getattr(got, field), value), field


def jax_multigas_packs(num_lines, other_lines):
    """The JAX bench's multigas_packs at a given size (its function has
    the full size only)."""
    return {name: jsynthetic(
        name, num_lines=num_lines if name == "H2O" else other_lines,
        nu_min=0.5, nu_max=5100.0, seed=g + 1,
        band_centers=(150.0 + 400 * g, 1600.0, 3700.0))
        for g, name in enumerate(bench.GASES)}


def once(fn, reps):
    """A timer that runs ``fn`` once and reports 1 ms."""
    fn()
    return 1.0


def rel_err(got, want, floor=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * floor)).max())


@pytest.fixture(scope="module")
def packs(jbench):
    """(port pack, JAX pack, port gases, JAX gases) at the small size."""
    pack, _ = bench.build_workload(LINES)
    jpack, _ = jbench.build_workload(LINES)
    gases = bench.multigas_packs(LINES, OTHER_LINES)
    jgases = jax_multigas_packs(LINES, OTHER_LINES)
    assert_packs_equal(pack, jpack)
    for name in gases:
        assert_packs_equal(gases[name], jgases[name])
    return pack, jpack, gases, jgases


@pytest.fixture(scope="module")
def stages(packs, tmp_path_factory):
    """Each stage's (record, output) on the CPU at the small size."""
    pack, _, gases, _ = packs
    return {
        "headline": bench.headline(pack, GRID, device="cpu", timer=once),
        "batched_4layer": bench.batched(pack, GRID, LAYERS, device="cpu",
                                        timer=once),
        "multigas_7gas": bench.multigas(gases, GRID, LAYERS, device="cpu",
                                        timer=once),
        "config5": bench.config5(gases, GRID5,
                                 tmp_path_factory.mktemp("config5"),
                                 num_layers=4, block=2, device="cpu",
                                 timer=once),
        "sharded_1chip": bench.sharded(pack, GRID, LAYERS, device="cpu",
                                       timer=once),
    }


def test_headline_workload_identical(jbench):
    """The 300,000-line headline pack and grid equal the JAX bench's, and
    so does the headline's masked evaluation count."""
    pack, grid = bench.build_workload()
    jpack, jgrid = jbench.build_workload()
    assert pack.num_lines == 300000
    assert_packs_equal(pack, jpack)
    assert np.array_equal(grid, jgrid)
    v0, vn, npv, _ = internal_grid(jgrid)
    keep = jpack.compat_break_filter(v0, vn, jbench.CUT_OFF)
    assert bench.window_evals(keep, npv) == jbench.window_evals(keep, npv) \
        == EVALS


def test_multigas_packs_identical(jbench):
    """The seven gases (420,000 lines) equal the JAX bench's, array for
    array."""
    got = bench.multigas_packs()
    want = jbench.multigas_packs()
    assert list(got) == list(want) == bench.GASES
    assert sum(p.num_lines for p in got.values()) == 420000
    for name in want:
        assert_packs_equal(got[name], want[name])


def jax_denominators(jbench, name, jpack, jgases):
    """(evals, points) per timed call of a stage by the JAX bench's
    formulas (bench.py:228, :334-335, :390-393, :476-477, :610)."""
    if name in ("multigas_7gas", "config5"):
        grid, layers = (GRID5, 2) if name == "config5" else (GRID, LAYERS)
        _, _, static, _ = jlines.stack_device_packs(jgases, grid)
        return (layers * jbench.window_evals(static["num_lines"],
                                             static["n_per_v"]),
                layers * len(jgases) * static["num_points"])
    v0, vn, npv, n = internal_grid(GRID)
    keep = jpack.compat_break_filter(v0, vn, jbench.CUT_OFF)
    layers = 1 if name == "headline" else LAYERS
    return layers * jbench.window_evals(keep, npv), layers * n


@pytest.mark.parametrize("name", ["headline", "batched_4layer",
                                  "multigas_7gas", "config5",
                                  "sharded_1chip"])
def test_stage_denominators_match_jax(jbench, packs, stages, name):
    """Each stage's evaluations and points per timed call are the JAX
    bench's on the same pack, grid and layers (config 5: per block of 2
    layers, and per pass of 4)."""
    _, jpack, _, jgases = packs
    record = stages[name][0]
    evals, points = jax_denominators(jbench, name, jpack, jgases)
    if name == "config5":
        assert record["evals_per_block"] == evals
        assert record["evals_per_pass"] == 2 * evals
        assert record["grid_points"] == GRID5.size and record["layers"] == 4
        return
    assert record["evals_per_call"] == evals
    assert record["points_per_call"] == points
    assert record["evals_per_s"] == evals / 1e-3
    assert record["method"] == bench.METHOD


def test_headline_matches_jax(packs, stages):
    """The headline plan's spectrum against the JAX bench's
    ``make_device_plan`` in interpret mode, and against float64."""
    _, jpack, _, _ = packs
    record, out = stages["headline"]
    v0, vn, npv, n = internal_grid(GRID)
    keep = jpack.compat_break_filter(v0, vn, 25)
    kin = kernel_inputs(line_profile_params(jpack, *bench.SURFACE, keep=keep),
                        v0, npv, 25)
    plan = jlp.make_device_plan(jls.prepare_kernel_arrays(kin, npv,
                                                          np.float32),
                                kin, n, npv, 25, interpret=True)
    want = np.asarray(plan.run_with(plan.soa, plan.groups))
    assert out.shape == want.shape == (n,)
    assert rel_err(out.numpy(), want) < 5e-6
    assert record["lines_kept"] == keep
    assert record["max_rel_err_vs_float64"] < 5e-4
    assert record["host_syncs"] is None


def test_batched_matches_jax(packs, stages):
    """``batched_4layer`` against ``make_batched_tpu_fn(...).inner`` in
    interpret mode on the JAX bench's layers and envelope."""
    _, jpack, _, _ = packs
    record, out = stages["batched_4layer"]
    t, p, x = bench.layers(LAYERS)
    t_max, p_max_atm = jlines.derive_envelope(t, p)
    jfn = jlines.make_batched_tpu_fn(jpack, GRID, t_max=t_max,
                                     p_max_atm=p_max_atm, interpret=True)
    want = np.asarray(jfn.inner(t, p, x))
    assert out.shape == want.shape
    assert rel_err(out.numpy(), want) < 5e-6
    assert record["max_rel_err_vs_float64"] < 5e-4
    assert record["max_rel_err_vs_oracle"] is None


def test_multigas_matches_jax(packs, stages):
    """``multigas_7gas`` against the JAX stacked pipeline's ``inner`` in
    interpret mode."""
    _, _, _, jgases = packs
    record, out = stages["multigas_7gas"]
    t, p, x = bench.layers(LAYERS, len(jgases))
    t_max, p_max_atm = jlines.derive_envelope(t, p)
    jfn = jlines.make_multigas_batched_fn(jgases, GRID, t_max=t_max,
                                          p_max_atm=p_max_atm,
                                          interpret=True)
    want = np.asarray(jfn.inner(t, p, x))
    assert out.shape == want.shape == (LAYERS, 7, internal_grid(GRID)[3])
    assert rel_err(out.numpy(), want) < 5e-6
    assert record["gases"] == 7
    assert record["max_rel_err_vs_float64"] < 5e-4


def config5_file_matches(gases, record, path, directory):
    """Every written state equals its block's ``fn.total`` bit for bit,
    and ``bytes_written`` is the file's size."""
    t, p, x = bench.layers(4, len(gases))
    t_max, p_max_atm = tlines.derive_envelope(t, p)
    fn = tlines.make_multigas_batched_fn(gases, GRID5, t_max=t_max,
                                         p_max_atm=p_max_atm, device="cpu")
    if path.suffix == ".npy":
        written = np.load(path)
    else:
        import h5py
        with h5py.File(path, "r") as f:
            written = f["absorption_total"][...]
    assert written.shape == (4, GRID5.size) and written.dtype == np.float64
    for b in range(2):
        sl = slice(2 * b, 2 * b + 2)
        want = fn.total(t[sl], p[sl], x[sl]).numpy()[:, :GRID5.size]
        assert np.array_equal(written[sl], want.astype(np.float64))
    assert record["bytes_written"] == path.stat().st_size > written.nbytes
    assert sorted(q.name for q in Path(directory).iterdir()) == [
        f"config5_cold{path.suffix}", f"config5_warm{path.suffix}"]


def test_config5_writes_each_state_bit_for_bit(packs, stages):
    """Config 5 through h5py's StreamingWriter (h5py imports here)."""
    record, path = stages["config5"]
    assert record["writer"] == "StreamingWriter (h5py)"
    assert record["cold_wall_s"] > 0 and record["wall_s"] > 0
    config5_file_matches(packs[2], record, path, path.parent)


def test_config5_without_h5py_writes_npy(packs, tmp_path, monkeypatch):
    """Where h5py does not import (the card's host), config 5 writes a
    .npy file: the same states, bit for bit."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    record, path = bench.config5(packs[2], GRID5, tmp_path, num_layers=4,
                                 block=2, device="cpu", timer=once)
    assert record["writer"] == "npy" and path.suffix == ".npy"
    monkeypatch.delitem(sys.modules, "h5py")
    config5_file_matches(packs[2], record, path, tmp_path)


def test_sharded_stage_runs_the_kernel_branch(stages):
    """``sharded_1chip`` runs the kernel branch on its own one-rank group,
    destroys the group, and gives the batched stage's spectra."""
    record, out = stages["sharded_1chip"]
    assert record["backend"] == "kernel"
    assert not dist.is_initialized()
    want = stages["batched_4layer"][1].numpy()
    assert out.shape == want.shape
    assert rel_err(out.numpy(), want) < 5e-6


def test_stage_records_have_no_launches_on_the_cpu(packs):
    """On the CPU no kernel launches: the tracked record says so."""
    record = bench.tracked(lambda: bench.headline(
        packs[0], GRID, device="cpu", timer=once)[0], torch.device("cpu"))
    assert record["launches"] == {} and record["stage_wall_s"] > 0
    assert "peak_gib" not in record


def test_oracle_parity_fields():
    """Without an oracle the parity fields are null and the cases are not
    read; with one, the largest error over the cases as a share of the
    oracle's maximum (bench.py:342-355)."""
    def unread():
        raise AssertionError("read without an oracle")
        yield

    assert bench.oracle_max_rel(None, GRID, unread()) is None

    class Oracle:
        @staticmethod
        def absorption(pack, t, p, x, v0, vn, n_per_v, cut_off):
            return np.full(4, 2.0 * t)

    got = bench.oracle_max_rel(Oracle, GRID, [
        (None, 1.0, 0.0, 0.0, np.full(4, 2.5)),
        (None, 2.0, 0.0, 0.0, np.full(4, 4.0))])
    assert got == 0.25


# --- The timing guard (tests/test_bench_guard.py, with CUDA events). -------

class FakeTimer:
    """Stands in for CUDA events: returns ``samples`` in turn (the last
    one from then on) and counts its calls."""

    def __init__(self, *samples):
        self.samples = samples
        self.calls = 0

    def __call__(self, fn, reps):
        ms = self.samples[min(self.calls, len(self.samples) - 1)]
        self.calls += 1
        return ms


def ms_at(rate):
    return EVALS / rate * 1e3


RATE_HI = bench.band_top(EVALS, OPS)


def test_clean_measurement_passes_through():
    timer = FakeTimer(ms_at(2.0e10))
    ms, method = bench.guarded_ms(None, 10, EVALS, RATE_HI, timer)
    assert method == bench.METHOD
    assert ms == ms_at(2.0e10) and timer.calls == bench.SAMPLES


def test_contended_measurement_never_clamps():
    """Samples slowed below the band by another user of the card are
    measured again and never clamped: the median of the valid ones, or,
    with none valid, the honest slow number flagged."""
    slow = ms_at(bench.RATE_LO / 10)
    timer = FakeTimer(slow, slow, ms_at(2.0e10), ms_at(2.2e10),
                      ms_at(1.8e10))
    ms, method = bench.guarded_ms(None, 10, EVALS, RATE_HI, timer)
    assert method == bench.METHOD and ms == ms_at(2.0e10)
    assert timer.calls == 5
    ms, method = bench.guarded_ms(None, 10, EVALS, RATE_HI, FakeTimer(slow))
    assert method == bench.INVALID and ms == slow
    assert EVALS / (ms / 1e3) < bench.RATE_LO


def test_implausibly_fast_rate_is_flagged():
    """A sample far above the card's bound (a lost dependence, a timer
    that saw nothing) is flagged with its own number, never passed."""
    ms, method = bench.guarded_ms(None, 10, EVALS, RATE_HI,
                                  FakeTimer(1e-9))
    assert method == bench.INVALID and ms == 1e-9
    assert EVALS / (ms / 1e3) > RATE_HI


def test_retries_are_bounded():
    for sample in (0.0, -1.0, 1e-9):
        timer = FakeTimer(sample)
        _, method = bench.guarded_ms(None, 10, EVALS, RATE_HI, timer)
        assert method == bench.INVALID and timer.calls == bench.TRIES


@pytest.mark.parametrize("share,method", [(0.9, bench.METHOD),
                                          (1.1, bench.INVALID)])
def test_band_top_is_the_cards_bound(share, method):
    """The band's top is the rate of the operations' bound at the card's
    FP32 peak (67 TFLOP/s) with a 5% margin: 90% of the bound rate
    passes, 110% is flagged."""
    bound_rate = bench.PEAK_OPS * EVALS / OPS
    assert 7.0e12 < bound_rate < 8.0e12
    assert RATE_HI == pytest.approx(1.05 * bound_rate, rel=1e-12)
    got, how = bench.guarded_ms(None, 10, EVALS, RATE_HI,
                                FakeTimer(ms_at(share * bound_rate)))
    assert how == method and got == ms_at(share * bound_rate)


# --- The output contract. ------------------------------------------------

def fake_stages(fail=None):
    def stage(name, record):
        def run():
            if name == fail:
                raise RuntimeError("kernel build failed")
            return dict(record)
        return run

    records = {"batched_4layer": {"evals_per_s": 1.5e11},
               "multigas_7gas": {"evals_per_s": 1.7e11},
               "config5": {"evals_per_s": 2.0e10},
               "sharded_1chip": {"evals_per_s": 1.4e11},
               "scaling": {"efficiency_at_4": 0.9999}}
    return {name: stage(name, r) for name, r in records.items()}


def headline_record():
    return {"evals_per_s": 3.0e11, "points_per_s": 1.0e11,
            "max_rel_err_vs_float64": 2.5e-6}


def test_compact_line_is_last_with_the_jax_keys(jbench, capsys):
    code = bench.report(headline_record, fake_stages(), {"card": "x"},
                        torch.device("cpu"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert code == 0 and len(lines) == 3
    provisional, full, compact = (json.loads(line) for line in lines)
    assert provisional["stages"] == "pending"
    want_keys = set(jbench.compact_summary(1.0, 1.0, {})) \
        - {"scaling_eff_at_8"} | {"scaling_eff_at_4"}
    assert set(compact) == want_keys
    assert compact["metric"] == "voigt_line_point_evals_per_s"
    assert compact["value"] == 3.0e11
    assert compact["vs_baseline"] == 3.0e11 / bench.PINNED_C_EVALS_PER_S
    assert compact["parity_max_rel"] == 2.5e-6
    assert compact["stages"] == {"batched": 1.5e11, "multigas": 1.7e11,
                                 "config5": 2.0e10, "sharded_1chip": 1.4e11}
    assert compact["scaling_eff_at_4"] == 0.9999
    extra = full["extra"]
    assert extra["parity"]["reference"] == "float64 plain path on the card"
    assert extra["card"] == "x" and extra["headline"]["launches"] == {}
    assert all(extra[k]["launches"] == {} for k in fake_stages())
    assert len(lines[-1]) < 600


def test_failed_stage_leaves_an_error_and_exits_nonzero(capsys):
    code = bench.report(headline_record, fake_stages(fail="config5"), {},
                        torch.device("cpu"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert code != 0
    full, compact = json.loads(lines[-2]), json.loads(lines[-1])
    assert full["extra"]["config5"] == \
        "error: RuntimeError: kernel build failed"
    assert compact["stages"]["config5"].startswith("error: RuntimeError")
    assert compact["stages"]["multigas"] == 1.7e11


# --- fn.inner of the stacked pipeline. ------------------------------------

def test_multigas_inner_equals_fn_without_the_guard(packs):
    """``fn.inner`` / ``fn.inner_total`` equal ``fn`` / ``fn.total`` bit
    for bit and skip the envelope guard, which ``fn.check_envelope``
    runs once on host arrays."""
    gases = packs[2]
    t, p, x = bench.layers(LAYERS, len(gases))
    fn = tlines.make_multigas_batched_fn(gases, GRID, t_max=300.0,
                                         p_max_atm=1.0, device="cpu")
    assert torch.equal(fn.inner(t, p, x), fn(t, p, x))
    assert torch.equal(fn.inner_total(t, p, x), fn.total(t, p, x))
    fn.check_envelope(t, p)
    hot = t + np.float32(10.0)
    for call in (fn, fn.total):
        with pytest.raises(ValueError, match="t_max"):
            call(hot, p, x)
    with pytest.raises(ValueError, match="t_max"):
        fn.check_envelope(hot, p)
    assert torch.isfinite(fn.inner(hot, p, x)).all()
    assert torch.isfinite(fn.inner_total(hot, p, x)).all()
