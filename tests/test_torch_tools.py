"""The port's tools (pylbl_tpu_torch/tools) on the CPU at a small size.

Their workload and plan builders run on any device; their timing entry
points need a CUDA card and refuse to run without one.  The stages are held
against each other and against the JAX package's formulations at the
tolerances of tests/test_torch_lineshape.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pylbl_tpu.database.fixtures import synthetic_line_pack
from pylbl_tpu.ops import lineshape_pallas as jlp
from pylbl_tpu.parallel import lines as jlines

from pylbl_tpu_torch.models.lines import LinePack
from pylbl_tpu_torch.ops import lineshape_cuda as lc
from pylbl_tpu_torch.parallel import lines as tlines
from pylbl_tpu_torch.tools import (NoCudaError, ab, batched_microbench,
                                   bench_scaling, census_bound, core_ab,
                                   core_bytes, core_census,
                                   envelope_compare, headline_pack,
                                   kernel_microbench, layer_workload,
                                   masked_evals, parity_ab, walk_usage,
                                   wings_ab)

torch.set_num_threads(1)


def rel_err(got, want, floor=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(
        np.abs(want), np.abs(want).max() * floor)).max())


@pytest.fixture(scope="module")
def work():
    """The headline pack cut to 3000 lines below 260 cm-1, surface layer,
    1-220 cm-1 at 0.1."""
    return layer_workload(headline_pack(3000, nu_max=260.0),
                          np.arange(1.0, 220.0, 0.1))


def test_kernel_microbench_stages_on_cpu(work):
    stages = kernel_microbench.build_stages(work, "cpu")
    names = [name for name, _, _ in stages]
    assert names[:8] == ["wings", "core-scalar", "core-rows",
                         "core-rows-vmem", "core-seg", "core-segmix",
                         "two-pass", "two-pass-seg"]
    stride = lc.pick_wings_stride(1024, (2 * 25 + 1) * 10 + 1)
    assert names[8:] == [f"wings-strided-checked[{stride}]",
                         f"wings-strided[{stride}]", "two-pass-strided"]
    lc.reset_launches()
    out = {name: fn().numpy() for name, fn, _ in stages}
    assert sum(lc.LAUNCHES.values()) == 0
    n = work["n"]
    assert all(v.shape == (n,) and np.isfinite(v).all()
               for v in out.values())
    np.testing.assert_array_equal(out["core-rows-vmem"], out["core-rows"])
    core_scale = np.abs(out["core-scalar"]).max()
    assert core_scale > 0
    for name in ("core-rows", "core-seg", "core-segmix"):
        np.testing.assert_allclose(out[name], out["core-scalar"], rtol=0,
                                   atol=core_scale * 1e-6)
    for name in (f"wings-strided-checked[{stride}]",
                 f"wings-strided[{stride}]"):
        assert rel_err(out[name], out["wings"]) < 5e-6
    for name in ("two-pass", "two-pass-seg", "two-pass-strided"):
        assert rel_err(out[name], out["wings"] + out["core-segmix"]) < 5e-6
    assert masked_evals(work) == work["keep"] * 511


def test_kernel_microbench_checked_wings_match_pallas(work):
    """The tool's checked strided stage (assign = clip(s_idx, 0) // stride
    on the straddle CSR) against the Pallas kernel on the same inputs."""
    arrays, n = work["arrays"], work["n"]
    soa, num = lc.pack_lines_soa(arrays, 512)
    s = arrays["s_idx"].astype(np.int64)
    stride = 512
    assign = np.clip(s, 0, None) // stride
    soa[lc._PAD, :num] = assign.astype(np.float32)
    soa[lc._PAD, num:] = -1.0
    st, nc = lc.strided_line_ranges(assign, (n - 1) // stride + 1)
    want = np.asarray(jlp._pallas_pass_strided(
        jnp.asarray(soa), st, nc, n, 1024, stride, interpret=True))
    stages = {name: fn for name, fn, _ in
              kernel_microbench.build_stages(work, "cpu")}
    got = stages[f"wings-strided-checked[{stride}]"]().numpy()
    assert rel_err(got, want) < 5e-6


def test_parity_ab_compare_on_cpu(work):
    records = list(parity_ab.compare(work, "cpu"))
    assert [(c, w) for c, w, *_ in records] == list(parity_ab.PAIRS)
    for core_mode, wings_mode, err, rel, _ in records:
        assert np.isfinite(err) and rel < 5e-6, (core_mode, wings_mode)


@pytest.mark.parametrize("core_mode", ["rows", None])
def test_batched_microbench_stages_on_cpu(core_mode):
    pack = headline_pack(3000, nu_max=260.0)
    fn, (t, p, x) = batched_microbench.build(
        pack, np.arange(1.0, 220.0, 0.1), 2, core_mode=core_mode,
        device="cpu")
    stages = dict(batched_microbench.build_stages(fn, t, p, x))
    assert list(stages)[:2] == ["physics", "assemble(phys+blocks)"]
    soa, core = stages["assemble(phys+blocks)"]()
    wings_name, core_name = list(stages)[2:4]
    assert wings_name == f"wings[{fn.wings_stride}]"
    assert core_name.startswith(f"core-{core_mode or 'segmix'}[")
    full = stages["full"]()
    total = stages[wings_name]() + stages[core_name]()
    np.testing.assert_array_equal(full.numpy(), total.numpy())
    assert rel_err(full.numpy(), fn(t, p, x).numpy()) == 0


def test_batched_microbench_splat_takes_the_pipelines_pass_kind():
    """At 0.02 cm-1 no stride fits and a "seg" core takes raw splat rows
    (``wings_prepacked`` False): the tool's wings stage runs the raw
    Lorentzian, where the JAX tool's hard-coded "wings_pre" would read the
    raw rows as prepacked ones."""
    pack = headline_pack(3000, nu_max=260.0)
    fn, (t, p, x) = batched_microbench.build(
        pack, np.arange(1.0, 220.0, 0.02), 2, core_mode="seg", device="cpu")
    assert fn.wings_stride is None and not fn.wings_prepacked
    soa, _ = fn.stage.assemble(t, p, x)
    got = batched_microbench.wings_stage(fn, soa)().numpy()
    np.testing.assert_array_equal(got, fn.wings_pass(soa).numpy())
    start, nchunks = fn.wings_csr
    prepacked = lc.tile_pass(soa, start, nchunks, fn.core_plan.num_points,
                             fn.core_plan.tile, fn.wings_chunk,
                             "wings_pre").numpy()
    assert rel_err(prepacked, got) > 1e-2


def test_envelope_compare_build_on_cpu():
    """The tool's two pipelines at a small size: the derived envelope is
    tighter than 350 K / 5 atm, plans no more core instances and gives the
    default's spectra (tests/test_parallel.py:143 tolerance)."""
    pack = headline_pack(3000, nu_max=260.0)
    variants, (t, p, x), (t_max, p_max_atm) = envelope_compare.build(
        pack, np.arange(1.0, 220.0, 0.1), 4, device="cpu")
    assert list(variants) == ["default_350K_5atm", "derived"]
    assert t.dtype == torch.float32 and t.shape == (4,)
    assert t_max < 350.0 and p_max_atm < 5.0
    default, derived = variants.values()
    assert 0 < derived.core_plan.num_instances \
        <= default.core_plan.num_instances
    lc.reset_launches()
    want, got = (fn.inner(t, p, x).numpy().astype(np.float64)
                 for fn in (default, derived))
    assert sum(lc.LAUNCHES.values()) == 0
    scale = max(want.max(), 1e-300)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=scale * 1e-7)


def test_batched_fn_tight_envelope_matches_default():
    """Port of tests/test_parallel.py:143-161 through make_batched_fn on
    the CPU: the atmosphere-derived envelope only shrinks the core-instance
    windows, so both envelopes give the same spectra, and each equals the
    JAX pipeline under the same envelope (interpret mode, rel 5e-6)."""
    jpack = synthetic_line_pack(num_lines=400, nu_min=0.6, nu_max=360.0,
                                seed=31)
    pack = LinePack(formula=jpack.formula, **{
        f: getattr(jpack, f) for f in LinePack._ARRAY_FIELDS})
    grid = np.arange(1.0, 320.0, 0.5)
    temperature = np.asarray([288.99, 269.01, 227.74, 203.37], np.float32)
    pressure = np.asarray([98388.0, 117.0, 1032.0, 11419.0], np.float32)
    vmr = np.full(4, 6.6e-3, np.float32)
    t_max, p_max = tlines.derive_envelope(temperature, pressure)
    assert (t_max, p_max) == jlines.derive_envelope(temperature, pressure)
    outs = []
    for kwargs in ({}, {"t_max": t_max, "p_max_atm": p_max}):
        fn = tlines.make_batched_fn(pack, grid, tile=256, chunk=128,
                                    device="cpu", **kwargs)
        got = fn(temperature, pressure, vmr).numpy().astype(np.float64)
        jfn = jlines.make_batched_tpu_fn(jpack, grid, tile=256, chunk=128,
                                         interpret=True, **kwargs)
        assert rel_err(got, jfn(temperature, pressure, vmr)) < 5e-6
        outs.append(got)
    scale = max(outs[0].max(), 1e-300)
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-6,
                               atol=scale * 1e-7)


@pytest.mark.parametrize("tool", [kernel_microbench, parity_ab,
                                  batched_microbench, envelope_compare,
                                  bench_scaling])
def test_tools_refuse_to_run_without_cuda(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaError, match="CUDA"):
        tool.run()
    assert tool.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().out


def test_bench_scaling_work_model_on_cpu():
    """bench_scaling's measurement at a small size on CPU ranks (the
    portable branch there): one rank does all the work, two split it
    near evenly in balanced mode, both within 5e-4 of float64."""
    results = bench_scaling.measure("balanced", specs=(1, 2), reps=1,
                                    num_lines=300, grid=(1.0, 200.0, 0.5),
                                    device="cpu")
    assert [r["spec"] for r in results] == [1, 2]
    assert results[0]["work_efficiency"] == 1.0
    assert 0.9 < results[1]["work_efficiency"] <= 1.0
    assert all(r["max_rel_err"] < 5e-4 and r["duplication"] == 1.0
               for r in results)


def test_core_ab_refuses_without_cuda_and_parses_its_builds(monkeypatch,
                                                            capsys):
    """core_ab exits 2 without a card, whatever it was asked; ``--other``
    takes PATH[:K] (``this`` for this checkout, K by default the tool's
    own: None, the plan's piece size, for the core; WINGS_PIECE_CHUNKS
    for the wings); its cells are the census's."""
    from pathlib import Path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaError, match="CUDA"):
        core_ab.run([])
    assert core_ab.main(["--other", "build/ab_src/parent/lineshape.cu:4",
                         "--other", "this:1", "--cells", "A,C",
                         "--reps", "3"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().out
    assert ab.parse_other("this", None) == (None, None)
    assert ab.parse_other("this:2", None) == (None, 2)
    assert ab.parse_other("a/b.cu:1", None) == (Path("a/b.cu"), 1)
    assert ab.parse_other("a/b.cu", lc.WINGS_PIECE_CHUNKS) == (
        Path("a/b.cu"), lc.WINGS_PIECE_CHUNKS)
    assert core_census.CORE_CELLS == ("A16", "A", "B", "C", "D", "F", "G")
    assert core_census.CELLS == core_census.CORE_CELLS + ("Cc", "Rc", "R16",
                                                          "Sc", "S16")
    assert core_ab.CELLS == core_census.CORE_CELLS + ("Cc", "Rc", "Rv",
                                                      "R16", "Sc", "S16")
    with pytest.raises(SystemExit):
        core_ab.main(["--reps", "x"])


def test_core_census_describes_a_cell_on_cpu():
    """The census's lines for a synthetic cell: its counts, both bounds."""
    params, t_start, t_chunks, _ = core_census.synthetic_core(0)
    params = torch.as_tensor(params)
    counts = core_census.census(params, t_start, t_chunks)
    nbytes = core_bytes(params, t_chunks.size, 256 * t_chunks.size)
    assert nbytes == 4 * (params.numel() + 2 * t_chunks.size
                          + params.shape[0] * 256 * t_chunks.size)
    text = core_census.describe("S", counts, params, nbytes)
    assert text.startswith(f"S: {counts['chunks']} chunks")
    bound, bound_by = census_bound(counts, nbytes)
    assert f"bound {bound:.6f} ms ({bound_by}, {nbytes} bytes)" in text
    assert f"needed {counts['needed_total']}" in text
    assert "census operations" in text and "core_ops" in text
    with pytest.raises(ValueError, match="unknown cell"):
        core_census.build_cells(["Z"], "cpu")


def test_core_ab_unit_walk_cells_on_cpu(monkeypatch, capsys):
    """core_ab's unit-walk cells, made at a small size on the CPU (3000
    headline lines; R16 over the canonical 16 layers): CORR on the core
    CSR, the rows core with and without the separate min-y block and on
    the column; each launch (the plain version here) equals its plain
    version, the census sees needed points and none outside the need
    window, the 41-operation count is the cell's, and the description
    carries both bounds.  Asked for these cells, the tool exits 2 without
    a card."""
    from pylbl_tpu_torch.tools import rows_ops, tile_ops

    work = layer_workload(headline_pack(3000, nu_max=260.0),
                          np.arange(1.0, 220.0, 0.1))
    cells = core_census.build_cells(["Cc", "Rc", "Rv", "R16"], "cpu", work)
    assert [c.name for c in cells] == ["Cc", "Rc", "Rv", "R16"]
    assert [c.kind for c in cells] == ["corr", "rows", "rows_vmem", "rows"]
    assert cells[0].kernel == ("corr_walk_kernel", "wings_kernel")
    assert cells[3].data.shape[0] == 16
    lc.reset_launches()
    for cell in cells:
        got = cell.run(None)
        assert got.shape[-1] == work["n"] and float(got.abs().max()) > 0
        assert torch.equal(got, cell.plain(None))
        counts = cell.census()
        assert counts["needed_total"] > 0 and counts["needed_outside"] == 0
        assert counts["visits"] < counts["parent_lane_evals"] // 32
        if cell.kind == "corr":
            assert cell.ops41 == tile_ops(cell.data, work["n"], "corr")
        else:
            assert cell.ops41 == rows_ops(cell.data, cell.walk.g_n,
                                          cell.tile)
        text = core_census.describe_cell(cell, counts)
        bound, bound_by = census_bound(counts, cell.nbytes)
        assert f"bound {bound:.6f} ms ({bound_by}, {cell.nbytes} bytes)" \
            in text and "41-operation count" in text
    assert torch.equal(cells[1].run(None), cells[2].run(None))
    assert sum(lc.LAUNCHES.values()) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert core_ab.main(["--other", "build/ab_src/parent/lineshape.cu",
                         "--cells", "Cc,Rc,Rv,R16"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().out


def test_segment_cells_on_cpu(monkeypatch, capsys):
    """The segment pass's cells, made at a small size on the CPU (3000
    headline lines): core_ab's Sc (C's plan, ``core_mode="seg"``) and S16
    (the canonical 16-layer column, ``make_batched_fn(core_mode="seg")``)
    and wings_ab's Sw (``wings_mode="seg"``); each launch (the plain
    version here) equals its plain version; their kernels' names cover
    the chunk kernel, the fold and the earlier chunk kernel; their bytes
    are the 7 rows read; the wings' bound is the larger of 7 operations a
    term and those bytes; the cores' census sees needed points and
    describes both bounds.  Asked for these cells, both tools exit 2
    without a card."""
    from pylbl_tpu_torch.tools import (OPS_LORENTZ, PEAK_BYTES, PEAK_OPS,
                                       seg_bytes, seg_wings_evals)

    work = layer_workload(headline_pack(3000, nu_max=260.0),
                          np.arange(1.0, 220.0, 0.1))
    cells = core_census.build_cells(["Sc", "S16"], "cpu", work)
    cells.append(wings_ab.seg_wings_cell("cpu", work))
    assert [c.name for c in cells] == ["Sc", "S16", "Sw"]
    assert [c.kind for c in cells] == ["core", "core", "wings"]
    assert cells[1].params.shape[0] == 16
    lc.reset_launches()
    for cell in cells:
        assert cell.kernel[1:] == ("seg_fold_kernel", "seg_chunk_kernel")
        got = cell.run(None)
        assert got.shape[-1] == work["n"] and float(got.abs().max()) > 0
        assert torch.equal(got, cell.plain(None))
        assert cell.nbytes == seg_bytes(cell.kind, cell.params,
                                        cell.plan.streams, work["n"])
        if cell.kind == "wings":
            evals = seg_wings_evals(cell.params, cell.plan.streams)
            assert cell.evals == evals > 0
            assert cell.bound_ms == max(OPS_LORENTZ * evals / PEAK_OPS,
                                        cell.nbytes / PEAK_BYTES) * 1e3
            continue
        counts = cell.census()
        assert counts["needed_total"] > 0
        text = core_census.describe_cell(cell, counts)
        bound, bound_by = census_bound(counts, cell.nbytes)
        assert f"bound {bound:.6f} ms ({bound_by}, {cell.nbytes} bytes)" \
            in text and "core_ops" in text
    assert sum(lc.LAUNCHES.values()) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert core_ab.main(["--other", "build/ab_src/parent/lineshape.cu",
                         "--cells", "Sc,S16"]) == 2
    assert wings_ab.main(["--other", "build/ab_src/parent/lineshape.cu",
                          "--cells", "Sw"]) == 2
    assert capsys.readouterr().out.count("needs a CUDA card") == 2


def ptxas_entry(name, registers, stores=0, loads=0, smem=16):
    """One kernel's lines of nvcc's ``-Xptxas -v`` report."""
    return (f"ptxas info    : Compiling entry function '{name}' for "
            "'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, {loads} "
            "bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, {smem} bytes smem, "
            "464 bytes cmem[0]\n")


WALK_ARGS = "EEEvPKfxxPKiS4_S4_S4_xPfiiiiiNS_6PiecesE"
NS = "_ZN45_GLOBAL__N__cf9d4631_12_lineshape_cu_aa8bbb12"


def test_wings_ab_cells_and_walk_usage_by_line_kind(monkeypatch, capsys):
    """wings_ab's cells: the prepacked ones and D, Cr, Bs (RAW), Co, E2
    (OWN), each with its line kind; it exits 2 without a card and refuses
    an unknown cell.  ``walk_usage`` reads every instantiation of the
    Lorentzian walk by line kind from a ``-Xptxas -v`` log (the CORR
    kernel and the core are not the walk), and an earlier build's walk of
    one template argument as PRE."""
    assert wings_ab.CELLS == ("D", "Cr", "Bs", "Co", "E2", "A16", "A", "B",
                              "C", "Ct", "F", "G", "Sw")
    assert wings_ab.LINES == {"D": "raw", "Cr": "raw", "Bs": "raw",
                              "Co": "own", "E2": "own"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert wings_ab.main(["--other", "build/ab_src/parent/lineshape.cu:1",
                          "--cells", "D,Cr,Bs,Co,E2"]) == 2
    assert "needs a CUDA card" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown cell"):
        wings_ab.build_cells(["D", "Z"], "cpu")
    log = "".join([
        ptxas_entry(f"{NS}19lorentz_walk_kernelILi4ELi3E{WALK_ARGS}", 32,
                    8, 12),
        ptxas_entry(f"{NS}12wings_kernelILi4EEEvPKfxxPKiS4_S4_S4_xPfiiiii"
                    "NS_6PiecesE", 64, 28, 40, 28688),
        ptxas_entry(f"{NS}19lorentz_walk_kernelILi4ELi1E{WALK_ARGS}", 32),
        ptxas_entry(f"{NS}18core_segmix_kernelEPKfxxPKiS3_PfiiNS_6PiecesE",
                    72, smem=33792),
        ptxas_entry(f"{NS}19lorentz_walk_kernelILi4ELi0E{WALK_ARGS}", 31)])
    use = walk_usage(log)
    assert use == {
        "own": {"registers": 32, "spill_stores": 8, "spill_loads": 12,
                "smem": 16, "points": 4},
        "raw": {"registers": 32, "spill_stores": 0, "spill_loads": 0,
                "smem": 16, "points": 4},
        "pre": {"registers": 31, "spill_stores": 0, "spill_loads": 0,
                "smem": 16, "points": 4}}
    earlier = ptxas_entry(f"{NS}19lorentz_walk_kernelILi4E{WALK_ARGS}", 32)
    assert walk_usage(earlier) == {"pre": {
        "registers": 32, "spill_stores": 0, "spill_loads": 0, "smem": 16,
        "points": 4}}
    assert walk_usage("") is None


def test_pair_usage_reads_the_unit_walks_and_the_earlier_corr():
    """``pair_usage`` reads CORR and the rows core (with and without the
    separate min-y block) at tile 1024 from a ``-Xptxas -v`` log, and an
    earlier build's CORR (``wings_kernel<4>``) where the log has no unit
    walk."""
    from pylbl_tpu_torch.tools import pair_usage

    rows_args = "EEEvPKfxxS2_xPKiS4_PfiiNS_6PiecesE"
    log = "".join([
        ptxas_entry(f"{NS}16corr_walk_kernelILi4E{WALK_ARGS}", 64),
        ptxas_entry(f"{NS}11rows_kernelILi1ELb0E{rows_args}", 50),
        ptxas_entry(f"{NS}11rows_kernelILi4ELb0E{rows_args}", 56),
        ptxas_entry(f"{NS}11rows_kernelILi4ELb1E{rows_args}", 55, 4, 4)])
    use = pair_usage(log)
    assert use["corr"]["registers"] == 64
    assert use["rows"]["registers"] == 56
    assert use["rows_vmem"] == {"registers": 55, "spill_stores": 4,
                                "spill_loads": 4, "smem": 16}
    earlier = ptxas_entry(f"{NS}12wings_kernelILi4EEEvPKfxxPKiS4_S4_S4_xPf"
                          "iiiiiNS_6PiecesE", 64, 28, 40, 28688)
    assert pair_usage(earlier)["corr"] == {
        "registers": 64, "spill_stores": 28, "spill_loads": 40,
        "smem": 28688}
    assert pair_usage("") == {"corr": None, "rows": None, "rows_vmem": None}


def test_segment_usage_reads_this_and_the_earlier_chunk_kernels():
    """core_ab's and wings_ab's reading of the segment pass's chunk
    kernels from a ``-Xptxas -v`` log: ``seg_core_kernel`` and
    ``seg_wings_kernel``, or an earlier build's ``seg_chunk_kernel<0>``
    and ``<1>``."""
    seg_args = "EEvPKfxxPKiiPf"
    log = "".join([
        ptxas_entry(f"{NS}15seg_core_kernelILb0{seg_args}", 59, smem=34288),
        ptxas_entry(f"{NS}16seg_wings_kernelEPKfxxPKiS3_iPf", 37,
                    smem=32768)])
    assert core_ab.build_usages(log)["seg_core"]["registers"] == 59
    assert wings_ab.seg_wings_usage(log) == {
        "registers": 37, "spill_stores": 0, "spill_loads": 0,
        "smem": 32768}
    earlier = "".join(ptxas_entry(
        f"{NS}16seg_chunk_kernelILi{k}EEEvPKfxxPKiS4_iPf", 40 + k)
        for k in (0, 1))
    assert core_ab.build_usages(earlier)["seg_core"]["registers"] == 40
    assert wings_ab.seg_wings_usage(earlier)["registers"] == 41
    assert wings_ab.seg_wings_usage("") is None


def test_wings_ab_raw_and_own_cells_on_cpu():
    """wings_ab's RAW and OWN cells, made at a small size on the CPU
    (3000 headline lines): D's splat where no stride fits, Cr's
    forced by ``wings_mode="tile"``, Co's straddle CSR at the strided
    plan's stride; each cell's pass at piece sizes 1 and 4 equals its
    plain version at that piece size, and counts its operations by its
    line kind."""
    from pylbl_tpu_torch.tools import CUT_OFF, OPS_LORENTZ, tile_ops

    pack = headline_pack(3000, nu_max=260.0)
    fine = layer_workload(pack, np.arange(1.0, 60.0, 0.01))
    coarse = layer_workload(pack, np.arange(1.0, 220.0, 0.1))
    plan = lc.make_device_plan(coarse["arrays"], coarse["kin"], coarse["n"],
                               coarse["npv"], CUT_OFF, device="cpu")
    cells = [(wings_ab.raw_cell("D", fine, "cpu"), fine["n"]),
             (wings_ab.raw_cell("Cr", coarse, "cpu", wings_mode="tile"),
              coarse["n"]),
             (wings_ab.straddle_cell("Co", coarse["arrays"], coarse["n"],
                                     plan.wings_stride, "cpu"), coarse["n"])]
    lc.reset_launches()
    for cell, n in cells:
        assert cell.line == wings_ab.LINES[cell.name]
        assert cell.evals * OPS_LORENTZ == cell.ops == tile_ops(cell.soa, n,
                                                                cell.line)
        for piece in (1, 4):
            got = cell.run(piece)
            assert float(got.abs().max()) > 0
            assert torch.equal(got, cell.plain(piece))
    assert sum(lc.LAUNCHES.values()) == 0
    own = cells[2][0].soa
    assert bool((own[lc._PAD] >= 0).any()) and bool((own[lc._PAD] == -1).any())
