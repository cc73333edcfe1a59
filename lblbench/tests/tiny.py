"""A cell cut to a size the CPU runs in seconds: the cell's own files with
the grid, the layers and the line counts made small."""
import copy
import time

from lblbench.harness import main, spec

ROOT = main.ROOT


def tiny(cell, sites=None):
    """The cell with its configuration cut: 1-300 cm-1, 6 layers, 2,000
    H2O lines and 200 of each other gas, bands inside the grid."""
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = dict(cfg["grid"], start=1.0, stop=300.0)
    cfg["layers"] = 6
    lines = cfg["lines"]
    lines["counts"] = {k: 2000 if k == "H2O" else 200
                       for k in lines["counts"]}
    lines.update(nu_max=400.0, band_step=30.0, shared_bands=[100.0],
                 band_width=20.0)
    if sites is not None:
        cfg["sites"] = sites
    cell.config = cfg
    return cell


def tiny_cell(name, root=ROOT, sites=None):
    return tiny(spec.cell(root, name), sites)


def run(cell, seed=2 ** 31 + 7, seconds=0.5, traced=False,
        factory=main.System, root=ROOT):
    """run_cell on the CPU."""
    return main.run_cell(root, cell, seed, seconds, traced, "cpu",
                         time.perf_counter(), factory)
