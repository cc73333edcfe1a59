"""A kernel of this checkout against other builds of ``csrc/lineshape.cu``.

The shared part of ``wings_ab`` and ``core_ab``, which give it their cells:
per cell a launch through the current library with pieces of a given
number of chunks and its plain version at that piece size.  It builds
this checkout's library anew (so that its ``-Xptxas -v`` report is read)
and one library per other source at once, with the port's nvcc flags,
bound as the port's; then per cell it runs the builds in turns (the
others, this checkout's twice, the others in reverse), each timed with
CUDA events over ``reps`` warm launches and, given the kernel's name, the
kernel alone from a ``torch.profiler`` trace of as many; and it compares
each build's result with the plain version at its piece size (max abs
difference; 0 is bit for bit).

``--other PATH.cu[:K]`` names a source file, for example an earlier
commit's ``lineshape.cu`` unpacked into an ignored directory, or
``this`` for this checkout's library, and the chunks per piece its walk
takes (by default the tool's own: None is the plan's choice).
"""
import argparse
import concurrent.futures
import hashlib
import json
from pathlib import Path

from . import device_ms, kernel_device_ms, run_main
from ..ops import lineshape_cuda as lc
from ..runtime.build import BUILD_LOGS, build_dir, load_library

OWN = "liblineshape_cuda.so"


def parse_other(spec, piece):
    """``PATH[:K]`` -> (Path, or None for ``this``, K or ``piece``)."""
    path, _, k = spec.partition(":")
    return (None if path == "this" else Path(path),
            int(k) if k else piece)


def other_library(path):
    """A library built from ``path`` with the port's nvcc flags (named by
    the source's hash), bound as the port's: (library, build log name);
    this checkout's for None."""
    if path is None:
        return lc.cuda_library(), OWN
    tag = hashlib.sha256(path.read_bytes()).hexdigest()[:12]
    name = f"liblineshape_ab_{tag}.so"
    return lc.bind_library(load_library(name, [path.resolve()],
                                        lc._nvcc_command)), name


def load_builds(others, piece):
    """[(label, library, build log name, piece)]: this checkout's library,
    built anew, at ``piece`` (label ``this``), then one per ``others``
    entry (path or None, piece), all built at once."""
    (build_dir() / OWN).unlink(missing_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(others) + 1) as pool:
        mine = pool.submit(lc.cuda_library)
        theirs = [pool.submit(other_library, path) for path, _ in others]
        builds = [("this", mine.result(), OWN, piece)]
        for (path, k), done in zip(others, theirs):
            lib, name = done.result()
            builds.append((f"{path or 'this'}:{'plan' if k is None else k}",
                           lib, name, k))
    return builds


def build_usage(builds, usage):
    """{label: ``usage`` of the build's compiler log}."""
    return {label: usage(BUILD_LOGS.get(name, ""))
            for label, _, name, _ in builds}


def in_turns(builds, run, plain, reps, kernel=None):
    """One cell through every build in turns: {label: {"ms": [...],
    "kernel_ms": [...] (with ``kernel``; None where the trace holds no
    such kernel), "max_abs_vs_plain": x}}, ``run(piece)`` launching
    through the current library, ``plain(piece)`` its plain version."""
    order = builds[1:] + [builds[0], builds[0]] + builds[:0:-1]
    out = {label: {"ms": []} for label, *_ in builds}
    plains = {}
    own = lc.cuda_library
    try:
        for label, lib, _, piece in order:
            lc.cuda_library = lambda lib=lib: lib
            rec = out[label]
            rec["ms"].append(device_ms(lambda: run(piece), reps))
            if kernel is not None:
                rec.setdefault("kernel_ms", []).append(kernel_device_ms(
                    lambda: run(piece), reps, kernel))
            if "max_abs_vs_plain" not in rec:
                if piece not in plains:
                    plains[piece] = plain(piece)
                rec["max_abs_vs_plain"] = float(
                    (run(piece) - plains[piece]).abs().max())
    finally:
        lc.cuda_library = own
    return out


def print_turns(turns):
    for label, rec in turns.items():
        ms = ", ".join(f"{t:.4f}" for t in rec["ms"])
        alone = ""
        if "kernel_ms" in rec:
            alone = ", kernel alone " + ", ".join(
                "none" if t is None else f"{t:.4f}" for t in rec["kernel_ms"])
        print(f"  {label}: {ms} ms{alone} (max abs vs its plain "
              f"{rec['max_abs_vs_plain']:.3e})", flush=True)


def write_report(report, out):
    if out:
        Path(out).write_text(json.dumps(report, indent=1))
    return report


def main(tool, doc, run, cells, piece, argv=None):
    """The tools' command line: ``--other`` (repeated), ``--cells``,
    ``--reps``, ``--json``; exit code 2 without a CUDA card."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another lineshape.cu, PATH[:chunks per piece]")
    ap.add_argument("--cells", default=",".join(cells))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    return run_main(tool, run, [parse_other(o, piece) for o in args.other],
                    args.cells.split(","), args.reps, args.json)
