"""Command-line interface (counterpart of pylbl_tpu/__main__.py).

    python -m pylbl_tpu_torch info
    python -m pylbl_tpu_torch compute --atmosphere atm.nc \
        --database spectra.db --grid 1:3000:0.1 --output absorption.nc \
        --format total
    python -m pylbl_tpu_torch create-db --database spectra.db \
        --api-key KEY [--molecules H2O,CO2] [--xsec-dir .cross-sections]
    python -m pylbl_tpu_torch bench

``info`` and ``compute`` run on the CUDA card by default and refuse to
start without one; ``--device cpu`` (or the JAX command line's
``--platform cpu``) runs them on the host (the kernels' plain versions).
``--platform gpu`` (or ``cuda``) is the card; ``--platform tpu`` exits
non-zero: this package runs on a CUDA card, not a TPU.  ``create-db``
downloads from the HITRAN and TIPS web services and the arts-crossfit
archive into a database; it launches nothing and runs on any host.  ``bench`` (``pylbl_tpu_torch/bench.py``)
measures the kernels on the card and exits 2 without one: its last two
lines are the full record and the compact headline (JSON).
Under torchrun, ``compute --mesh BxS`` shards the lines over a (batch,
spec) mesh of the ranks (one card per rank over NCCL; ranks that share a
card, or CPU ranks, over gloo)::

    torchrun --nproc-per-node 4 -m pylbl_tpu_torch compute --mesh 2x2 \
        --sharding-mode balanced ...

Rank 0 writes the output.
"""
import argparse
import json
import sys

import numpy as np


def _parse_grid(spec):
    lo, hi, res = (float(x) for x in spec.split(":"))
    return np.arange(lo, hi, res)


def cmd_info(args):
    import torch

    from . import __version__, plugins
    from .ops.lineshape_cuda import CUDA_SOURCES
    from .runtime import build, native
    device = args.device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"pylbl_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} CUDA device(s); device {device}: "
          f"{name}")
    print(f"lines backends: {sorted(plugins.molecular_lines)}")
    print(f"continua backends: {sorted(plugins.continua)}")
    print(f"cross-section backends: {sorted(plugins.cross_sections)}")
    print(f"native runtime: "
          f"{'available' if native.available() else 'unavailable'}")
    built = build.is_built("liblineshape_cuda.so", CUDA_SOURCES)
    print(f"CUDA kernels: "
          f"{'built' if built else 'not built (built at first use)'} "
          f"under {build.BUILD_DIR}")
    return 0


def cmd_compute(args):
    import torch.distributed as dist

    from .database.db import Database
    from .spectroscopy import Spectroscopy
    from .utils.observability import configure_logging, metrics
    from .utils.xrlite import open_dataset
    device = args.device
    configure_logging()
    atmosphere = open_dataset(args.atmosphere)
    database = Database(args.database, pack_cache_dir=args.pack_cache_dir)
    mesh = None
    owns_group = False
    if args.mesh:
        from .parallel.distributed import initialize
        from .parallel.mesh import make_mesh
        owns_group = not dist.is_initialized()
        if not initialize():
            raise SystemExit("--mesh needs a process group: run under "
                             "torchrun (RANK, WORLD_SIZE, MASTER_ADDR)")
        batch, spec = (int(x) for x in args.mesh.lower().split("x"))
        mesh = make_mesh(batch=batch, spec=spec, device=device)
    writes = mesh is None or mesh.rank == 0
    spectroscopy = Spectroscopy(
        atmosphere, _parse_grid(args.grid), database,
        lines_backend=args.lines_backend,
        continua_backend=args.continua_backend,
        cross_sections_backend=args.cross_sections_backend, device=device,
        mesh=mesh, sharding_mode=args.sharding_mode)
    if args.streamed:
        spectroscopy.compute_absorption_streamed(args.output)
    else:
        result = spectroscopy.compute_absorption(output_format=args.format)
        if writes:
            result.to_netcdf(args.output)
    if mesh is not None:
        dist.barrier()
        if owns_group:
            dist.destroy_process_group()
    if writes:
        if args.metrics:
            print(json.dumps(metrics.snapshot(), indent=2))
        print(f"wrote {args.output}")
    return 0


def cmd_create_db(args):
    from .database.db import Database
    from .webapi import HitranWebApi
    molecules = "all" if args.molecules is None \
        else args.molecules.split(",")
    Database(args.database).create(HitranWebApi(args.api_key),
                                   molecules=molecules,
                                   cross_section_directory=args.xsec_dir)
    print(f"created {args.database}")
    return 0


def cmd_bench(args):
    from .bench import main as bench_main
    return bench_main([])


# --platform (the JAX command line's) -> torch device; None: refused.
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda", "tpu": None}


def _device_name(parser, args):
    """The torch device that ``--device`` and ``--platform`` name (default
    cuda); exits non-zero for a TPU or when the two disagree."""
    if args.platform is None:
        return args.device or "cuda"
    device = PLATFORMS[args.platform]
    if device is None:
        parser.error("--platform tpu: pylbl_tpu_torch runs on a CUDA card "
                     "(an NVIDIA GPU such as the H100), not a TPU; use "
                     "--platform gpu or cpu")
    if args.device is not None and args.device.split(":")[0] != device:
        parser.error(f"--platform {args.platform} and --device "
                     f"{args.device} disagree")
    return args.device or device


def main(argv=None):
    parser = argparse.ArgumentParser(prog="pylbl_tpu_torch")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions on the host)")
    parser.add_argument("--platform", default=None,
                        choices=sorted(PLATFORMS),
                        help="the JAX command line's platform: cpu is "
                             "--device cpu, gpu or cuda the card; tpu is "
                             "refused")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="environment and backend summary")

    compute = sub.add_parser("compute", help="compute absorption spectra")
    compute.add_argument("--atmosphere", required=True,
                         help="netCDF atmosphere with CF standard names")
    compute.add_argument("--database", required=True)
    compute.add_argument("--grid", required=True,
                         help="lo:hi:resolution in cm-1, e.g. 1:3000:0.1")
    compute.add_argument("--output", required=True)
    compute.add_argument("--format", default="all",
                         choices=["all", "gas", "total"],
                         help="'all' materializes per-gas per-mechanism "
                              "spectra on the HOST (slowest at scale); "
                              "'gas'/'total' reduce on the device and ship "
                              "G x / 3G x less data: prefer these (or "
                              "--streamed) for large grids/batches")
    compute.add_argument("--lines-backend", default="pyLBL")
    compute.add_argument("--continua-backend", default="mt_ckd")
    compute.add_argument("--cross-sections-backend", default="arts_crossfit")
    compute.add_argument("--pack-cache-dir", default=None)
    compute.add_argument("--mesh", default=None,
                         help="shard the lines over a BATCHxSPEC mesh of "
                              "the torchrun ranks, e.g. 2x2")
    compute.add_argument("--sharding-mode", default="balanced",
                         choices=["balanced", "halo", "ring"])
    compute.add_argument("--streamed", action="store_true",
                         help="stream layer blocks to a chunked, "
                              "resumable netCDF (RFMIP-scale outputs)")
    compute.add_argument("--metrics", action="store_true",
                         help="print the metrics snapshot after computing")

    create = sub.add_parser("create-db", help="build the spectral database "
                            "from HITRAN/TIPS (network)")
    create.add_argument("--database", required=True)
    create.add_argument("--api-key", required=True)
    create.add_argument("--molecules", default=None,
                        help="comma-separated formulae (default: all)")
    create.add_argument("--xsec-dir", default=".cross-sections")

    sub.add_parser("bench", help="benchmark the kernels on the CUDA card "
                   "(pylbl_tpu_torch/bench.py; no CPU fallback)")

    args = parser.parse_args(argv)
    name = _device_name(parser, args)
    if args.command == "create-db":
        return cmd_create_db(args)
    if args.command == "bench":
        if name != "cuda":
            parser.error("bench runs on the CUDA card only")
        return cmd_bench(args)
    from .runtime.device import resolve_device
    try:
        args.device = resolve_device(name)
    except RuntimeError as exc:
        parser.error(str(exc))
    return {"info": cmd_info, "compute": cmd_compute}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
