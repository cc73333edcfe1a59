"""The readings the limits of ``lblbench/limits/<cell>.json`` are set from,
in one process: the program's compared numbers over many seeds, and the
control's (``harness/control.py``, in the program's place) over others,
each a run of the cell with a short window at the cell's own load.

    python3 lblbench/calibrate.py --workload NAME --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2 [--floors 1e-3,1e-2]

One JSON line a seed (with ``checked``, the calls it compared), then one
with the largest program reading of each number and the smallest control
reading; it exits 1 where a control run comes out correct.  With
``--floors``, each line also gives ``rel_err@<phi>``, the run's
``rel_err`` with each of those ``rel_err_floor`` values in the cell's.
Needs the cell's CUDA cards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lblbench.harness import control, inputs, main, spec  # noqa: E402


def calibrate(argv):
    parser = argparse.ArgumentParser(prog="lblbench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--floors", default="")
    args = parser.parse_args(argv)
    floors = [float(f) for f in args.floors.split(",") if f]
    main.set_caches(main.ROOT)
    import torch
    cell = spec.cell(main.ROOT, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print("calibrate: needs the cell's CUDA cards", file=sys.stderr)
        return 3
    readings = {"program": {}, "control": {}}
    control_correct = False
    for kind, seeds, factory in (
            ("program", args.seeds, main.System),
            ("control", args.control_seeds, control.Control)):
        for seed in map(int, seeds.split(",")):
            by_floor = {}

            def check(got, ref, limits):
                for phi in floors:
                    checks, _ = main.judge(got, ref,
                                           dict(limits, rel_err_floor=phi))
                    by_floor[f"rel_err@{phi!r}"] = checks["rel_err"]["value"]
                return main.judge(got, ref, limits)

            result = main.run_cell(main.ROOT, cell, seed, args.seconds,
                                   False, "cuda", time.perf_counter(),
                                   factory, check)
            values = {k: v["value"] for k, v in result["checks"].items()}
            values.update(by_floor)
            for k, v in values.items():
                readings[kind].setdefault(k, []).append(v)
            control_correct |= kind == "control" and result["correct"]
            print(json.dumps({"seed": seed, "kind": kind,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "checked": min(result["attempted"],
                                             inputs.CHECKED_CALLS),
                              "failed": result["failed"], **values}),
                  flush=True)
    highest = {k: max(v) for k, v in readings["program"].items()}
    lowest = {k: min(v) for k, v in readings["control"].items()}
    print(json.dumps({"workload": args.workload, "program_highest": highest,
                      "control_lowest": lowest,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if control_correct else 0


if __name__ == "__main__":
    sys.exit(calibrate(sys.argv[1:]))
