"""Readings behind the limits of the output checks (``limits/<cell>.json``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3 --out calibration.jsonl

In one process, to spare the set-up of a process a seed: the program's
checked numbers from a short window on each of ``--seeds`` (the lower
reading is their largest), and the same numbers with the control, the
reference one precision step below the configuration's, in the program's
place, after the same short window, on each of ``--control-seeds`` (the
upper reading is their smallest). ``--fault`` plants one of ``faults.py``'s faults under the
program's seeds instead. One JSON line a run, to standard output and to
``--out``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from portbench.faults import FAULTS  # noqa: E402
from portbench.harness import Run, make_entry, window  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None,
                   help="plant this fault under the program's seeds (portbench/faults.py)")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        for seed in seeds:
            with FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
                entry = make_entry(args.workload, seed)
                run = Run(cell=args.workload, seconds=args.seconds, entry=entry)
                window(run, time.perf_counter(), False, "cuda")
                checks, _ = entry.check()
            line = {"cell": args.workload, "seed": seed, "side": args.fault or "program",
                    "checks": {c["name"]: c["value"] for c in checks},
                    "readings": getattr(entry, "readings", {}),
                    "steps": run.steps, "window_s": run.window_s}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            del entry, run
            torch.cuda.empty_cache()
        for seed in controls:
            entry = make_entry(args.workload, seed)
            run = Run(cell=args.workload, seconds=args.seconds, entry=entry)
            window(run, time.perf_counter(), False, "cuda")
            checks = entry.control()
            line = {"cell": args.workload, "seed": seed, "side": "control",
                    "checks": {c["name"]: c["value"] for c in checks},
                    "readings": getattr(entry, "readings", {})}
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            del entry
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
