"""Readings that the limits of `correct` are set from, for one cell, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --controls 3 [--first-seed n]
                                   [--fault unchanged|half_batch|altered]

For each of `--seeds` seeds the program is set up and driven as a run does
(through a short window of one unit) and compared with the reference; for
each of `--controls` seeds the control (the reference in the precision
below the configuration's, in the program's place) is compared with it.
With `--fault` the program runs with that fault planted
(`faults.py`), which gives a fault's readings. Prints one JSON line a
seed and, last, the largest program reading and the smallest control
reading of every number beside the configuration's limit.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import devtrace  # noqa: E402
import faults  # noqa: E402
import run as harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--fault", choices=faults.FAULTS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    _, cell, config, traffic, driver = harness.load_cell(args.workload)
    program, control = [], []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        with (faults.plant(config["driver"], args.fault) if args.fault
              else contextlib.nullcontext()):
            run = driver.prepare(config, traffic, seed, "cuda")
            driver.measure(run, 0.0, devtrace.Tracer(False, 0, 0))
            kept = driver.release(run)
        numbers = driver.compare(config, seed, "cuda", kept)
        del kept, run
        torch.cuda.empty_cache()
        program.append(numbers)
        print(json.dumps({"side": args.fault or "program", "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for i in range(args.controls):
        seed = args.first_seed + 104729 * (i + 1)
        t0 = time.perf_counter()
        numbers = driver.control(config, traffic, seed, "cuda")
        torch.cuda.empty_cache()
        control.append(numbers)
        print(json.dumps({"side": "control", "seed": seed, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    summary = {k: {"program_max": max((p[k] for p in program), default=None),
                   "control_min": min((c[k] for c in control), default=None),
                   "limit": config["limits"][k]} for k in config["limits"]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
