#!/usr/bin/env python3
"""The control of `correct`: the reference put in the program's place with
one guarantee broken (reference.control_results: Lagrange coefficients
cut to 64 bits), at a cell's own size, on each seed given. Each seed
prints one JSON line with the compared numbers, which must fail their
limits; the benchmark's own runs never run this.

    python3 portbench/control.py --workload att1k.burst --seeds 11,12,13 [--slots 1]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import gen, reference, spec  # noqa: E402


def control(cfg: dict, traffic: dict, seed: int, slots: int, workers: int | None = None) -> dict:
    """The compared numbers of the control over the first `slots` slots a
    run of `seed` would time, summed, with attempted and failed."""
    traffic = {**traffic, "untimed_slots": 0, "ring_slots": slots}
    inputs = gen.generate(cfg, traffic, seed, workers)
    exps = reference.expected(inputs, list(range(slots)), cfg, workers)
    total = {"counts": dict.fromkeys(reference.LIMITS, 0), "attempted": 0, "failed": 0}
    for s, exp in enumerate(exps):
        subs = gen.submissions(inputs, inputs.slots[s], cfg, traffic, seed, s)
        got = reference.compare(subs, reference.control_results(subs, exp, workers), exp)
        total["attempted"] += got["attempted"]
        total["failed"] += got["failed"]
        for k, v in got["counts"].items():
            total["counts"][k] += v
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--slots", type=int, default=1)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg, traffic = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = control(cfg, traffic, seed, args.slots)
        beyond = {k: v > reference.LIMITS[k] for k, v in got["counts"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed, **got, "beyond_limit": beyond,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
