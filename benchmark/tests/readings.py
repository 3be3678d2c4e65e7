#!/usr/bin/env python3
"""Readings that set the limits of the check (needs a CUDA device).

    python3 benchmark/tests/readings.py --workload <name> --seeds 1 2 ...
        [--control] [--fault <fault> ...] [--seconds 2]

runs the cell in this process once per seed, each a whole run of the
harness (its own scene, mapper, warm-up, window and check), and prints one
JSON line per run with every number the check computes: sound runs give
the lower readings; --control runs them with the program's bf16 variance
path on (GPISMAP_PALLAS_BF16=1, the program's own lower-precision path);
--fault plants one of faults.FAULTS (each of several in turn). One
process for many seeds saves each run's start-up.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [ROOT, BENCH, HERE]


def readings(workload, seeds, seconds=2.0, control=False, fault=None,
             device="cuda:0"):
    import faults
    from harness import cell
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out = []
    old = os.environ.get("GPISMAP_PALLAS_BF16")
    if control:
        os.environ["GPISMAP_PALLAS_BF16"] = "1"
    try:
        for s in seeds:
            t0 = time.perf_counter()
            run = cell.Run(bench, workload, s, seconds, False, device,
                           lambda: time.perf_counter() - t0)
            if fault:
                with faults.plant(fault):
                    res = run.run()
            else:
                res = run.run()
            out.append(dict(workload=workload, seed=s, control=control,
                            fault=fault, correct=res["correct"],
                            numbers=run.checks, attempted=res["attempted"],
                            checked=run.checked,
                            seconds=time.perf_counter() - t0))
            print(json.dumps(out[-1]), flush=True)
    finally:
        if old is None:
            os.environ.pop("GPISMAP_PALLAS_BF16", None)
        else:
            os.environ["GPISMAP_PALLAS_BF16"] = old
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", nargs="*", default=[None])
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    for fault in a.fault:
        readings(a.workload, a.seeds, a.seconds, a.control, fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
