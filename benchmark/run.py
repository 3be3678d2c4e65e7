#!/usr/bin/env python3
"""The benchmark of gpismap_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

runs the cell <name> of BENCHMARK.json once, in this process, from the
root of a checkout: builds the program's kernels (into the checkout),
makes the cell's inputs from the seed, warms up, drives the program's
mapper through update() and test() for <s> seconds (with --trace 1 then
one traced stretch under torch.profiler), checks what the timed calls
returned against the plain reference, and prints one JSON line last on
standard output. It needs a CUDA device and exits non-zero without one,
printing no result.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


_T0 = time.perf_counter()
_AGE0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpismap_tpu")


def forbidden_modules(names=None) -> list:
    """The top-level names (before the first dot), compared whole, of the
    modules in `names` (default: those loaded) that are in FORBIDDEN."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if a.workload not in chips:
        print(f"benchmark: no cell {a.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    chips = chips[a.workload]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: no CUDA device, or fewer than the {chips} the "
              "cell asks for; this benchmark runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    from harness import cell
    run = cell.Run(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                   "cuda:0", lambda: _AGE0 + time.perf_counter() - _T0)
    out = run.run()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {bad}, which nothing the "
              "benchmark runs may import", file=sys.stderr)
        return 3
    for k, v in out.get("checked", {}).items():
        print(f"checked {k}: {v!r}", file=sys.stderr)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
