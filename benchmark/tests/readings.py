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
process for many seeds saves each run's start-up. A stream's check reads
the same frames in any window that finishes the check's pairs, so a
window of a few episodes gives the numbers of a full-length run.

A stream's line also gives each checked frame's own 95th percentiles
(`frames`: the statistic before the pool). With --look, every frame
whose own percentile crosses the cell's limit is read again with the
reference's candidates computed in float32 (compared in float64 all the
same): the largest gaps of its square-view nodes, each against float64
and against float32 candidates. Gaps that collapse there are the
reference's float32 rounding, not the program's fault.
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


def f32_look(run, top=5) -> list:
    """For each checked frame whose own 95th percentile of a gap crosses
    the limit of the pooled one: its `top` largest square-view gaps of
    that kind, each as (row of the map after the frame, gap against the
    reference's float64 candidates, gap against them in float32), and
    the frame's percentile both ways."""
    import torch
    # the reference module the run's own scene calls
    update_ref = type(run.scene).candidates.__globals__["update_ref"]
    at = {(c["episode"], c["frame"]): c for c in run.captures}
    out = []
    for pair, fr in zip(run.checked_pairs, run.frames):
        over = [k for k in ("grad", "noise")
                if fr[f"new_{k}_p95_frame"] > run.limits[f"new_{k}_p95"]]
        if not over:
            continue
        cap = at[pair]
        real = update_ref.F64
        update_ref.F64 = torch.float32
        try:
            cand = run.scene.candidates(cap)
        finally:
            update_ref.F64 = real
        cand = {k: v.double() if torch.is_tensor(v)
                and v.is_floating_point() else v for k, v in cand.items()}
        f32 = run.scene.frame_numbers(cap, cand)
        for k in over:
            sq, sq32 = fr["square"], f32["square"]
            by_row = dict(zip(sq32["rows"].tolist(), sq32[k].tolist()))
            worst = sq[k].argsort()[::-1][:top]
            out.append(dict(
                pair=list(pair), gap=k,
                p95_frame=[fr[f"new_{k}_p95_frame"],
                           f32[f"new_{k}_p95_frame"]],
                nodes=[[int(sq["rows"][i]), float(sq[k][i]),
                        by_row.get(int(sq["rows"][i]))] for i in worst]))
    return out


def _frames(run) -> list:
    return [dict(pair=list(p), square=len(f["square"]["noise"]),
                 grad_p95=f["new_grad_p95_frame"],
                 noise_p95=f["new_noise_p95_frame"],
                 grad_max=f["new_grad_max"], noise_max=f["new_noise_max"])
            for p, f in zip(run.checked_pairs, run.frames)]


def readings(workload, seeds, seconds=2.0, control=False, fault=None,
             device="cuda:0", look=False):
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
            line = dict(workload=workload, seed=s, control=control,
                        fault=fault, correct=res["correct"],
                        numbers=run.checks, attempted=res["attempted"],
                        checked=run.checked, check_s=run.check_s,
                        seconds=time.perf_counter() - t0)
            if "checked" in res:
                line.update(res["checked"], captured=len(run.captures),
                            frames=_frames(run))
                if look:
                    line["look"] = f32_look(run)
            out.append(line)
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
    ap.add_argument("--look", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    for fault in a.fault:
        readings(a.workload, a.seeds, a.seconds, a.control, fault,
                 look=a.look)
    return 0


if __name__ == "__main__":
    sys.exit(main())
