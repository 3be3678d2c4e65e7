"""Shared helpers of the benchmark's own tests (CPU unless marked cuda)."""
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA (skips elsewhere)")
    # the CPU runs are small: a few threads each keep parallel workers
    # from crowding one another out of their windows
    import torch
    torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture
def card():
    """Skips the test at run time where there is no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


# The tiny scenes' pool of square-view new nodes, in place of the stream
# mix's tail_pool: the room's 181 beams add some 30 over the four pairs
# its 3 frames list (the 3D object some 250 over three).
TAIL_POOL = 24


def scratch_copy(dst, tiny=("room2d", "tiny3d"), frames=None):
    """A copy of the benchmark (BENCHMARK.json and the folder) under dst,
    with the tiny CPU configurations added as files and entries: each
    under both mixes, held to the limits of its full-size configuration's
    cell of that mix (of its stream cell where it has none), with
    `frames` frames an episode where given; the stream mix's pool is
    TAIL_POOL. Returns the loaded BENCHMARK.json of the copy."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    mix_file = os.path.join(dst, "benchmark", "traffic", "stream.json")
    with open(mix_file) as f:
        mix = json.load(f)
    with open(mix_file, "w") as f:
        json.dump(dict(mix, tail_pool=TAIL_POOL), f)
    full = {"room2d": "gazebo2d", "tiny3d": "bigbird3d"}
    for c in tiny:
        with open(os.path.join(DATA, f"{c}.json")) as f:
            cfg = json.load(f)
        if frames is not None:
            cfg["scene"]["frames"] = frames
        with open(os.path.join(dst, "benchmark", "configs", f"{c}.json"),
                  "w") as f:
            json.dump(cfg, f)
        b["configs"].append({"name": c, "source": "the tests' tiny scene",
                             "file": f"benchmark/configs/{c}.json",
                             "reduced": [], "why": "CPU tests"})
        for t in ("stream", "query"):
            w = f"{c}.{t}"
            b["workloads"].append({"name": w, "config": c, "traffic": t,
                                   "chips": 1, "why": "CPU tests"})
            lim = os.path.join(BENCH, "limits", f"{full[c]}.{t}.json")
            if not os.path.exists(lim):     # a mix the configuration lacks
                lim = os.path.join(BENCH, "limits", f"{full[c]}.stream.json")
            shutil.copy(lim, os.path.join(dst, "benchmark", "limits",
                                          f"{w}.json"))
            for m in b["end_to_end"] + b["per_layer"]:
                if any(x.endswith(f".{t}") for x in m.get("workloads", [])):
                    m["workloads"].append(w)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return b


def cpu_run(dst, bench, workload, seed=2 ** 31 + 7, seconds=2.0,
            traced=False):
    """One run of a workload of the copy at dst on the CPU (the harness
    below its look for a card)."""
    import importlib
    import time
    sys.path.insert(0, os.path.join(dst, "benchmark"))
    try:
        for m in [m for m in sys.modules if m.split(".")[0] == "harness"]:
            del sys.modules[m]
        cell = importlib.import_module("harness.cell")
        t0 = time.perf_counter()
        run = cell.Run(bench, workload, seed, seconds, traced, "cpu",
                       lambda: time.perf_counter() - t0)
        return run, run.run()
    finally:
        sys.path.remove(os.path.join(dst, "benchmark"))
        for m in [m for m in sys.modules if m.split(".")[0] == "harness"]:
            del sys.modules[m]
