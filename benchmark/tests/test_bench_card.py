"""No card, no run: the benchmark exits non-zero and prints no result
without a CUDA device; with one it fails the bf16 control (the program's
own lower-precision path of the tile kernel), which the checks must
catch."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def _run(cwd, workload, env_extra=None, seconds="1"):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", seconds, "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=1200)


def test_refuses_without_a_card():
    p = _run(ROOT, "bigbird3d.query", {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(str(tmp_path), "bigbird3d.query")
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bigbird3d.query", "bigbird3d.stream",
                                      "gazebo2d.stream", "gazebo2d.query"])
def test_bf16_control_is_not_correct(card, workload):
    p = _run(ROOT, workload, {"GPISMAP_PALLAS_BF16": "1"}, seconds="3")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out["checks"]
