"""The run's check, driven on the CPU at the tests' tiny sizes with the
timed path broken underneath (faults.py), comes out not correct: each
fault the cells can have fails the number named beside it."""
import pytest

import faults
from conftest import cpu_run, scratch_copy

SEED = 2 ** 31 + 4242
CASES = [
    ("unchanged", "room2d.stream", "uncovered_share"),
    ("unchanged", "tiny3d.stream", "uncovered_share"),
    ("unchanged", "room2d.query", "uncovered_share"),
    ("half_queries", "room2d.query", "f"),
    ("half_queries", "tiny3d.stream", "f"),
    ("one_answer", "room2d.stream", "f"),
    ("one_answer", "tiny3d.query", "f"),
    ("new_normals", "room2d.stream", "new_grad"),
    ("new_normals", "tiny3d.stream", "new_grad"),
    ("new_noise", "room2d.stream", "new_noise"),
    ("new_noise", "tiny3d.stream", "new_noise"),
    ("new_noise_late", "room2d.stream", "new_noise_p95"),
    ("new_noise_late", "tiny3d.stream", "new_noise_p95"),
    ("new_ungated", "tiny3d.stream", "new_spurious"),
    ("new_shifted", "room2d.stream", "off_surface_m"),
    ("new_shifted", "tiny3d.query", "off_surface_m"),
    ("new_shifted", "room2d.stream", "new_unmatched"),
    ("reeval_skipped", "room2d.stream", "reeval_wrong"),
    ("reeval_skipped", "tiny3d.stream", "reeval_wrong"),
    ("reeval_shifted", "room2d.stream", "new_unmatched"),
    ("reeval_shifted", "tiny3d.stream", "new_unmatched"),
]


# a fault of the late frames needs episodes that have them
FRAMES = {"new_noise_late": 12}


def _run(tmp_path, workload, frames=None):
    """A run long enough for every frame of the check's pairs: the
    re-evaluation shows only in a frame that finds a map (a stream's
    later frames)."""
    bench = scratch_copy(tmp_path, frames=frames)
    stream = workload.endswith(".stream")
    seconds = (8.0 if frames is None else 16.0) if stream else 2.0
    run, out = cpu_run(tmp_path, bench, workload, SEED, seconds=seconds)
    if stream:
        assert len(run.captures) == len(run.pairs), \
            "the window ended before the check's last pair"
    return out


def _failed(out):
    return {k for k, (v, lim) in out["checks"].items()
            if v is None or not v <= lim}


@pytest.mark.parametrize("workload", sorted({c[1] for c in CASES}))
def test_sound_runs_are_correct(tmp_path, workload):
    out = _run(tmp_path, workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault,workload,number", CASES)
def test_fault_is_not_correct(tmp_path, fault, workload, number):
    with faults.plant(fault):
        out = _run(tmp_path, workload, FRAMES.get(fault))
    assert not out["correct"]
    assert number in _failed(out), out["checks"]
