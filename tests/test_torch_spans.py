"""The mappers' stage spans and factor counters (runtime/spans.py): live
only while a torch.profiler records, flat, counting each fitted or
factored cell's true support, and inert: a profiled run maps and answers
bitwise as an unprofiled one. Tiny 2D and 3D scenes on the CPU, those of
tests/test_torch_slice.py and tests/test_torch_slice3d.py."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gpismap_tpu_torch import (CameraParam, CapacityParam, GPisMap2D,  # noqa: E402,E501
                               GPisMap3D)
from gpismap_tpu_torch.runtime import spans  # noqa: E402

TINY = {2: dict(gp_support=16, retrain_batch=8, max_cells=64, max_nodes=512,
                test_tile=16, test_active_cells=16, max_beams=64),
        3: dict(gp_support=32, retrain_batch=8, max_cells=256,
                max_nodes=4096, test_tile=16, test_active_cells=128,
                max_beams=64)}
CAM = dict(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64, height=48)
# the spans of the default paths (3D adds its re-evaluation)
SPANS = {"update.prep", "update.cull", "update.frame", "update.replay",
         "retrain.collect", "retrain.mirror", "retrain.fit", "retrain.grid",
         "retrain.refresh", "test.factors", "test.candidates", "test.plan",
         "test.eval", "test.blend", "test.readback"}
EXPECTED = {2: SPANS, 3: SPANS | {"update.reeval"}}


def _mapper(dim):
    if dim == 2:
        return GPisMap2D(cap=CapacityParam(**TINY[2]), device="cpu")
    return GPisMap3D(cap=CapacityParam(**TINY[3]), camera=CameraParam(**CAM),
                     device="cpu")


def _frames(dim):
    if dim == 2:
        return torch_scenes.room_frames(3, 181)
    return torch_scenes.object_frames(3, CameraParam(**CAM))


def _queries(dim, n=300):
    rng = np.random.default_rng(5)
    if dim == 2:
        return rng.uniform([-2.6, -2.2], [2.6, 2.3], (n, 2)).astype(
            np.float32)
    return np.stack([rng.uniform(*torch_scenes.VOLUME_X, n),
                     rng.uniform(*torch_scenes.VOLUME_Y, n),
                     rng.uniform(*torch_scenes.VOLUME_Z, n)],
                    -1).astype(np.float32)


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _stage_events(prof):
    """The profile's stage spans: [(name, start us, end us)] by start."""
    ev = [(e.name[len(spans.PREFIX):], e.time_range.start, e.time_range.end)
          for e in prof.events() if e.name.startswith(spans.PREFIX)]
    return sorted(ev, key=lambda x: x[1])


def test_off_without_a_profiler():
    spans.reset()
    assert not spans.on()
    m = _mapper(2)
    m.update(*_frames(2)[0])
    m.test(_queries(2))
    assert spans.counts() == {}
    assert "update_s" not in m.stats and "retrain_s" not in m.stats


@pytest.mark.parametrize("dim", [2, 3])
def test_default_path_emits_every_stage_span_flat(dim):
    frames, q = _frames(dim), _queries(dim)
    m = _mapper(dim)
    m.update(*frames[0])
    with _profiler() as prof:
        assert spans.on()
        for f in frames[1:]:
            m.update(*f)
            m.test(q)
    ev = _stage_events(prof)
    assert {n for n, _, _ in ev} == EXPECTED[dim]
    # flat: no span starts before the one before it has ended
    for (n0, _, e0), (n1, s1, _) in zip(ev, ev[1:]):
        assert s1 >= e0, (n0, n1)


@pytest.mark.parametrize("dim", [2, 3])
def test_chol_counts_the_fits_true_support(dim):
    frames = _frames(dim)
    m = _mapper(dim)
    m.update(*frames[0])
    seen = []
    collect = m.index.collect_retrain

    def spy(*args):
        seen.append(collect(*args))
        return seen[-1]

    m.index.collect_retrain = spy
    spans.reset()
    with _profiler():
        m.update(*frames[1])
    c = spans.counts()
    n = (1 + dim) * seen[0]["counts"][:seen[0]["n"]].astype(np.int64)
    assert len(n) > 0
    assert c["chol.rows2"] == int(np.sum(n ** 2))
    assert c["chol.rows3"] == int(np.sum(n ** 3))
    # the cache fill factors every live cell at its support in the store;
    # the padding rows of its slots count nothing
    live = m._live_slots()
    assert 0 < len(live) < m.cap.test_active_cells
    spans.reset()
    with _profiler():
        m.test(_queries(dim))
    c = spans.counts()
    n = (1 + dim) * m.store.valid[torch.as_tensor(live).long()].sum(
        -1).numpy().astype(np.int64)
    assert set(c) == {f"{k}.rows{p}" for k in ("chol", "linv")
                      for p in (2, 3)}
    for kind in ("chol", "linv"):
        assert c[f"{kind}.rows2"] == int(np.sum(n ** 2))
        assert c[f"{kind}.rows3"] == int(np.sum(n ** 3))
    # a retrain refreshes the filled cache: linv of each fitted cell, at
    # its new support (the same frame again keeps the live slot set)
    spans.reset()
    seen.clear()
    with _profiler():
        m.update(*frames[1])
    c = spans.counts()
    assert np.array_equal(m._live_slots(), live)
    rt = seen[0]
    fitted = rt["slots"][:rt["n"]] >= 0
    n = (1 + dim) * rt["counts"][:rt["n"]][fitted].astype(np.int64)
    assert c["linv.rows2"] == int(np.sum(n ** 2))
    assert c["linv.rows3"] == int(np.sum(n ** 3))
    spans.reset()


@pytest.mark.parametrize("dim", [2, 3])
def test_spans_leave_the_map_and_answers_bitwise(dim):
    frames, q = _frames(dim), _queries(dim)

    def run(profiled):
        m = _mapper(dim)
        outs = []
        with _profiler() if profiled else contextlib.nullcontext():
            for f in frames:
                m.update(*f)
                outs.append(m.test(q))
        return m.state_digest(), outs

    plain, traced = run(False), run(True)
    spans.reset()
    assert plain[0] == traced[0]
    for a, b in zip(plain[1], traced[1]):
        assert a.tobytes() == b.tobytes()
