"""The readers of the program's stage spans and factor counters, on a
hand-built context: each returns the number worked out by hand, and None
where its spans or counters are missing."""
import sys
from types import SimpleNamespace

import pytest

from harness import cell

PEAKS = {"NVIDIA H100": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}}
MS = 1e6                                    # nanoseconds in a millisecond


class FakeTrace:
    """Host events and device operations [(name, start ns, end ns)]."""

    def __init__(self, host, dev=()):
        self.host, self.dev = list(host), list(dev)

    def device_time(self, match):
        return sum(e - s for n, s, e in self.dev if match(n)) / 1e9


def _ctx(loop, host, dev=(), items=4):
    return SimpleNamespace(mix={"loop": loop}, trace=FakeTrace(host, dev),
                           traced_items=items, peaks=PEAKS,
                           device_kind="NVIDIA H100 80GB HBM3")


def _ev(name, start_ms, length_ms):
    return (name, start_ms * MS, (start_ms + length_ms) * MS)


# a traced stream episode of 4 frames: every stage span once or twice,
# beside the harness's own spans and host ops the readers must not take
STREAM = [_ev("bench.update", 0, 100), _ev("aten::to", 1, 2)] + [
    _ev("gpismap." + n, i * 10, ms) for i, (n, ms) in enumerate([
        ("update.prep", 1.0), ("update.cull", 2.0), ("update.frame", 8.0),
        ("update.reeval", 4.0), ("update.replay", 3.0),
        ("update.replay", 1.0), ("retrain.collect", 5.0),
        ("retrain.mirror", 0.5), ("retrain.fit", 6.0),
        ("retrain.grid", 2.0), ("retrain.refresh", 1.5),
        ("test.factors", 7.0), ("test.candidates", 3.0)])]
QUERY = [_ev("bench.test", 0, 50)] + [
    _ev("gpismap." + n, i * 5, ms) for i, (n, ms) in enumerate([
        ("test.factors", 0.2), ("test.candidates", 1.0), ("test.plan", 2.0),
        ("test.eval", 4.0), ("test.blend", 1.0), ("test.readback", 6.0)])]


@pytest.mark.parametrize("name, loop, host, want", [
    ("index_ms.stream", "stream", STREAM, (2 + 3 + 1 + 5 + 2) / 4),
    ("frame_ms.stream", "stream", STREAM, (8 + 4) / 4),
    ("retrain_ms.stream", "stream", STREAM, (0.5 + 6 + 1.5) / 4),
    ("fill_ms.stream", "stream", STREAM, 7 / 4),
    ("launch_ms.query", "query", QUERY, (1 + 2 + 4 + 1) / 4),
])
def test_stage_reader_sums_its_spans_per_item(name, loop, host, want):
    read = cell.reader(name)
    assert read(_ctx(loop, host)) == pytest.approx(want, rel=1e-12)
    # a program without the spans, another loop, no trace: nothing
    bare = [e for e in host if not e[0].startswith("gpismap.")]
    assert read(_ctx(loop, bare)) is None
    other = "query" if loop == "stream" else "stream"
    assert read(_ctx(other, host)) is None
    assert read(SimpleNamespace(mix={"loop": loop}, trace=None,
                                traced_items=4)) is None


DEV = [("_anonymous_namespace_::chol_panel_kernel_float", 0, 3 * MS),
       ("_anonymous_namespace_::linv_diag_kernel_float", 5 * MS, 6 * MS),
       ("void_tile_eval_kernel_3", 6 * MS, 40 * MS)]


def test_factor_roofline_from_the_counters(monkeypatch):
    from gpismap_tpu_torch.runtime import spans
    read = cell.reader("factor_roofline.stream")
    # two cells of 1280 rows factored and inverted: operations bound
    n3, n2 = 2 * 1280 ** 3, 2 * 1280 ** 2
    counts = {"chol.rows2": n2, "chol.rows3": n3,
              "linv.rows2": n2, "linv.rows3": n3}
    monkeypatch.setattr(spans, "counts", lambda: dict(counts))
    ops_s = 2 * n3 / 3 / 67e12
    assert ops_s > 8 * 2 * n2 / 3.35e12
    want = 100 * ops_s / 4e-3               # chol 3 ms + linv 1 ms
    assert read(_ctx("stream", STREAM, DEV)) == pytest.approx(want)
    # small cells: the bytes bound
    counts.update({"chol.rows2": 96 ** 2, "chol.rows3": 96 ** 3,
                   "linv.rows2": 0, "linv.rows3": 0})
    want = 100 * (8 * 96 ** 2 / 3.35e12) / 4e-3
    assert read(_ctx("stream", STREAM, DEV)) == pytest.approx(want)
    # no factor kernel in the trace, no peak for the card, another loop
    assert read(_ctx("stream", STREAM, DEV[2:])) is None
    assert read(SimpleNamespace(**dict(vars(_ctx("stream", STREAM, DEV)),
                                       device_kind="cpu"))) is None
    assert read(_ctx("query", STREAM, DEV)) is None
    # no counters: a profile the program did not count, or a program
    # without the counters at all
    monkeypatch.setattr(spans, "counts", dict)
    assert read(_ctx("stream", STREAM, DEV)) is None
    monkeypatch.setitem(sys.modules, "gpismap_tpu_torch.runtime.spans", None)
    monkeypatch.delattr(sys.modules["gpismap_tpu_torch.runtime"], "spans")
    assert read(_ctx("stream", STREAM, DEV)) is None
