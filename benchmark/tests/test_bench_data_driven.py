"""A configuration, a traffic mix and a metric join the benchmark as
files and entries alone: no file already there is edited."""
import hashlib
import json
import os

from conftest import cpu_run, scratch_copy


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_by_name(tmp_path):
    bench = scratch_copy(tmp_path, tiny=())
    before = _digests(tmp_path / "benchmark")
    b = str(tmp_path / "benchmark")
    # a configuration: the tiny room as a file of its own
    with open(os.path.join(os.path.dirname(__file__), "data",
                           "room2d.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(b, "configs", "room2d.json"), "w") as f:
        json.dump(cfg, f)
    # a traffic mix: the stream with one of its pairs' test() calls
    # checked
    with open(os.path.join(b, "traffic", "stream.json")) as f:
        mix = json.load(f)
    mix.update(checks=1)
    with open(os.path.join(b, "traffic", "sparse_stream.json"), "w") as f:
        json.dump(mix, f)
    # a metric: its reader
    with open(os.path.join(b, "metrics", "test_calls.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx.spans['test'])\n")
    with open(os.path.join(b, "limits", "gazebo2d.stream.json")) as f:
        lim = f.read()
    with open(os.path.join(b, "limits", "room2d.sparse_stream.json"),
              "w") as f:
        f.write(lim)
    w = "room2d.sparse_stream"
    bench["configs"].append({"name": "room2d", "source": "tests",
                             "file": "benchmark/configs/room2d.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": w, "config": "room2d",
                               "traffic": "sparse_stream", "chips": 1,
                               "why": "tests"})
    bench["end_to_end"].append({"name": "test_calls", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [w]})
    for m in bench["end_to_end"]:
        if m.get("workloads") and "gazebo2d.stream" in m["workloads"]:
            m["workloads"].append(w)
    run, out = cpu_run(tmp_path, bench, w)
    assert out["correct"], out["checks"]
    assert out["metrics"]["test_calls"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"frames_per_s", "frame_p95_ms",
                                   "setup_s", "test_calls"}
    assert run.checked == 1
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
