"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names; the plain reference imports nothing of the
program either."""
import os
import subprocess
import sys

import run as bench_run
from conftest import BENCH, ROOT

CHILD = r"""
import sys
sys.path[:0] = [{root!r}, {bench!r}]
{body}
bad = sorted({{m.split(".")[0] for m in sys.modules}} & set({names!r}))
print("LOADED", bad)
"""


def _loaded(body, names):
    src = CHILD.format(root=ROOT, bench=BENCH, body=body, names=names)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("LOADED")][-1]
    return line


def test_forbidden_names_compare_whole_top_level_names():
    ok = ["gpismap_tpu_torch", "gpismap_tpu_torch.ops.gp", "jaxtyping",
          "flaxen.x", "numpy"]
    assert bench_run.forbidden_modules(ok) == []
    for name, top in (("jax.numpy", "jax"), ("jaxlib", "jaxlib"),
                      ("flax.linen", "flax"),
                      ("gpismap_tpu.ops.gp", "gpismap_tpu"),
                      ("gpismap_tpu", "gpismap_tpu")):
        assert bench_run.forbidden_modules(ok + [name]) == [top]


def test_a_run_loads_no_jax_nor_the_jax_package(tmp_path):
    body = f"""
sys.path.insert(0, {os.path.join(BENCH, "tests")!r})
import conftest
b = conftest.scratch_copy({str(tmp_path)!r})
run, out = conftest.cpu_run({str(tmp_path)!r}, b, "room2d.stream")
assert out["correct"], out
"""
    assert _loaded(body, ["jax", "jaxlib", "flax", "gpismap_tpu"]) == \
        "LOADED []"


def test_the_reference_imports_nothing_of_the_program():
    body = ("import harness.reference, harness.work, harness.truth, "
            "harness.scenes, harness.trace")
    assert _loaded(body, ["jax", "jaxlib", "flax", "gpismap_tpu",
                          "gpismap_tpu_torch"]) == "LOADED []"
