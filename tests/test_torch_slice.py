"""The whole 2D slice: gpismap_tpu.api.GPisMap2D vs the PyTorch port's
GPisMap2D over the same synthetic scans, at tiny capacities, on the CPU.

Queries are random points: on exact lattice points two cluster cells can
be equidistant, and then the nearest-cell choice follows the last bit of
the distance computation (jitted and eager JAX already differ there).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper  # noqa: E402
from gpismap_tpu.config import CapacityParam as JaxCapacity  # noqa: E402
from gpismap_tpu_torch import CapacityParam, GPisMap2D  # noqa: E402
from gpismap_tpu_torch.convert import state_from_numpy  # noqa: E402

# the tiny capacities of tests/test_pallas.py:85-87
TINY = dict(gp_support=16, retrain_batch=8, max_cells=64, max_nodes=512,
            test_tile=16, test_active_cells=16, max_beams=64)
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _queries(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform([-2.6, -2.2], [2.6, 2.3], (n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def mappers():
    """Both mappers after the same 3 frames of the synthetic room."""
    mj = JaxMapper(cap=JaxCapacity(**TINY))
    mt = GPisMap2D(cap=CapacityParam(**TINY), device="cpu")
    for frame in torch_scenes.room_frames(3, 181):
        mj.update(*frame)
        mt.update(*frame)
    return mj, mt


def _sorted_points(m):
    p = m.get_all_points()
    return p[np.lexsort(p.T[::-1])]


def test_slice_nodes_match_jax(mappers):
    mj, mt = mappers
    assert mt.num_nodes == mj.num_nodes > 0
    np.testing.assert_allclose(_sorted_points(mt), _sorted_points(mj),
                               rtol=0, atol=1e-5)
    for key in ("n_nodes", "n_cluster_cells", "new_inserted",
                "support_overflow", "n_valid_beams", "frame"):
        assert mt.stats[key] == mj.stats[key], key


def test_slice_store_matches_jax(mappers):
    """Support sets equal; noises to 1e-4 (the gradient noise's range
    variance in reeval_2d is a cancellation divided by delx = 0.01, which
    turns rounding into ~3e-5)."""
    mj, mt = mappers
    for name in ("x", "valid", "trained", "sigx", "siggrad"):
        np.testing.assert_allclose(
            getattr(mt.store, name).numpy().astype(np.float64),
            np.asarray(getattr(mj.store, name)).astype(np.float64),
            err_msg=name, **TOL)
    np.testing.assert_array_equal(mt.grid.numpy(), np.asarray(mj.grid))


def test_slice_test_matches_jax(mappers):
    mj, mt = mappers
    q = _queries()
    rt = mt.test(q)
    rj = mj.test(q)
    assert rt.shape == (len(q), 6) and rt.dtype == np.float32
    np.testing.assert_allclose(rt, rj, **TOL)
    assert (rt[:, 3] < 1.0 + mt.p.map_noise_param).mean() > 0.9
    assert mt.stats["test_eval_pairs"] == mj.stats["test_eval_pairs"]


@pytest.mark.parametrize("max_active", [16, 4])
def test_map_test_without_factor_cache_matches_jax(mappers, max_active):
    """map_test's per-call factorization branch (factors=None), also when
    more cells are touched than max_active and pairs are dropped."""
    import jax.numpy as jnp
    from gpismap_tpu.models import cluster as jcl
    from gpismap_tpu_torch.models import cluster as tcl

    mj, mt = mappers
    kw = dict(mt._test_kwargs(), max_active=max_active)
    q = np.full((1024, 2), 1e6, np.float32)
    q[:600] = _queries(seed=7)
    outj = jcl.map_test(mj.store, mj.grid, jnp.asarray(q), **kw)
    outt = tcl.map_test(mt.store, mt.grid, torch.as_tensor(q), **kw)
    for name, a, b in zip(("f", "g", "vf", "vg"), outj[:4], outt[:4]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)
    assert int(outt[4].n_pairs) == int(outj[4].n_pairs)
    assert int(outt[4].n_dropped) == int(outj[4].n_dropped)
    assert (int(outt[4].n_dropped) > 0) == (max_active == 4)
    cached = tcl.map_test(mt.store, mt.grid, torch.as_tensor(q),
                          factors=mt._get_factors(), **mt._test_kwargs())
    if max_active == 16:
        for a, b in zip(outt[:4], cached[:4]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_carried_map_answers_like_jax(mappers):
    """A JAX map carried across with state_from_numpy gives the same
    test() answers in the port (the fields runtime/checkpoint.py saves)."""
    mj, _ = mappers
    m2 = GPisMap2D(cap=CapacityParam(**TINY), device="cpu")
    store = {f"store_{k}": np.asarray(v) for k, v in
             mj.store._asdict().items()}
    state_from_numpy(mj.index.serialize(), store, mj.frame, m2)
    assert m2.num_nodes == mj.num_nodes and m2.frame == mj.frame
    q = _queries(seed=6)
    np.testing.assert_allclose(m2.test(q), mj.test(q), **TOL)


def test_state_from_numpy_rejects_other_capacities(mappers):
    mj, _ = mappers
    store = {f"store_{k}": np.asarray(v) for k, v in
             mj.store._asdict().items()}
    with pytest.raises(ValueError, match="capacity mismatch"):
        state_from_numpy(mj.index.serialize(), store, 0,
                         GPisMap2D(cap=CapacityParam(**dict(TINY,
                                                            max_cells=32)),
                                   device="cpu"))


def test_update_batch_and_reset():
    frames = torch_scenes.room_frames(2, 91)
    a = GPisMap2D(cap=CapacityParam(**TINY), device="cpu")
    b = GPisMap2D(cap=CapacityParam(**TINY), device="cpu")
    for f in frames:
        a.update(*f)
    b.update_batch(frames)
    q = _queries(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))
    b.reset()
    assert b.num_nodes == 0 and b.frame == 0
    empty = b.test(q)
    np.testing.assert_array_equal(empty[:, 3],
                                  np.float32(1.0 + b.p.map_noise_param))
    np.testing.assert_array_equal(empty[:, [0, 1, 2, 4, 5]], 0.0)


def test_import_leaves_jax_out():
    """The port imports torch and never jax (the GPU host has none), nor
    any module of the JAX package: after the import of the package, its
    render, checkpoint, mex, parallel, datasets and viz modules, and a
    construction of each mapper on the CPU (one on a size-1 mesh), no
    loaded module comes from gpismap_tpu/. viz loads no matplotlib
    until a plot helper draws."""
    code = (
        "import os, sys\n"
        "import gpismap_tpu_torch as g, gpismap_tpu_torch.convert\n"
        "import gpismap_tpu_torch.render, gpismap_tpu_torch.mex_compat\n"
        "import gpismap_tpu_torch.runtime.checkpoint\n"
        "import gpismap_tpu_torch.parallel.multihost as mh\n"
        "import gpismap_tpu_torch.datasets, gpismap_tpu_torch.viz\n"
        "g.GPisMap2D(device='cpu')\n"
        "g.GPisMap3D(mesh=mh.global_data_mesh(device='cpu'))\n"
        "ref = os.path.join(os.getcwd(), 'gpismap_tpu') + os.sep\n"
        "bad = [n for n, m in list(sys.modules.items())\n"
        "       if n == 'jax' or n.startswith(('jax.', 'jaxlib',\n"
        "                                      'matplotlib'))\n"
        "       or os.path.abspath(getattr(m, '__file__', None) or '')\n"
        "       .startswith(ref)]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_mapper_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPisMap2D(cap=CapacityParam(**TINY), device="cuda")
