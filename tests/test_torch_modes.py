"""The non-default re-evaluation modes: the PyTorch port vs the JAX package
in the same mode, over the tiny frames of tests/test_torch_slice.py (2D,
strict_reeval=True) and tests/test_torch_slice3d.py (3D, "strict",
"fused" and "snapshot"), on the CPU, at those files' tolerances. The maps
come from tests/torch_maps.py, built once per process.

2D strict re-evaluates the in-view cells one by one, each cell's nodes
gathered after the earlier cells' mutations; 3D "strict" does the same
for the kept cells, "fused" scans the kept cells in that order in one
device loop (applied on the host at the end of the frame), and
"snapshot" re-evaluates every kept cell's nodes in one batch of the
frame's start state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_maps  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper3D  # noqa: E402
from gpismap_tpu.config import CapacityParam as JaxCapacity  # noqa: E402
from gpismap_tpu_torch import (CameraParam, CapacityParam,  # noqa: E402
                               GPisMap2D, GPisMap3D)
from test_torch_slice import TINY as TINY_2D  # noqa: E402
from test_torch_slice import TOL  # noqa: E402
from test_torch_slice import _queries as _queries_2d  # noqa: E402
from test_torch_slice import _sorted_points  # noqa: E402
from test_torch_slice3d import CAM, GRAD_TOL, _check_field  # noqa: E402
from test_torch_slice3d import TINY as TINY_3D  # noqa: E402
from test_torch_slice3d import _queries as _queries_3d  # noqa: E402


@pytest.fixture(scope="module")
def frames_3d():
    return torch_maps.frames(3, 3)


def test_strict_2d_matches_jax():
    """GPisMap2D(strict_reeval=True) after 3 room frames: the same nodes,
    store and field as the JAX package's strict mapper."""
    mj = torch_maps.built(2, 3, jax=True, mode="strict")
    mt = torch_maps.built(2, 3, mode="strict")
    assert mt.num_nodes == mj.num_nodes > 0
    np.testing.assert_allclose(_sorted_points(mt), _sorted_points(mj),
                               rtol=0, atol=1e-5)
    for key in ("n_nodes", "n_cluster_cells", "new_inserted", "frame"):
        assert mt.stats[key] == mj.stats[key], key
    for name in ("x", "valid", "trained", "sigx", "siggrad"):
        np.testing.assert_allclose(
            getattr(mt.store, name).numpy().astype(np.float64),
            np.asarray(getattr(mj.store, name)).astype(np.float64),
            err_msg=name, **TOL)
    q = _queries_2d()
    np.testing.assert_allclose(mt.test(q), mj.test(q), **TOL)


def test_strict_2d_update_batch_matches_update():
    frames = torch_maps.frames(2, 2)
    a = GPisMap2D(cap=CapacityParam(**TINY_2D), strict_reeval=True,
                  device="cpu")
    b = GPisMap2D(cap=CapacityParam(**TINY_2D), strict_reeval=True,
                  device="cpu")
    for f in frames:
        a.update(*f)
    b.update_batch(frames)
    q = _queries_2d(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))


@pytest.mark.parametrize("mode", ["strict", "fused", "snapshot"])
def test_mode_3d_matches_jax(frames_3d, mode):
    """GPisMap3D(reeval_mode=mode) after 3 frames: the same node set,
    noises and normals, and the same field, as the JAX package's mapper
    in that mode."""
    mj = torch_maps.built(3, 3, jax=True, mode=mode)
    mt = torch_maps.built(3, 3, mode=mode)
    assert mt.reeval_mode == mj.reeval_mode == mode
    assert mt.num_nodes == mj.num_nodes > 100
    dj, dt = mj.index.dump_nodes(), mt.index.dump_nodes()
    np.testing.assert_array_equal(dt["alive"], dj["alive"])
    alive = dj["alive"]
    for name, tol in (("pos", 1e-5), ("pos_sig", 1e-4), ("val", 0),
                      ("grad", GRAD_TOL), ("grad_sig", GRAD_TOL)):
        np.testing.assert_allclose(dt[name][alive], dj[name][alive],
                                   rtol=tol, atol=tol, err_msg=name)
    for key in ("n_nodes", "n_cluster_cells", "frame"):
        assert mt.stats[key] == mj.stats[key], key
    q = _queries_3d()
    _check_field(mt.test(q), mj.test(q))


def test_strict_3d_update_batch_matches_update(frames_3d):
    a = torch_maps.built(3, 3, mode="strict")
    b = GPisMap3D(cap=CapacityParam(**TINY_3D), reeval_mode="strict",
                  device="cpu")
    b.update_batch([(d, p, CameraParam(**CAM)) for d, p in frames_3d])
    q = _queries_3d(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))


@pytest.mark.parametrize("mode", ["strict", "snapshot"])
def test_strict_and_snapshot_modes_map_the_scene(frames_3d, mode):
    """Every mode of the JAX package is ported ("fused" is checked
    against the hybrid map in tests/test_torch_slice3d.py). "strict", the
    host replay of the per-cell order, gives the hybrid map (the order
    hybrid computes in one pass); "snapshot" maps the scene too. Moved
    here from tests/test_torch_slice3d.py so that the strict replay runs
    once (torch_maps.built); each against the JAX package in its own
    mode: test_mode_3d_matches_jax."""
    hybrid = torch_maps.built(3, 3)
    m = torch_maps.built(3, 3, mode=mode)
    q = _queries_3d()
    r = m.test(q)
    if mode == "strict":
        np.testing.assert_array_equal(m.index.dump_nodes()["alive"],
                                      hybrid.index.dump_nodes()["alive"])
        _check_field(r, hybrid.test(q))
    else:
        assert m.num_nodes > 100 and np.isfinite(r).all()
        assert (r[:, 4] < 1.0 + m.p.map_noise_param).mean() > 0.5


@pytest.mark.parametrize("strict,mode,want", [
    (True, None, "hybrid"), (False, None, "snapshot"),
    (False, "strict", "strict"), (True, "snapshot", "snapshot"),
    (False, "fused", "fused")])
def test_mode_resolution_matches_jax(strict, mode, want):
    """reeval_mode None follows strict_reeval; an explicit mode wins."""
    mj = JaxMapper3D(cap=JaxCapacity(**TINY_3D), strict_reeval=strict,
                     reeval_mode=mode)
    mt = GPisMap3D(cap=CapacityParam(**TINY_3D), strict_reeval=strict,
                   reeval_mode=mode, device="cpu")
    assert mt.reeval_mode == mj.reeval_mode == want
    assert mt.strict_reeval == mj.strict_reeval == (want != "snapshot")


def test_unknown_mode_raises_and_fused_is_accepted():
    """An unknown mode raises in both packages; "fused" is accepted by
    both (it raised in the port before the scan was ported)."""
    with pytest.raises(ValueError, match="unknown reeval_mode"):
        JaxMapper3D(cap=JaxCapacity(**TINY_3D), reeval_mode="batched")
    with pytest.raises(ValueError, match="unknown reeval_mode"):
        GPisMap3D(reeval_mode="batched", device="cpu")
    mj = JaxMapper3D(cap=JaxCapacity(**TINY_3D), reeval_mode="fused")
    mt = GPisMap3D(cap=CapacityParam(**TINY_3D), reeval_mode="fused",
                   device="cpu")
    assert mt.reeval_mode == mj.reeval_mode == "fused"
    assert mt.strict_reeval and mj.strict_reeval
