"""The non-default re-evaluation modes: the PyTorch port vs the JAX package
in the same mode, over the tiny frames of tests/test_torch_slice.py (2D,
strict_reeval=True) and tests/test_torch_slice3d.py (3D, "strict" and
"snapshot"), on the CPU, at those files' tolerances.

2D strict re-evaluates the in-view cells one by one, each cell's nodes
gathered after the earlier cells' mutations; 3D "strict" does the same
for the kept cells, and "snapshot" re-evaluates every kept cell's nodes
in one batch of the frame's start state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper2D  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper3D  # noqa: E402
from gpismap_tpu.config import CameraParam as JaxCamera  # noqa: E402
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
    return torch_scenes.object_frames(3, CameraParam(**CAM))


def test_strict_2d_matches_jax():
    """GPisMap2D(strict_reeval=True) after 3 room frames: the same nodes,
    store and field as the JAX package's strict mapper."""
    mj = JaxMapper2D(cap=JaxCapacity(**TINY_2D), strict_reeval=True)
    mt = GPisMap2D(cap=CapacityParam(**TINY_2D), strict_reeval=True,
                   device="cpu")
    for frame in torch_scenes.room_frames(3, 181):
        mj.update(*frame)
        mt.update(*frame)
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
    frames = torch_scenes.room_frames(2, 181)
    a = GPisMap2D(cap=CapacityParam(**TINY_2D), strict_reeval=True,
                  device="cpu")
    b = GPisMap2D(cap=CapacityParam(**TINY_2D), strict_reeval=True,
                  device="cpu")
    for f in frames:
        a.update(*f)
    b.update_batch(frames)
    q = _queries_2d(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))


@pytest.mark.parametrize("mode", ["strict", "snapshot"])
def test_mode_3d_matches_jax(frames_3d, mode):
    """GPisMap3D(reeval_mode=mode) after 3 frames: the same node set,
    noises and normals, and the same field, as the JAX package's mapper
    in that mode."""
    caps = dict(TINY_3D)
    mj = JaxMapper3D(cap=JaxCapacity(**caps), camera=JaxCamera(**CAM),
                     reeval_mode=mode)
    mt = GPisMap3D(cap=CapacityParam(**caps), camera=CameraParam(**CAM),
                   reeval_mode=mode, device="cpu")
    for f in frames_3d:
        mj.update(*f)
        mt.update(*f)
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
    a = GPisMap3D(cap=CapacityParam(**TINY_3D), camera=CameraParam(**CAM),
                  reeval_mode="strict", device="cpu")
    b = GPisMap3D(cap=CapacityParam(**TINY_3D), reeval_mode="strict",
                  device="cpu")
    for f in frames_3d[:2]:
        a.update(*f)
    b.update_batch([(d, p, CameraParam(**CAM)) for d, p in frames_3d[:2]])
    q = _queries_3d(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))


@pytest.mark.parametrize("strict,mode,want", [
    (True, None, "hybrid"), (False, None, "snapshot"),
    (False, "strict", "strict"), (True, "snapshot", "snapshot")])
def test_mode_resolution_matches_jax(strict, mode, want):
    """reeval_mode None follows strict_reeval; an explicit mode wins."""
    mj = JaxMapper3D(cap=JaxCapacity(**TINY_3D), strict_reeval=strict,
                     reeval_mode=mode)
    mt = GPisMap3D(cap=CapacityParam(**TINY_3D), strict_reeval=strict,
                   reeval_mode=mode, device="cpu")
    assert mt.reeval_mode == mj.reeval_mode == want
    assert mt.strict_reeval == mj.strict_reeval == (want != "snapshot")


def test_unknown_and_fused_modes_raise():
    with pytest.raises(ValueError, match="unknown reeval_mode"):
        JaxMapper3D(cap=JaxCapacity(**TINY_3D), reeval_mode="batched")
    with pytest.raises(ValueError, match="unknown reeval_mode"):
        GPisMap3D(reeval_mode="batched", device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid"):
        GPisMap3D(reeval_mode="fused", device="cpu")
