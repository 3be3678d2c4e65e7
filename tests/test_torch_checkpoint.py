"""Checkpoints across the two packages, the mex front end, and
render_depth of a carried 3D map, on the CPU.

A map saved by gpismap_tpu.runtime.checkpoint loads into the port and a
map saved by the port's runtime/checkpoint loads into the JAX package
(format 1: dim, frame, index_blob, store_<field>); the loaded map answers
test() like the saved one, and keeps doing so after one more update. The
mex surface (mex_compat.gpismap / gpismap3) runs with device="cpu".
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu import config as jcfg  # noqa: E402
from gpismap_tpu import render as jrender  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper3D  # noqa: E402
from gpismap_tpu.runtime import checkpoint as jckpt  # noqa: E402
from gpismap_tpu_torch import (CameraParam, CapacityParam,  # noqa: E402
                               GPisMap2D, GPisMap3D, mex_compat, render)
from gpismap_tpu_torch.runtime import checkpoint  # noqa: E402

# the tiny capacities of tests/test_torch_slice.py
TINY = dict(gp_support=16, retrain_batch=8, max_cells=64, max_nodes=512,
            test_tile=16, test_active_cells=16, max_beams=64)
TOL = dict(rtol=1e-4, atol=1e-4)
CAM = dict(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64, height=48)
# the 3D maps of tests/test_torch_slice3d.py's size: M=32 (MP=128)
CAP3 = dict(gp_support=32, retrain_batch=16, max_cells=4096,
            max_nodes=131072, test_tile=128, test_active_cells=320,
            max_beams=512)


def _queries(n=400, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform([-2.6, -2.2], [2.6, 2.3], (n, 2)).astype(np.float32)


def _port():
    return GPisMap2D(cap=CapacityParam(**TINY), device="cpu")


@pytest.fixture(scope="module")
def frames():
    return torch_scenes.room_frames(3, 181)


@pytest.fixture(scope="module")
def jax_saved(frames, tmp_path_factory):
    """A JAX map after two frames, saved, with its test() before and
    after the third frame."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    mj = JaxMapper(cap=jcfg.CapacityParam(**TINY))
    for f in frames[:2]:
        mj.update(*f)
    jckpt.save(mj, path)
    q = _queries()
    before = mj.test(q)
    mj.update(*frames[2])
    return dict(path=path, before=before, after=mj.test(q),
                nodes_after=mj.num_nodes)


def test_checkpoint_roundtrip_port_to_port(frames, tmp_path):
    m = _port()
    for f in frames[:2]:
        m.update(*f)
    q = _queries()
    before = m.test(q)
    path = os.path.join(tmp_path, "map.npz")
    checkpoint.save(m, path)
    with np.load(path) as d:
        assert int(d["format"]) == 1 and int(d["dim"]) == 2
        assert d["store_valid"].dtype == bool
        assert d["store_trained"].dtype == bool
    m2 = _port()
    checkpoint.load(m2, path)
    assert m2.num_nodes == m.num_nodes and m2.frame == m.frame == 2
    np.testing.assert_allclose(m2.test(q), before, rtol=1e-5, atol=1e-6)
    m.update(*frames[2])
    m2.update(*frames[2])
    assert m2.num_nodes == m.num_nodes
    np.testing.assert_allclose(m2.test(q), m.test(q), rtol=1e-5, atol=1e-6)


def test_checkpoint_jax_to_port(frames, jax_saved):
    m = _port()
    checkpoint.load(m, jax_saved["path"])
    q = _queries()
    np.testing.assert_allclose(m.test(q), jax_saved["before"], **TOL)
    m.update(*frames[2])
    assert m.num_nodes == jax_saved["nodes_after"]
    np.testing.assert_allclose(m.test(q), jax_saved["after"], **TOL)


def test_checkpoint_port_to_jax(frames, tmp_path):
    m = _port()
    for f in frames[:2]:
        m.update(*f)
    path = os.path.join(tmp_path, "port.npz")
    checkpoint.save(m, path)
    mj = JaxMapper(cap=jcfg.CapacityParam(**TINY))
    jckpt.load(mj, path)
    assert mj.num_nodes == m.num_nodes and mj.frame == 2
    q = _queries()
    np.testing.assert_allclose(np.asarray(mj.test(q)), m.test(q), **TOL)
    m.update(*frames[2])
    mj.update(*frames[2])
    assert mj.num_nodes == m.num_nodes
    np.testing.assert_allclose(np.asarray(mj.test(q)), m.test(q), **TOL)


def test_checkpoint_load_checks_dim_and_format(jax_saved, tmp_path):
    with pytest.raises(ValueError, match="dimensionality"):
        checkpoint.load(GPisMap3D(device="cpu"), jax_saved["path"])
    with np.load(jax_saved["path"]) as d:
        fields = dict(d)
    bad = os.path.join(tmp_path, "bad.npz")
    np.savez(bad, **dict(fields, format=2))
    with pytest.raises(ValueError, match="format"):
        checkpoint.load(_port(), bad)
    with pytest.raises(ValueError, match="capacity mismatch"):
        checkpoint.load(GPisMap2D(cap=CapacityParam(**dict(TINY,
                                                           max_cells=32)),
                                  device="cpu"), jax_saved["path"])


def test_mex_surface_2d(frames):
    """gpismap(): update -> elapsed seconds, test -> ([6, N], seconds) from
    [2, N] or [N, 2], reset; the same answers as the mapper driven
    directly (default capacities, on the CPU)."""
    mex_compat.gpismap("reset")
    with pytest.raises(RuntimeError, match="Create the map first"):
        mex_compat.gpismap("test", np.zeros((2, 3), np.float32))
    ref = GPisMap2D(device="cpu")
    try:
        for f in frames[:2]:
            dt = mex_compat.gpismap("update", *f, device="cpu")
            ref.update(*f)
            assert dt >= 0
        q = _queries(50)
        res, dt = mex_compat.gpismap("test", q.T)
        assert res.shape == (6, 50) and dt >= 0
        np.testing.assert_array_equal(res, ref.test(q).T)
        res2, _ = mex_compat.gpismap("test", q)
        np.testing.assert_array_equal(res2, res)
        with pytest.raises(ValueError, match="unknown command"):
            mex_compat.gpismap("fly")
    finally:
        mex_compat.gpismap("reset")
    assert mex_compat._gpm2 is None


def test_mex_surface_3d():
    """gpismap3(): setCamera (a CameraParam, the 64x48 test camera),
    update x2, test -> ([8, N], seconds), getAllPoints, reset; the same
    answers as the mapper driven directly."""
    cam = CameraParam(**CAM)
    frames = torch_scenes.object_frames(2, cam)
    mex_compat.gpismap3("reset")
    assert mex_compat.gpismap3("getAllPoints").shape == (0, 3)
    ref = GPisMap3D(camera=cam, device="cpu")
    try:
        assert mex_compat.gpismap3("setCamera", cam, device="cpu") is None
        assert mex_compat._gpm3.device.type == "cpu"
        for depth, pose in frames:
            assert mex_compat.gpismap3("update", depth, pose) >= 0
            ref.update(depth, pose)
        q = torch_scenes.volume_grid(0.03)
        res, dt = mex_compat.gpismap3("test", q.T)
        assert res.shape == (8, len(q)) and dt >= 0
        np.testing.assert_array_equal(res, ref.test(q).T)
        pts = mex_compat.gpismap3("getAllPoints")
        assert pts.shape == (ref.num_nodes, 3) and len(pts) > 0
    finally:
        mex_compat.gpismap3("reset")
    assert mex_compat._gpm3 is None


def test_render_depth_of_a_carried_3d_map_matches_jax(tmp_path):
    """A JAX 3D map loaded into the port renders the same depth image
    (config_from_mapper, camera_rays, the march through the mapper's
    factor cache, the correction); at the hit pixels the depth is the
    scene's ray length z |(u, v, 1)|, not its optical-axis depth z."""
    cam = jcfg.CameraParam(**CAM)
    frames = torch_scenes.object_frames(6, cam)
    mj = JaxMapper3D(camera=cam, cap=jcfg.CapacityParam(**CAP3))
    mj.update_batch(frames)
    path = os.path.join(tmp_path, "map3d.npz")
    jckpt.save(mj, path)
    m = GPisMap3D(camera=CameraParam(**CAM), cap=CapacityParam(**CAP3),
                  device="cpu")
    checkpoint.load(m, path)
    cfg_j = jrender.config_from_mapper(mj)
    cfg_t = render.config_from_mapper(m)
    for k in cfg_t._fields:
        assert getattr(cfg_t, k) == getattr(cfg_j, k), k

    pose = frames[-1][1]
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")
    rj = jrender.render_depth(mj, tr, rot, subsample=2)
    rt = render.render_depth(m, tr, rot, subsample=2)
    np.testing.assert_array_equal(rt["hit"], rj["hit"])
    assert rt["hit"].sum() > 0
    hit = rt["hit"]
    for k in ("depth", "normal", "var"):
        np.testing.assert_allclose(rt[k][hit], rj[k][hit], err_msg=k,
                                   **TOL)
    ray = torch_scenes.ray_lengths(pose, cam, 2)
    z = torch_scenes.render_depth(pose, cam, noise=0.0)[::2, ::2]
    err = np.abs(rt["depth"] - ray)[hit]
    assert np.median(err) < np.median(np.abs(rt["depth"] - z)[hit])
