"""The factor-cache refresh that re-factorizes the retrained cells
(cluster.refresh_bucket, _factorize_cells_bucketed, update_factors) and
the retrain with the node mirror off (GPISMAP_NODE_MIRROR=0), which
takes it: the PyTorch port vs the JAX package on the CPU.

update_factors is held to 1e-5 of max |L^-1| (the refresh from the fit's
L is held so in tests/test_torch_refresh.py). The mappers run the tiny
scenes of tests/test_torch_slice.py (2D) and tests/test_torch_slice3d.py
(3D, at gp_support=64 so that the 3D refresh has a bucket below capacity:
buckets 16/32/64, refresh sizes 32 and 64, MP 128 and 256) with a test()
after the last frame, which is then ingested again: its retrain
refreshes a warm cache of an unchanged slot set; fields at 1e-4, normals
and gradients at 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_scenes  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper2D  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper3D  # noqa: E402
from gpismap_tpu.config import CameraParam as JaxCamera  # noqa: E402
from gpismap_tpu.config import CapacityParam as JaxCapacity  # noqa: E402
from gpismap_tpu.models import cluster as jcl  # noqa: E402
from gpismap_tpu_torch import (CameraParam, CapacityParam,  # noqa: E402
                               GPisMap2D, GPisMap3D)
from gpismap_tpu_torch.models import cluster as tcl  # noqa: E402
from test_torch_slice import TINY as TINY_2D  # noqa: E402
from test_torch_slice import TOL  # noqa: E402
from test_torch_slice import _queries as _queries_2d  # noqa: E402
from test_torch_slice3d import CAM, GRAD_TOL, _check_field  # noqa: E402
from test_torch_slice3d import TINY as TINY_3D  # noqa: E402
from test_torch_slice3d import _queries as _queries_3d  # noqa: E402

BIG = np.iinfo(np.int32).max


@pytest.mark.parametrize("d", [2, 3])
def test_refresh_bucket_matches_jax(d):
    for m in (16, 32, 64, 128, 320, 384):
        for mb in (None, 0, 1, 15, 16, 17, 31, 32, 33, 64, 80, 96, 127, 128,
                   129, 160, 161, 255, 256, 320, 384):
            assert tcl.refresh_bucket(mb, m, d) == \
                jcl.refresh_bucket(mb, m, d), (mb, m, d)
    assert tcl.refresh_bucket(80, 320, 3) == 96
    assert tcl.refresh_bucket(160, 320, 3) == 160
    assert tcl.refresh_bucket(64, 128, 2) is None


def _store(d, m, fill, seed):
    """A JAX store of 12 cells fitted on random support, each cell's
    valid rows the first fill[i]; and the port's copy."""
    rng = np.random.default_rng(seed)
    cap = JaxCapacity(gp_support=m, retrain_batch=16, max_cells=16,
                      max_nodes=256, test_tile=16, test_active_cells=16,
                      max_beams=64)
    b = len(fill)
    span = 0.1 if d == 3 else 2.0
    x = rng.uniform(-span, span, (b, m, d)).astype(np.float32)
    g = rng.normal(size=(b, m, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    valid = np.arange(m)[None, :] < np.asarray(fill)[:, None]
    x[~valid] = 0.0
    store = jcl.retrain_cells(
        jcl.make_store(cap, d), jnp.arange(b, dtype=jnp.int32),
        jnp.ones(b, bool), jnp.asarray(x), jnp.asarray(g),
        jnp.full((b, m), -0.2, jnp.float32),
        jnp.asarray(rng.uniform(0.01, 0.05, (b, m)).astype(np.float32)),
        jnp.asarray(rng.uniform(0.02, 0.2, (b, m)).astype(np.float32)),
        jnp.asarray(valid), 0.05 if d == 3 else 1.2)
    port = tcl.ClusterStore(*(torch.as_tensor(np.array(v)) for v in store))
    return store, port


@pytest.mark.parametrize("d,m,mb", [(2, 16, None), (3, 32, None),
                                    (3, 64, 32)])
def test_update_factors_matches_jax(d, m, mb):
    """update_factors at full size and at a refresh bucket, on a cache
    of 12 live cells with misses and -1 padding among the refreshed
    slots: the JAX package's refresh within 1e-5 of max |L^-1|, and a
    fresh fill of the refreshed cells within the same bound."""
    scale = 0.05 if d == 3 else 1.2
    fill = [m // 2 if mb is None else mb] * 12
    fill[3] = 1
    store_j, store_t = _store(d, m, fill, seed=d * 100 + m)
    live = np.full(16, -1, np.int32)
    live[:12] = np.arange(12)
    linv_j, uniq_j = jcl.factorize_slots(store_j, jnp.asarray(live), scale,
                                         16)
    linv_t, uniq_t = tcl.factorize_slots(store_t, torch.as_tensor(live),
                                         scale, 16)
    # refit the cells with new support so that the cache is stale
    store_j2, store_t2 = _store(d, m, fill, seed=d * 100 + m + 1)
    # 14 is no live cell (a miss, dropped); -1 is padding
    slots = np.array([5, -1, 0, 14, 3, 11, -1, 7], np.int32)
    out_j = jcl.update_factors(store_j2, linv_j, uniq_j, jnp.asarray(slots),
                               scale, mb=mb)
    before = linv_t.clone()
    out_t = tcl.update_factors(store_t2, linv_t, uniq_t,
                               torch.as_tensor(slots), scale, mb=mb)
    assert out_t is linv_t
    tol = 1e-5 * float(np.abs(np.asarray(out_j)).max())
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=tol)
    fresh, _ = tcl.factorize_slots(store_t2, torch.as_tensor(live), scale, 16)
    hit = [0, 3, 5, 7, 11]
    np.testing.assert_allclose(out_t[hit].numpy(), fresh[hit].numpy(),
                               rtol=0, atol=tol)
    rest = [i for i in range(16) if i not in hit]
    assert torch.equal(out_t[rest], before[rest])
    assert not torch.equal(out_t[hit], before[hit])


def _pair(dim, gp_support=64):
    if dim == 2:
        return (JaxMapper2D(cap=JaxCapacity(**TINY_2D)),
                GPisMap2D(cap=CapacityParam(**TINY_2D), device="cpu"))
    caps = dict(TINY_3D, gp_support=gp_support)
    return (JaxMapper3D(cap=JaxCapacity(**caps), camera=JaxCamera(**CAM)),
            GPisMap3D(cap=CapacityParam(**caps), camera=CameraParam(**CAM),
                      device="cpu"))


def test_refresh_buckets_match_jax():
    """The mappers' refresh sizes: the largest bucket below capacity, at
    most one, then the capacity (None), as the JAX package groups them;
    at the 3D default 160 of 320 (n=640 of 1280)."""
    for dim, m, want in ((2, 64, (None,)), (3, 32, (None,)),
                         (3, 64, (32, None)), (3, 320, (160, None))):
        mj, mt = _pair(dim, m)
        assert mt._refresh_buckets() == mj._refresh_buckets() == want


@pytest.mark.parametrize("dim", [2, 3])
def test_mirror_off_mapper_matches_jax(dim, monkeypatch):
    """GPISMAP_NODE_MIRROR=0 for both packages: the retrain gathers its
    support on the host and keeps no factor, so the test() after the
    last frame's second retrain reads a cache that update_factors
    refreshed (in 3D through the refresh bucket 32 too). The nodes, the
    store and the field against the JAX package's mirror-off mapper, and
    the refreshed cache against a fresh fill."""
    monkeypatch.setenv("GPISMAP_NODE_MIRROR", "0")
    mj, mt = _pair(dim)
    assert mt._refresh_buckets() == mj._refresh_buckets() == (
        (None,) if dim == 2 else (32, None))
    # 3D: two frames, then the second again (a further update moves
    # the normals beyond 1e-3, tests/test_torch_slice3d.py)
    frames = (torch_scenes.room_frames(3, 181) if dim == 2 else
              torch_scenes.object_frames(2, CameraParam(**CAM)))
    q = _queries_2d() if dim == 2 else _queries_3d()
    calls = []
    orig = tcl.update_factors

    def spy(*a, **kw):
        calls.append(kw.get("mb"))
        return orig(*a, **kw)

    monkeypatch.setattr(tcl, "update_factors", spy)
    for i, f in enumerate(frames + frames[-1:]):
        mj.update(*f)
        mt.update(*f)
        assert mt._mirror is None
        if i < len(frames) - 1:
            continue
        rt, rj = mt.test(q), mj.test(q)
        if dim == 2:
            np.testing.assert_allclose(rt, rj, **TOL)
        else:
            _check_field(rt, rj)
    assert calls and (dim == 2 or 32 in calls), calls
    assert mt.num_nodes == mj.num_nodes > 0
    dj, dt = mj.index.dump_nodes(), mt.index.dump_nodes()
    np.testing.assert_array_equal(dt["alive"], dj["alive"])
    alive = dj["alive"]
    for name, tol in (("pos", 1e-5), ("grad", GRAD_TOL)):
        np.testing.assert_allclose(dt[name][alive], dj[name][alive],
                                   rtol=tol, atol=tol, err_msg=name)
    for name in ("valid", "trained", "sigx"):
        np.testing.assert_allclose(
            getattr(mt.store, name).numpy().astype(np.float64),
            np.asarray(getattr(mj.store, name)).astype(np.float64),
            err_msg=name, **TOL)
    np.testing.assert_allclose(mt.store.alpha.numpy(),
                               np.asarray(mj.store.alpha), rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    live = np.full(mt.cap.test_active_cells, -1, np.int32)
    live[:len(mt._factors_slots)] = mt._factors_slots
    fresh, _ = tcl.factorize_slots(mt.store, torch.as_tensor(live),
                                   mt.p.map_scale_param,
                                   mt.cap.test_active_cells)
    np.testing.assert_allclose(mt._factors[0].numpy(), fresh.numpy(),
                               rtol=0, atol=1e-5 * float(fresh.abs().max()))
