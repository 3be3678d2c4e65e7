"""The whole 3D slice: gpismap_tpu.api3d.GPisMap3D vs the PyTorch port's
GPisMap3D over the same synthetic depth frames, at tiny capacities, on
the CPU.

The frames are tests/torch_scenes.py's box and cylinder through a 64x48
camera (fx = fy = 120). gp_support = 32 makes the retrain buckets 16 and
32, so the fits run at MP = 64 and 128 and the factor refresh embeds the
small L^-1 into the 128 layout. Queries are random points of the demo
volume (on lattice points two cells can be equidistant).

Tolerances (f32, rounding order only):
  * 1e-4 on f, var_f, node positions and position noises;
  * GRAD_TOL = 1e-3 on the node normals and gradient noises (finite
    differences over delx = 1e-3 m; tests/test_torch_mapper3d.py), on
    alpha, which solves against those normals, and on the field's
    gradient, which follows alpha (measured at most 2e-4);
  * VARG_TOL = 1e-4 of 3/l^2 + 0.001 = 1875 (l = 0.04 m) on var_grad:
    it is that constant minus a sum of the same size, so its rounding,
    and the effect of the gradient noises on the sum, scale with 1875
    (measured at most 0.025 = 1.3e-5 of it).

The refresh of the factor cache is checked against a fresh fill of the
port's own map (1e-5 of its largest entry); the JAX package's refresh of
the same L is compared in tests/test_torch_refresh.py, at d = 3 too. A
further frame on both maps is not compared at these tolerances: the
fourth update moves the normals further apart, and ill-conditioned
cluster systems carry that into the field's gradient beyond 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper  # noqa: E402
from gpismap_tpu.config import CameraParam as JaxCamera  # noqa: E402
from gpismap_tpu.config import CapacityParam as JaxCapacity  # noqa: E402
from gpismap_tpu_torch import CameraParam, CapacityParam, GPisMap3D  # noqa: E402,E501
from gpismap_tpu_torch.convert import state_from_numpy  # noqa: E402

TINY = dict(gp_support=32, retrain_batch=8, max_cells=256, max_nodes=4096,
            test_tile=16, test_active_cells=128, max_beams=64)
CAM = dict(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64, height=48)
GRAD_TOL = 1e-3
# 1e-4 of grad_const (MAPPER_3D.three_over_scale + 0.001)
VARG_TOL = 1e-4 * (3.0 / 0.04 ** 2 + 0.001)


def _queries(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(*torch_scenes.VOLUME_X, n),
                     rng.uniform(*torch_scenes.VOLUME_Y, n),
                     rng.uniform(*torch_scenes.VOLUME_Z, n)],
                    -1).astype(np.float32)


def _pair(**cap):
    caps = dict(TINY, **cap)
    return (JaxMapper(cap=JaxCapacity(**caps), camera=JaxCamera(**CAM)),
            GPisMap3D(cap=CapacityParam(**caps), camera=CameraParam(**CAM),
                      device="cpu"))


@pytest.fixture(scope="module")
def frames():
    return torch_scenes.object_frames(3, CameraParam(**CAM))


@pytest.fixture(scope="module")
def mappers(frames):
    """Both mappers after the same 3 frames."""
    mj, mt = _pair()
    for f in frames:
        mj.update(*f)
        mt.update(*f)
    return mj, mt


def _check_field(rt, rj):
    """[N, 8] test() outputs: f, grad, var_f, var_grad (module tolerances)."""
    assert rt.shape == rj.shape and rt.dtype == np.float32
    np.testing.assert_allclose(rt[:, [0, 4]], rj[:, [0, 4]], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(rt[:, 1:4], rj[:, 1:4], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
    np.testing.assert_allclose(rt[:, 5:8], rj[:, 5:8], rtol=0,
                               atol=VARG_TOL)


def test_slice3d_nodes_match_jax(mappers):
    """The same node ids alive, at the same places (both indexes number
    nodes in insertion order), with the same noises and normals."""
    mj, mt = mappers
    assert mt.num_nodes == mj.num_nodes > 100
    dj, dt = mj.index.dump_nodes(), mt.index.dump_nodes()
    np.testing.assert_array_equal(dt["alive"], dj["alive"])
    alive = dj["alive"]
    for name, tol in (("pos", 1e-5), ("pos_sig", 1e-4), ("val", 0),
                      ("grad", GRAD_TOL), ("grad_sig", GRAD_TOL)):
        np.testing.assert_allclose(dt[name][alive], dj[name][alive],
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(mt.get_all_points().shape,
                                  mj.get_all_points().shape)
    for key in ("n_nodes", "n_cluster_cells", "support_overflow", "frame"):
        assert mt.stats[key] == mj.stats[key], key
    assert mt.stats.get("reeval_dropped", 0) == mj.stats.get(
        "reeval_dropped", 0)


def test_slice3d_store_matches_jax(mappers):
    mj, mt = mappers
    for name, tol in (("x", 1e-4), ("valid", 0), ("trained", 0),
                      ("val", 0), ("sigx", 1e-4), ("siggrad", GRAD_TOL),
                      ("grad", GRAD_TOL), ("alpha", GRAD_TOL)):
        np.testing.assert_allclose(
            getattr(mt.store, name).numpy().astype(np.float64),
            np.asarray(getattr(mj.store, name)).astype(np.float64),
            rtol=tol, atol=tol, err_msg=name)
    assert int(mt.store.trained.sum()) > 20
    np.testing.assert_array_equal(mt.grid.numpy(), np.asarray(mj.grid))


def test_slice3d_test_matches_jax(mappers):
    mj, mt = mappers
    q = _queries()
    rt = mt.test(q)
    _check_field(rt, mj.test(q))
    assert mt._factors is not None          # served from the factor cache
    assert (rt[:, 4] < 1.0 + mt.p.map_noise_param).mean() > 0.5
    assert mt.stats["test_eval_pairs"] == mj.stats["test_eval_pairs"]


@pytest.mark.parametrize("max_active", [128, 16])
def test_map_test_3d_without_factor_cache_matches_jax(mappers, max_active):
    """map_test's per-call factorization (no factor cache), also when more
    cells are touched than max_active and pairs are dropped, as when the
    live cells exceed the cache bound."""
    import jax.numpy as jnp
    from gpismap_tpu.models import cluster as jcl
    from gpismap_tpu_torch.models import cluster as tcl

    mj, mt = mappers
    kw = dict(mt._test_kwargs(), max_active=max_active)
    q = np.full((1024, 3), 1e6, np.float32)
    q[:600] = _queries(seed=7)
    outj = jcl.map_test(mj.store, mj.grid, jnp.asarray(q), **kw)
    outt = tcl.map_test(mt.store, mt.grid, torch.as_tensor(q), **kw)
    _check_field(torch.cat([outt[0][:, None], outt[1], outt[2][:, None],
                            outt[3]], -1).numpy(),
                 np.concatenate([np.asarray(outj[0])[:, None],
                                 np.asarray(outj[1]),
                                 np.asarray(outj[2])[:, None],
                                 np.asarray(outj[3])], -1))
    assert int(outt[4].n_pairs) == int(outj[4].n_pairs)
    assert int(outt[4].n_dropped) == int(outj[4].n_dropped)
    assert (int(outt[4].n_dropped) > 0) == (max_active == 16)


def test_test_beyond_the_cache_bound(mappers):
    """A mapper whose live cells exceed test_active_cells answers through
    the per-call factorization, like JAX's."""
    mj, _ = mappers
    n_live = len(mj._live_slots())
    bound = n_live // 2
    store = {f"store_{k}": np.asarray(v) for k, v in
             mj.store._asdict().items()}
    m2 = GPisMap3D(cap=CapacityParam(**dict(TINY, test_active_cells=bound)),
                   camera=CameraParam(**CAM), device="cpu")
    state_from_numpy(mj.index.serialize(), store, mj.frame, m2)
    mj2 = JaxMapper(cap=JaxCapacity(**dict(TINY, test_active_cells=bound)),
                    camera=JaxCamera(**CAM))
    mj2.index.deserialize(mj.index.serialize())
    mj2.store = mj.store
    mj2._rebuild_grid()
    q = _queries(seed=8)
    _check_field(m2.test(q), mj2.test(q))
    assert m2._factors is None
    assert m2.stats.get("test_dropped_pairs", 0) == mj2.stats.get(
        "test_dropped_pairs", 0) > 0


def test_carried_map_answers_like_jax(mappers):
    """A JAX 3D map carried across with state_from_numpy gives the same
    test() answers in the port."""
    mj, _ = mappers
    _, m2 = _pair()
    store = {f"store_{k}": np.asarray(v) for k, v in
             mj.store._asdict().items()}
    state_from_numpy(mj.index.serialize(), store, mj.frame, m2)
    assert m2.num_nodes == mj.num_nodes and m2.frame == mj.frame
    q = _queries(seed=6)
    _check_field(m2.test(q), mj.test(q))


def test_refresh_from_fit_l(frames):
    """Re-ingesting a frame with a warm factor cache keeps the cache (the
    live slot set is unchanged, as in the JAX package) and refreshes it
    from the fits' own L, embedded from MP 64 into the 128 layout: it
    equals a fresh fill, and so does test() through it."""
    from gpismap_tpu_torch.models import cluster as tcl

    mj, mt = _pair()
    for f in frames:
        mj.update(*f)
        mt.update(*f)
    q = _queries(200, seed=9)
    mj.test(q)
    mt.test(q)
    uniq = mt._factors[1]
    mj.update(*frames[-1])
    mt.update(*frames[-1])
    assert mt._factors is not None and mt._factors[1] is uniq
    assert mj._factors is not None
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(mj._factors[1]))
    live = np.full(mt.cap.test_active_cells, -1, np.int32)
    live[:len(mt._factors_slots)] = mt._factors_slots
    fresh, _ = tcl.factorize_slots(mt.store, torch.as_tensor(live),
                                   mt.p.map_scale_param,
                                   mt.cap.test_active_cells)
    scale = float(fresh.abs().max())
    np.testing.assert_allclose(mt._factors[0].numpy(), fresh.numpy(),
                               rtol=0, atol=1e-5 * scale)
    r_cached = mt.test(q)
    mt._factors = None
    np.testing.assert_allclose(r_cached, mt.test(q), rtol=1e-4, atol=1e-4)


def test_update_batch_and_reset(frames):
    a = GPisMap3D(cap=CapacityParam(**TINY), camera=CameraParam(**CAM),
                  device="cpu")
    b = GPisMap3D(cap=CapacityParam(**TINY), device="cpu")
    for f in frames[:2]:
        a.update(*f)
    b.update_batch([(d, p, CameraParam(**CAM)) for d, p in frames[:2]])
    q = _queries(200)
    np.testing.assert_array_equal(a.test(q), b.test(q))
    b.reset()
    assert b.num_nodes == 0 and b.frame == 0
    empty = b.test(q)
    np.testing.assert_array_equal(empty[:, 4],
                                  np.float32(1.0 + b.p.map_noise_param))
    np.testing.assert_array_equal(empty[:, [0, 1, 2, 3, 5, 6, 7]], 0.0)


def test_set_camera_tables():
    m = GPisMap3D(cap=CapacityParam(**TINY), device="cpu")
    m.set_camera(3)
    assert m.cam.fx == pytest.approx(568.9403)
    m.set_camera(2, family="ycb")
    assert m.cam.fx == pytest.approx(571.8461)


@pytest.mark.parametrize("mode", ["fused"])
def test_fused_reeval_mode_maps_as_hybrid(mode):
    """"fused", the per-cell scan, gives the hybrid map after 3 frames:
    the same live nodes and, at this file's tolerances, the same field
    (the JAX package calls the two observably equal). It raised before
    the scan was ported; its match with the JAX package's fused mapper is
    tests/test_torch_modes.py::test_mode_3d_matches_jax. The "strict"
    and "snapshot" modes are checked in tests/test_torch_modes.py
    (test_strict_and_snapshot_modes_map_the_scene), beside that file's
    own run of the strict replay."""
    import torch_maps
    hybrid = torch_maps.built(3, 3)
    m = torch_maps.built(3, 3, mode=mode)
    assert m.reeval_mode == mode and m.num_nodes > 100
    assert m.stats.get("reeval_dropped", 0) == 0
    np.testing.assert_array_equal(m.index.dump_nodes()["alive"],
                                  hybrid.index.dump_nodes()["alive"])
    q = _queries()
    _check_field(m.test(q), hybrid.test(q))
