"""The node mirror and the factor-cache refresh from the fit's L: the
PyTorch port vs the JAX package, function by function and through
GPisMap2D on the synthetic room at tiny capacities, on the CPU.

The API tests mirror tests/test_factors.py:23-74 and
tests/test_nbrs.py::test_mapper_mirror_matches_host_gather, which need
the bundled gazebo sequence.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_scenes  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper  # noqa: E402
from gpismap_tpu.config import CAPACITY_2D as JAX_CAPACITY_2D  # noqa: E402
from gpismap_tpu.config import CapacityParam as JaxCapacity  # noqa: E402
from gpismap_tpu.models import cluster as jcl  # noqa: E402
from gpismap_tpu_torch import CapacityParam, GPisMap2D  # noqa: E402
from gpismap_tpu_torch.config import CAPACITY_2D  # noqa: E402
from gpismap_tpu_torch.convert import state_from_numpy  # noqa: E402
from gpismap_tpu_torch.models import cluster as tcl  # noqa: E402

# the tiny capacities of tests/test_torch_slice.py
TINY = dict(gp_support=16, retrain_batch=8, max_cells=64, max_nodes=512,
            test_tile=16, test_active_cells=16, max_beams=64)
# port vs JAX: f32 rounding order only (PARITY.md)
TOL = dict(rtol=1e-4, atol=1e-4)
BIG = np.iinfo(np.int32).max


def _queries(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform([-2.6, -2.2], [2.6, 2.3], (n, 2)).astype(np.float32)


@pytest.fixture(scope="module")
def frames():
    return torch_scenes.room_frames(3, 181)


def _mappers():
    return JaxMapper(cap=JaxCapacity(**TINY)), GPisMap2D(
        cap=CapacityParam(**TINY))


def _to_jax(nt):
    return type(nt)(*(jnp.asarray(x.numpy()) for x in nt))


def _node_rows(rng, n, d=2):
    pos = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    grad = rng.normal(size=(n, d)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    return (pos, grad, (rng.normal(size=n) * 0.1).astype(np.float32),
            rng.uniform(0.01, 0.1, n).astype(np.float32),
            rng.uniform(0.01, 0.2, n).astype(np.float32))


def test_scatter_mirror_matches_jax():
    """Two scatters, ids of -1 among them: equal to JAX's mirror exactly."""
    rng = np.random.default_rng(0)
    cap = dataclasses.replace(CAPACITY_2D, max_nodes=32)
    mt = tcl.make_mirror(cap, 2, torch.device("cpu"))
    mj = jcl.make_mirror(dataclasses.replace(JAX_CAPACITY_2D, max_nodes=32),
                         2)
    for ids in (np.array([3, -1, 0, 31, 7, -1], np.int32),
                np.array([7, 12, -1, 3], np.int32)):
        rows = _node_rows(rng, len(ids))
        mj = jcl.scatter_mirror(mj, jnp.asarray(ids),
                                *(jnp.asarray(r) for r in rows))
        out = tcl.scatter_mirror(mt, torch.as_tensor(ids),
                                 *(torch.as_tensor(r) for r in rows))
        assert out is mt
        for name, a, b in zip(tcl.NodeMirror._fields, mj, mt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)


def test_mirror_rejects_node_ids_beyond_max_nodes(frames):
    """A node id at or above cap.max_nodes raises, in scatter_mirror and
    through the mapper's mirror sync (the JAX mirror drops the row)."""
    cap = dataclasses.replace(CAPACITY_2D, max_nodes=8)
    mirror = tcl.make_mirror(cap, 2, torch.device("cpu"))
    rows = _node_rows(np.random.default_rng(1), 2)
    with pytest.raises(ValueError, match="max_nodes"):
        tcl.scatter_mirror(mirror, torch.tensor([2, 8], dtype=torch.int32),
                           *(torch.as_tensor(r) for r in rows))
    m = GPisMap2D(cap=CapacityParam(**dict(TINY, max_nodes=16)))
    with pytest.raises(ValueError, match="mirror of 16 rows"):
        m.update(*frames[0])


def test_retrain_from_mirror_with_l_matches_jax():
    """Support gathered from the mirror, padded support and slot rows:
    store fields, alpha and the fit's L equal to JAX's."""
    rng = np.random.default_rng(2)
    n_nodes, b, mb = 40, 4, 8
    cap = dict(gp_support=16, max_cells=8, max_nodes=n_nodes)
    store_t = tcl.make_store(dataclasses.replace(CAPACITY_2D, **cap), 2,
                             torch.device("cpu"))
    store_j = jcl.make_store(dataclasses.replace(JAX_CAPACITY_2D, **cap), 2)
    mirror_t = tcl.make_mirror(dataclasses.replace(CAPACITY_2D, **cap), 2,
                               torch.device("cpu"))
    rows = _node_rows(rng, n_nodes)
    ids = np.arange(n_nodes, dtype=np.int32)
    tcl.scatter_mirror(mirror_t, torch.as_tensor(ids),
                       *(torch.as_tensor(r) for r in rows))
    mirror_j = _to_jax(mirror_t)
    sup = rng.choice(n_nodes, (b, mb)).astype(np.int32)
    sup[1, 5:] = -1
    sup[3] = -1                        # an empty padding row
    slots = np.array([2, 5, 0, -1], np.int32)

    st_j, l_j = jcl.retrain_cells_from_mirror_with_l(
        store_j, mirror_j, jnp.asarray(slots), jnp.asarray(slots >= 0),
        jnp.asarray(sup), 1.2)
    st_t, l_t = tcl.retrain_cells_from_mirror_with_l(
        store_t, mirror_t, torch.as_tensor(slots),
        torch.as_tensor(slots >= 0), torch.as_tensor(sup), 1.2)
    for name in tcl.ClusterStore._fields:
        np.testing.assert_allclose(
            getattr(st_t, name).numpy().astype(np.float64),
            np.asarray(getattr(st_j, name)).astype(np.float64),
            err_msg=name, **TOL)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    st_only = tcl.retrain_cells_from_mirror(
        store_t, mirror_t, torch.as_tensor(slots),
        torch.as_tensor(slots >= 0), torch.as_tensor(sup), 1.2)
    assert torch.equal(st_only.alpha, st_t.alpha)


def test_update_factors_from_l_matches_jax():
    """The d = 3, gp_support = 64, mb = 32 case of tests/test_factors.py:
    the refresh from the fit's L and _embed_linv equal JAX's (2e-5, as
    there), and rows whose slot misses the cache are dropped."""
    rng = np.random.default_rng(11)
    d, b, mb, nvalid, scale = 3, 4, 32, 20, 0.8
    cap = dict(gp_support=64, max_cells=8)
    x = rng.normal(size=(b, mb, d)).astype(np.float32)
    g = rng.normal(size=(b, mb, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    val = rng.normal(size=(b, mb)).astype(np.float32) * 0.1
    sig = np.full((b, mb), 0.02, np.float32)
    valid = np.zeros((b, mb), bool)
    valid[:, :nvalid] = True
    fit = (x, g, val, sig, sig, valid)
    slots = np.arange(b, dtype=np.int32)
    _, l_j = jcl._retrain_impl(
        jcl.make_store(dataclasses.replace(JAX_CAPACITY_2D, **cap), d),
        jnp.asarray(slots), jnp.ones(b, bool),
        *(jnp.asarray(a) for a in fit), scale)
    _, l_t = tcl._retrain_impl(
        tcl.make_store(dataclasses.replace(CAPACITY_2D, **cap), d,
                       torch.device("cpu")),
        torch.as_tensor(slots), torch.ones(b, dtype=torch.bool),
        *(torch.as_tensor(a) for a in fit), scale)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **TOL)
    # the refresh and the embedding are compared on the same L
    mp = 64 * (1 + d)
    n_act = 8                      # cache rows (test_active_cells)
    uniq = np.concatenate([slots, np.full(n_act - b, BIG, np.int32)])
    emb_j = jcl._embed_linv(jnp.asarray(l_t.numpy()), mp, d)
    emb_t = tcl._embed_linv(l_t, mp, d)
    np.testing.assert_array_equal(emb_t.numpy(), np.asarray(emb_j))

    for sl in (slots, np.array([0, 7, -1, 3], np.int32)):
        up_j = jcl.update_factors_from_l(
            jnp.zeros((n_act, mp, mp), jnp.float32), jnp.asarray(uniq),
            jnp.asarray(sl), jnp.asarray(l_t.numpy()), d=d)
        buf = torch.zeros((n_act, mp, mp))
        up_t = tcl.update_factors_from_l(buf, torch.as_tensor(uniq),
                                         torch.as_tensor(sl), l_t, d=d)
        assert up_t is buf                      # written in place
        np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), rtol=0,
                                   atol=2e-5)
    np.testing.assert_array_equal(up_t[1].numpy(), 0.0)
    np.testing.assert_array_equal(up_t[2].numpy(), 0.0)


def _fresh_factors(m):
    live = m._live_slots()
    pad = np.full(m.cap.test_active_cells, -1, np.int32)
    pad[:len(live)] = live
    return tcl.factorize_slots(m.store, torch.as_tensor(pad),
                               m.p.map_scale_param, m.cap.test_active_cells)


def test_incremental_refresh_matches_fresh_and_jax(frames):
    """Fill the cache, re-ingest the same frame (every insert dedups, so
    the slot set is unchanged): the port refreshes its cache from the
    fits' L instead of dropping it, equal to a fresh factorization and
    to the JAX mapper's cache, and test() equals JAX's."""
    mj, mt = _mappers()
    q = _queries()
    for m in (mj, mt):
        m.update(*frames[0])
        m.test(q)
    uniq = mt._factors[1]
    for m in (mj, mt):
        m.update(*frames[0])
    assert mt._factors is not None, "the incremental branch did not run"
    assert mt._factors[1] is uniq, "the cache was rebuilt, not refreshed"
    assert mj._factors is not None

    linv_fresh, uniq_fresh = _fresh_factors(mt)
    np.testing.assert_array_equal(mt._factors[1].numpy(),
                                  uniq_fresh.numpy())
    np.testing.assert_allclose(mt._factors[0].numpy(), linv_fresh.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mt._factors[0].numpy(),
                               np.asarray(mj._factors[0]), **TOL)
    np.testing.assert_allclose(mt.test(q), mj.test(q), **TOL)


def test_factor_cache_dropped_on_slot_set_change(frames):
    mt = GPisMap2D(cap=CapacityParam(**TINY))
    mt.update(*frames[0])
    mt.test(_queries(50))
    live = mt._live_slots()
    assert mt._factors is not None
    mt.update(*frames[2])           # a new pose maps new cells
    assert not np.array_equal(mt._live_slots(), live)
    assert mt._factors is None and mt._factors_slots is None


def test_mirror_matches_host_gather(frames):
    """After every frame the mirror holds every live node's host row."""
    mt = GPisMap2D(cap=CapacityParam(**TINY))
    for f in frames:
        mt.update(*f)
        d = mt.index.dump_nodes()
        live = np.nonzero(d["alive"])[0]
        host = mt.index.get_nodes(live.astype(np.int32))
        for name in tcl.NodeMirror._fields:
            np.testing.assert_array_equal(
                getattr(mt._mirror, name)[live].numpy(), host[name],
                err_msg=name)


def test_carried_map_update_matches_jax(frames):
    """A JAX map carried over by state_from_numpy and then updated gives
    the same store and test() as the JAX mapper updated with the same
    frame (the port's mirror is seeded from the loaded index)."""
    mj, mt = _mappers()
    for f in frames[:2]:
        mj.update(*f)
    store = {f"store_{k}": np.asarray(v) for k, v in
             mj.store._asdict().items()}
    state_from_numpy(mj.index.serialize(), store, mj.frame, mt)
    assert mt._mirror is None and mt._factors_slots is None
    mj.update(*frames[2])
    mt.update(*frames[2])
    for name in ("x", "valid", "trained", "sigx", "siggrad"):
        np.testing.assert_allclose(
            getattr(mt.store, name).numpy().astype(np.float64),
            np.asarray(getattr(mj.store, name)).astype(np.float64),
            err_msg=name, **TOL)
    q = _queries(seed=8)
    np.testing.assert_allclose(mt.test(q), mj.test(q), **TOL)
