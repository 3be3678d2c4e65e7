"""The port's ctypes binding of csrc/gpis_index.cpp vs the JAX package's,
on a 3D octree (TREE_3D) insert / query / re-evaluation probe after
tests/test_index.py:119: every call the 3D mapper makes returns the same
arrays from both bindings."""
import numpy as np
import pytest

pytest.importorskip("torch")

from gpismap_tpu.config import TREE_3D as JAX_TREE_3D  # noqa: E402
from gpismap_tpu.runtime import SpatialIndex as JaxIndex  # noqa: E402
from gpismap_tpu_torch.config import TREE_3D  # noqa: E402
from gpismap_tpu_torch.runtime.index import SpatialIndex  # noqa: E402

NODE_KEYS = ("pos", "grad", "val", "pos_sig", "grad_sig", "alive")


def _assert_nodes_equal(a, b):
    for k in NODE_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def indexes():
    """Both bindings after the same inserts and node data: 400 points in
    a 0.6 m cube, half of them near a plane (a surface with clusters
    of many nodes)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([
        rng.uniform(-0.3, 0.3, (200, 3)),
        np.stack([rng.uniform(-0.2, 0.2, 200), rng.uniform(-0.2, 0.2, 200),
                  0.0431 + 0.002 * rng.standard_normal(200)], -1),
    ]).astype(np.float32)
    grad = rng.normal(size=pts.shape).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    out = []
    for idx in (JaxIndex(3, JAX_TREE_3D, max_slots=4096),
                SpatialIndex(3, TREE_3D, max_slots=4096)):
        ids = idx.try_insert(pts)
        ok = ids >= 0
        n = int(ok.sum())
        idx.set_node_data(ids[ok], np.full(n, -0.2, np.float32),
                          np.full(n, 0.01, np.float32), grad[ok],
                          np.full(n, 0.05, np.float32))
        out.append((idx, ids))
    return out


def test_inserts_and_nodes_match_jax(indexes):
    (ij, ids_j), (it, ids_t) = indexes
    np.testing.assert_array_equal(ids_t, ids_j)
    assert (ids_t >= 0).sum() > 100 and (ids_t == -2).any()
    assert it.num_nodes == ij.num_nodes
    assert it.max_slot == ij.max_slot
    _assert_nodes_equal(it.dump_nodes(), ij.dump_nodes())
    sel = np.concatenate([ids_t[ids_t >= 0][::3], [-1, -1]]).astype(np.int32)
    _assert_nodes_equal(it.get_nodes(sel), ij.get_nodes(sel))


def test_cluster_queries_match_jax(indexes):
    (ij, _), (it, _) = indexes
    for center, half in (((0.0, 0.0, 0.5), 0.55), ((0.1, -0.05, 0.04), 0.2),
                         ((2.0, 2.0, 2.0), 0.1)):
        c = np.asarray(center, np.float32)
        cells_j, dist_j = ij.query_cluster_cells(c, half, cap=65536)
        cells_t, dist_t = it.query_cluster_cells(c, half, cap=65536)
        np.testing.assert_array_equal(cells_t, cells_j)
        np.testing.assert_array_equal(dist_t, dist_j)
    all_j = ij.all_cluster_cells(cap=4096 * 4)
    all_t = it.all_cluster_cells(cap=4096 * 4)
    np.testing.assert_array_equal(all_t, all_j)
    assert len(all_t) > 20
    for a, b in zip(it.cell_info(all_t), ij.cell_info(all_j)):
        np.testing.assert_array_equal(a, b)
    for c in all_t:
        np.testing.assert_array_equal(it.cell_nodes(c), ij.cell_nodes(c))
    rj = ij.collect_retrain(2.0, 32, 64 * 16)
    rt = it.collect_retrain(2.0, 32, 64 * 16)
    for k in rj:
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)


def test_apply_reeval_matches_jax(indexes):
    """All four actions through apply_reeval (on copies of the indexes),
    then the same tree state, node table and serialized blob."""
    (ij0, ids), (it0, _) = indexes
    blob = it0.serialize()
    np.testing.assert_array_equal(blob, ij0.serialize())
    ij = JaxIndex(3, JAX_TREE_3D, max_slots=4096)
    it = SpatialIndex(3, TREE_3D, max_slots=4096)
    ij.deserialize(blob)
    it.deserialize(blob)
    rng = np.random.default_rng(1)
    live = ids[ids >= 0][:120]
    n = len(live)
    actions = rng.integers(0, 4, n).astype(np.int32)
    pos = (ij.get_nodes(live)["pos"]
           + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    grad = rng.normal(size=(n, 3)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    vals = [rng.uniform(0.01, 0.2, n).astype(np.float32) for _ in range(4)]
    out_j = ij.apply_reeval(live, actions, pos, grad, *vals, -0.2)
    out_t = it.apply_reeval(live, actions, pos, grad, *vals, -0.2)
    np.testing.assert_array_equal(out_t, out_j)
    assert (out_t >= 0).any()
    _assert_nodes_equal(it.dump_nodes(), ij.dump_nodes())
    np.testing.assert_array_equal(it.all_cluster_cells(),
                                  ij.all_cluster_cells())
    np.testing.assert_array_equal(it.serialize(), ij.serialize())


def _copies(indexes):
    """Fresh copies of both fixture indexes (deserialized from the port's
    blob, which the JAX binding writes byte for byte the same), with their
    dirty sets emptied."""
    (ij0, ids), (it0, _) = indexes
    blob = it0.serialize()
    ij = JaxIndex(3, JAX_TREE_3D, max_slots=4096)
    it = SpatialIndex(3, TREE_3D, max_slots=4096)
    ij.deserialize(blob)
    it.deserialize(blob)
    ij.pop_dirty()
    it.pop_dirty()
    return ij, it, ids


def test_update_noise_matches_jax(indexes):
    """update_noise sets the same noises in both bindings and, as in the
    JAX binding, marks its ids dirty for the node mirror."""
    ij, it, ids = _copies(indexes)
    rng = np.random.default_rng(2)
    live = ids[ids >= 0][5:90:2]
    ps = rng.uniform(0.001, 0.1, len(live)).astype(np.float32)
    gs = rng.uniform(0.01, 0.3, len(live)).astype(np.float32)
    ij.update_noise(live, ps, gs)
    it.update_noise(live, ps, gs)
    dirty = it.pop_dirty()
    np.testing.assert_array_equal(dirty, ij.pop_dirty())
    np.testing.assert_array_equal(dirty, np.unique(live))
    nodes = it.get_nodes(live)
    np.testing.assert_array_equal(nodes["pos_sig"], ps)
    np.testing.assert_array_equal(nodes["grad_sig"], gs)
    _assert_nodes_equal(it.dump_nodes(), ij.dump_nodes())
    np.testing.assert_array_equal(it.serialize(), ij.serialize())


def test_remove_matches_jax(indexes):
    """remove takes the same nodes out of both trees (node table, cells,
    blob) and, as in the JAX binding, leaves the dirty set alone."""
    ij, it, ids = _copies(indexes)
    gone = ids[ids >= 0][::4]
    n0 = it.num_nodes
    ij.remove(gone)
    it.remove(gone)
    assert it.num_nodes == ij.num_nodes == n0 - len(gone)
    assert len(it.pop_dirty()) == len(ij.pop_dirty()) == 0
    d = it.dump_nodes()
    assert not d["alive"][gone].any()
    _assert_nodes_equal(d, ij.dump_nodes())
    np.testing.assert_array_equal(it.all_cluster_cells(),
                                  ij.all_cluster_cells())
    np.testing.assert_array_equal(it.serialize(), ij.serialize())


def test_query_range_matches_jax(indexes):
    """query_range returns the same node ids in the same order; a result
    larger than cap re-issues the call at the exact size and counts it in
    regrow_count in both bindings."""
    (ij, _), (it, _) = indexes
    for center, half in (((0.0, 0.0, 0.0), 0.5), ((0.1, -0.05, 0.04), 0.08),
                         ((2.0, 2.0, 2.0), 0.1)):
        c = np.asarray(center, np.float32)
        np.testing.assert_array_equal(it.query_range(c, half),
                                      ij.query_range(c, half))
    c = np.zeros(3, np.float32)
    full = it.query_range(c, 0.5)
    assert len(full) == it.num_nodes > 16
    rj, rt = ij.regrow_count, it.regrow_count
    small_t = it.query_range(c, 0.5, cap=16)
    small_j = ij.query_range(c, 0.5, cap=16)
    np.testing.assert_array_equal(small_t, full)
    np.testing.assert_array_equal(small_t, small_j)
    assert it.regrow_count == rt + 1 and ij.regrow_count == rj + 1


def test_active_cells_matches_jax():
    """active_cells after the same inserts: the same cells in both
    bindings, also through a cap below the count (one regrow each);
    clear_active empties both."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    ij = JaxIndex(3, JAX_TREE_3D, max_slots=4096)
    it = SpatialIndex(3, TREE_3D, max_slots=4096)
    ij.try_insert(pts)
    it.try_insert(pts)
    act = it.active_cells()
    np.testing.assert_array_equal(act, ij.active_cells())
    assert len(act) > 4
    np.testing.assert_array_equal(it.active_cells(cap=2),
                                  ij.active_cells(cap=2))
    assert it.regrow_count == ij.regrow_count == 1
    ij.clear_active()
    it.clear_active()
    assert len(it.active_cells()) == len(ij.active_cells()) == 0
