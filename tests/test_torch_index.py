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
