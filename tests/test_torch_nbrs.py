"""The candidate table (cluster.NeighborTable) and the two-phase query in
the PyTorch port, against the port's own window and single-phase paths
and against the JAX package, on the CPU.

The table is a layout change (one row gather per query in place of the
window gather, entries in window order) and two_phase skips only pairs
the selection never reads, so both must give the port's default path's
results to the last bit. Against the JAX package: the table's integer
arrays equal, the fields at tests/test_torch_slice.py's and
tests/test_torch_slice3d.py's tolerances.

Maps: GPisMap2D after tests/test_torch_slice.py's 3 room frames (a
2^16-cell grid: the dense table) and GPisMap3D after 2 of
tests/test_torch_slice3d.py's object frames (a 2^21-cell grid: the
sorted-key table), both at those files' tiny capacities.
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
from gpismap_tpu.models import cluster as jc  # noqa: E402
from gpismap_tpu_torch import (CameraParam, CapacityParam,  # noqa: E402
                               GPisMap2D, GPisMap3D, render)
from gpismap_tpu_torch.models import cluster as tc  # noqa: E402
from test_torch_slice import TINY as TINY_2D  # noqa: E402
from test_torch_slice import TOL  # noqa: E402
from test_torch_slice import _queries as _queries_2d  # noqa: E402
from test_torch_slice3d import CAM, _check_field  # noqa: E402
from test_torch_slice3d import TINY as TINY_3D  # noqa: E402
from test_torch_slice3d import _queries as _queries_3d  # noqa: E402


def _frames(dim):
    if dim == 2:
        return torch_scenes.room_frames(3, 181)
    return torch_scenes.object_frames(2, CameraParam(**CAM))


def _make(dim, jax=False, **cap):
    if dim == 2:
        caps = dict(TINY_2D, **cap)
        return (JaxMapper2D(cap=JaxCapacity(**caps)) if jax else
                GPisMap2D(cap=CapacityParam(**caps), device="cpu"))
    caps = dict(TINY_3D, **cap)
    return (JaxMapper3D(cap=JaxCapacity(**caps), camera=JaxCamera(**CAM))
            if jax else GPisMap3D(cap=CapacityParam(**caps),
                                  camera=CameraParam(**CAM), device="cpu"))


@pytest.fixture(scope="module")
def maps():
    """The port's 2D and 3D maps (window path: the table is off on the
    CPU)."""
    out = {}
    for dim in (2, 3):
        m = _make(dim)
        for f in _frames(dim):
            m.update(*f)
        out[dim] = m
    return out


def _queries(dim):
    return _queries_2d() if dim == 2 else _queries_3d()


def _live_cells(m):
    """The mapper's padded live-cell list, as _build_nbrs makes it."""
    centers, _, slots = m.index.cell_info(m.index.all_cluster_cells())
    live = slots >= 0
    n = int(live.sum())
    cpad = max(64, 1 << (n - 1).bit_length())
    cc = np.zeros((cpad, m.dim), np.int32)
    sl = np.full(cpad, -1, np.int32)
    cc[:n] = np.floor(centers[live] / m.cell_size).astype(np.int32)
    sl[:n] = slots[live]
    return cc, sl


def _tables(m, k_cap, dense):
    """The port's and the JAX package's table of map m."""
    cc, sl = _live_cells(m)
    args = (m.grid_half, m._noff, k_cap, dense)
    tt = tc.build_neighbor_table(torch.as_tensor(cc), torch.as_tensor(sl),
                                 m.store.trained, *args)
    tj = jc.build_neighbor_table(jnp.asarray(cc), jnp.asarray(sl),
                                 jnp.asarray(m.store.trained.numpy()),
                                 *args)
    return tt, tj


def _jax_state(m):
    """The port's store and grid as the JAX package's."""
    store = jc.ClusterStore(**{k: jnp.asarray(v.numpy())
                               for k, v in m.store._asdict().items()})
    return store, jnp.asarray(m.grid.numpy())


def _equal(a, b):
    for x, y, name in zip(a[:4], b[:4], ("f", "g", "vf", "vg")):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("dim,dense", [(2, True), (2, False), (3, False)])
def test_build_neighbor_table_matches_jax(maps, dim, dense):
    m = maps[dim]
    tt, tj = _tables(m, m.cap.nbr_k, dense)
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(tj.keys))
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(tj.packed))
    assert int(tt.n_overflow) == int(tj.n_overflow) == 0
    assert tt.noff == m._noff and int((tt.packed >= 0).sum()) > 0
    # a row of one entry cannot hold the windows: counted, as in JAX
    tt, tj = _tables(m, 1, dense)
    assert int(tt.n_overflow) == int(tj.n_overflow) > 0
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(tj.packed))


@pytest.mark.parametrize("dim,dense", [(2, True), (2, False), (3, False)])
def test_candidates_top3_matches_jax(maps, dim, dense):
    m = maps[dim]
    tt, tj = _tables(m, m.cap.nbr_k, dense)
    kw = m._test_kwargs()
    args = (kw["cell_size"], m.grid_half, m._noff, kw["search_half"], dense)
    q = _queries(dim)
    rt = tc._candidates_top3(tt, torch.as_tensor(q), *args)
    rj = jc._candidates_top3(tj, jnp.asarray(q), *args)
    for a, b, name in zip(rt, rj, ("top_slot", "top_ok", "n_cand")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert int(rt[2].max()) >= 2


@pytest.mark.parametrize("dim,dense", [(2, True), (2, False), (3, False)])
@pytest.mark.parametrize("cached", [True, False])
def test_map_test_table_matches_window(maps, dim, dense, cached):
    """map_test through the table: the window path's results to the last
    bit, with the factor cache and with the per-call factorization."""
    m = maps[dim]
    tt, _ = _tables(m, m.cap.nbr_k, dense)
    q = torch.as_tensor(_queries(dim))
    kw = dict(m._test_kwargs(), factors=m._get_factors() if cached else None)
    _equal(tc.map_test(m.store, m.grid, q, **kw),
           tc.map_test(m.store, m.grid, q, nbrs=tt, nbr_dense=dense, **kw))


def test_table_lookup_rejects_another_window(maps):
    m = maps[3]
    tt, _ = _tables(m, m.cap.nbr_k, False)
    kw = dict(m._test_kwargs(), noff=m._noff + 1)
    with pytest.raises(ValueError, match="noff"):
        tc.map_test(m.store, m.grid, torch.as_tensor(_queries(3)), nbrs=tt,
                    **kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_two_phase_matches_single_phase(maps, dim):
    """two_phase: the single phase's results to the last bit, through the
    window and through the table, and the JAX package's two-phase query
    on the same map at the slice tolerances; n_phase2 equal to JAX's."""
    m = maps[dim]
    q = _queries(dim)
    kw = dict(m._test_kwargs(), factors=m._get_factors())
    one = tc.map_test(m.store, m.grid, torch.as_tensor(q), **kw)
    two = tc.map_test(m.store, m.grid, torch.as_tensor(q), two_phase=True,
                      **kw)
    _equal(one, two)
    assert 0 < int(two[4].n_phase2) < len(q)
    assert int(two[4].n_pairs) < int(one[4].n_pairs)
    tt, _ = _tables(m, m.cap.nbr_k, dim == 2)
    _equal(one, tc.map_test(m.store, m.grid, torch.as_tensor(q), nbrs=tt,
                            nbr_dense=dim == 2, two_phase=True, **kw))

    store, grid = _jax_state(m)
    jkw = m._test_kwargs()
    rj = jc.map_test(store, grid, jnp.asarray(q), two_phase=True, **jkw)
    assert int(rj[4].n_phase2) == int(two[4].n_phase2)
    rt = np.concatenate([two[0][:, None].numpy(), two[1].numpy(),
                         two[2][:, None].numpy(), two[3].numpy()], -1)
    rjn = np.concatenate([np.asarray(rj[0])[:, None], np.asarray(rj[1]),
                          np.asarray(rj[2])[:, None], np.asarray(rj[3])], -1)
    if dim == 2:
        np.testing.assert_allclose(rt, rjn, **TOL)
    else:
        _check_field(rt, rjn)


@pytest.mark.parametrize("dim", [2, 3])
def test_mapper_table_matches_jax(dim, monkeypatch):
    """A tiny mapper with GPISMAP_NBR_TABLE=1 against the JAX package's
    with the same setting: the table is built at test(), dropped by the
    next update's retrain, and the fields agree."""
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    mj, mt = _make(dim, jax=True), _make(dim)
    frames = _frames(dim)
    for f in frames[:-1]:
        mj.update(*f)
        mt.update(*f)
    q = _queries(dim)
    mt.test(q)
    assert mt._nbrs is not None and mt._nbr_dense == (dim == 2)
    mj.update(*frames[-1])
    mt.update(*frames[-1])
    assert mt._nbrs is None
    rt, rj = mt.test(q), mj.test(q)
    assert mt._nbrs is not None and "nbr_overflow" not in mt.stats
    if dim == 2:
        np.testing.assert_allclose(rt, rj, **TOL)
    else:
        _check_field(rt, rj)


def test_loaded_map_rebuilds_its_table(maps, tmp_path, monkeypatch):
    """A map loaded from a checkpoint drops the table it had and builds
    one for its own cells at the next test(), answering as the saved map
    does through the window."""
    from gpismap_tpu_torch.runtime import checkpoint

    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    m = _make(3)
    m.update(*_frames(3)[0])
    q = _queries(3)
    m.test(q)
    assert m._nbrs is not None
    checkpoint.save(maps[3], str(tmp_path / "map.npz"))
    checkpoint.load(m, str(tmp_path / "map.npz"))
    assert m._nbrs is None
    r = m.test(q)
    assert m._nbrs is not None
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "0")
    np.testing.assert_array_equal(r, maps[3].test(q))


def test_table_setting_is_read_at_each_test(maps, monkeypatch):
    """GPISMAP_NBR_TABLE is read at every test(): a built table is
    dropped as soon as the setting is 0 or unset, with the window's
    answers, and built again under 1."""
    m = maps[2]
    q = _queries(2)
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    r1 = m.test(q)
    assert m._nbrs is not None
    for v in ("0", None):
        if v is None:
            monkeypatch.delenv("GPISMAP_NBR_TABLE")
        else:
            monkeypatch.setenv("GPISMAP_NBR_TABLE", v)
        np.testing.assert_array_equal(m.test(q), r1)
        assert m._nbrs is None and not m._use_nbr_table()
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "on")
    np.testing.assert_array_equal(m.test(q), r1)
    assert m._nbrs is not None
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "off")
    m.test(q)
    assert m._nbrs is None


def test_mapper_reports_table_overflow(maps, monkeypatch):
    """A too-small nbr_k shows in stats["nbr_overflow"]."""
    monkeypatch.setenv("GPISMAP_NBR_TABLE", "1")
    m = _make(2, nbr_k=1)
    for f in _frames(2)[:2]:
        m.update(*f)
    m.test(_queries_2d(100))
    assert m.stats["nbr_overflow"] > 0


def test_render_two_phase_matches_single_phase(maps):
    """The 2D march with RenderConfig.two_phase: the same hits, steps and
    depths as the single-phase march."""
    m = maps[2]
    poses = torch_scenes.room_trajectory(3)
    o, d, _ = torch_scenes.beams(torch_scenes.room_plan(), poses, 181)
    o, d = torch.as_tensor(o[::4]), torch.as_tensor(d[::4])
    out = [render.sphere_trace(m.store, m.grid, o, d,
                               render.config_from_mapper(m, two_phase=tp),
                               m._get_factors())
           for tp in (False, True)]
    assert bool(out[0]["hit"].any())
    for key in ("t", "t_hat", "hit", "steps", "var"):
        assert torch.equal(out[0][key], out[1][key]), key
