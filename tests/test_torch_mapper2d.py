"""PyTorch port vs the JAX package: the 1D observation GP and the 2D
mapper's per-frame stages (re-evaluation and new measurements).

Scans come from numpy (tests/torch_scenes.py and fixed walls); both
packages run on the CPU in float32. Actions must match exactly, floats
to rounding-order tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_scenes  # noqa: E402
from gpismap_tpu import config as jcfg  # noqa: E402
from gpismap_tpu.api import GPisMap2D as JaxMapper  # noqa: E402
from gpismap_tpu.models import mapper2d as jm  # noqa: E402
from gpismap_tpu.models import obsgp as jo  # noqa: E402
from gpismap_tpu_torch import GPisMap2D, MAPPER_2D, OBSGP_1D  # noqa: E402
from gpismap_tpu_torch.models import mapper2d as tm  # noqa: E402
from gpismap_tpu_torch.models import obsgp as to  # noqa: E402

IDENTITY = np.array([0, 0, 1, 0, 0, 1], np.float32)


def _wall_scan(r):
    # r stays off the quadtree's cell-boundary lattice (multiples of
    # min_halfleng), where the reference's strict containsPoint rejects
    # inserts (quadtree.h:93-98)
    th = np.linspace(-0.6, 0.6, 181).astype(np.float32)
    return th, np.full_like(th, r), IDENTITY


def _padded(th, rg, pose):
    nb = 1 << max(6, (len(th) - 1).bit_length())
    th_p = np.zeros(nb, np.float32)
    rg_p = np.zeros(nb, np.float32)
    th_p[:len(th)] = th
    rg_p[:len(rg)] = rg
    tr = pose[:2].astype(np.float32)
    rot = pose[2:6].reshape(2, 2, order="F").astype(np.float32)
    return th_p, rg_p, tr, rot, nb // OBSGP_1D.group_size + 2


def _obs_both(th, rg, pose):
    th_p, rg_p, tr, rot, g_max = _padded(th, rg, pose)
    pj = jm.preprocess_2d(jnp.asarray(th_p), jnp.asarray(rg_p),
                          jnp.asarray(tr), jnp.asarray(rot), jcfg.MAPPER_2D)
    oj = jo.fit_obsgp1d(pj.theta, pj.f, pj.valid, jcfg.OBSGP_1D, g_max=g_max)
    pt = tm.preprocess_2d(torch.as_tensor(th_p), torch.as_tensor(rg_p),
                          torch.as_tensor(tr), torch.as_tensor(rot),
                          MAPPER_2D)
    ot = to.fit_obsgp1d(pt.theta, pt.f, pt.valid, OBSGP_1D, g_max=g_max)
    return (pj, oj), (pt, ot), (tr, rot)


# The normals are finite differences over delx = 0.01 m of the occupancy
# proxy (GPisMap.cpp:317-345): a 6e-8 rounding difference of the
# observation GP's mean becomes ~1e-4 in the normalized direction, so
# normals get 1e-3 and everything else 1e-4.
GRAD_TOL = 1e-3


def _close(a, b, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol,
                               atol=atol, err_msg=msg)


SCANS = {
    "room": lambda: torch_scenes.room_frames(1, 181)[0],
    "wall": lambda: _wall_scan(2.03),
    "gappy": lambda: (_wall_scan(3.07)[0],
                      np.where(np.arange(181) % 17 < 5, 0.0, 3.07)
                      .astype(np.float32), IDENTITY),
}


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_fit_obsgp1d_and_test_match_jax(scan):
    th, rg, pose = SCANS[scan]()
    (pj, oj), (pt, ot), _ = _obs_both(th, rg, pose)
    np.testing.assert_array_equal(np.asarray(oj.trained),
                                  ot.trained.numpy())
    np.testing.assert_array_equal(np.asarray(oj.valid), ot.valid.numpy())
    assert bool(oj.any_trained) == bool(ot.any_trained)
    _close(oj.bounds, ot.bounds, 0, 0, "bounds")
    _close(oj.alpha, ot.alpha, msg="alpha")
    _close(oj.linv, ot.linv, msg="linv")
    # queries: on the beams (boundary-coincident ones get the sentinel),
    # between them, and outside the scan
    q = np.concatenate([th, th[:-1] + 0.5 * np.diff(th),
                        [-3.0, -0.61, 0.61, 3.0]]).astype(np.float32)
    mj, vj = jo.obsgp1d_test(oj, jnp.asarray(q), jcfg.OBSGP_1D)
    mt, vt = to.obsgp1d_test(ot, torch.as_tensor(q), OBSGP_1D)
    np.testing.assert_array_equal(np.asarray(vj) == 1e6, vt.numpy() == 1e6)
    _close(mj, mt, msg="mean")
    _close(vj, vt, msg="var")


def _nodes_after(scan):
    """In-view node data after one JAX mapper update on `scan`, padded
    to a pow2 like the mapper does."""
    m = JaxMapper()
    m.update(*scan)
    d = m.index.dump_nodes()
    ids = np.nonzero(d["alive"])[0]
    k = 1 << max(0, (len(ids) - 1).bit_length())
    out = {}
    for name in ("pos", "grad", "pos_sig", "grad_sig"):
        a = np.zeros((k,) + d[name].shape[1:], np.float32)
        a[:len(ids)] = d[name][ids]
        out[name] = a
    out["valid"] = np.arange(k) < len(ids)
    return out


REEVAL = {
    # far rescan saturates the occupancy proxy: action 1 (noise doubling)
    "far_wall": (lambda: _wall_scan(2.03), lambda: _wall_scan(8.07), 1),
    # a slightly moved wall: nodes relocalize and re-insert (action 3)
    "moved_wall": (lambda: _wall_scan(2.03), lambda: _wall_scan(2.11), 3),
    "room": (lambda: torch_scenes.room_frames(2, 181)[0],
             lambda: torch_scenes.room_frames(2, 181)[1], None),
}


@pytest.mark.parametrize("case", sorted(REEVAL))
def test_reeval_2d_matches_jax(case):
    first, second, expect = REEVAL[case]
    nodes = _nodes_after(first())
    (_, oj), (_, ot), (tr, rot) = _obs_both(*second())
    names = ("pos", "grad", "pos_sig", "grad_sig", "valid")
    rj = jm.reeval_2d(oj, *(jnp.asarray(nodes[k]) for k in names),
                      jnp.asarray(tr), jnp.asarray(rot), jcfg.MAPPER_2D,
                      jcfg.OBSGP_1D)
    rt = tm.reeval_2d(ot, *(torch.as_tensor(nodes[k]) for k in names),
                      torch.as_tensor(tr), torch.as_tensor(rot), MAPPER_2D,
                      OBSGP_1D)
    act = np.asarray(rj.action)
    np.testing.assert_array_equal(act, rt.action.numpy())
    assert rt.action.dtype == torch.int32
    if expect is not None:
        frac = np.mean(act[nodes["valid"]] == expect)
        assert frac >= 0.5, f"only {frac:.2f} of nodes took action {expect}"
    # doubled noises stay floats (GPisMap.cpp:354-357)
    _close(rj.dbl_pos_sig, rt.dbl_pos_sig, 0, 0)
    _close(rj.dbl_grad_sig, rt.dbl_grad_sig, 0, 0)
    upd = act == 3
    for f in ("pos", "grad", "noise", "grad_noise"):
        tol = GRAD_TOL if f == "grad" else 1e-4
        _close(np.asarray(getattr(rj, f))[upd], getattr(rt, f)[upd],
               tol, tol, f)


@pytest.mark.parametrize("scan", sorted(SCANS))
def test_newmeas_2d_matches_jax(scan):
    th, rg, pose = SCANS[scan]()
    (pj, oj), (pt, ot), (_, rot) = _obs_both(th, rg, pose)
    _close(pj.xy_global, pt.xy_global, 1e-6, 1e-6, "xy_global")
    nj = jm.newmeas_2d(oj, pj, jnp.asarray(rot), jcfg.MAPPER_2D,
                       jcfg.OBSGP_1D)
    nt = tm.newmeas_2d(ot, pt, torch.as_tensor(rot), MAPPER_2D, OBSGP_1D)
    ok = np.asarray(nj.insert_ok)
    np.testing.assert_array_equal(ok, nt.insert_ok.numpy())
    assert ok.any()
    for f in ("pos", "grad", "noise", "grad_noise"):
        tol = GRAD_TOL if f == "grad" else 1e-4
        _close(np.asarray(getattr(nj, f))[ok], getattr(nt, f)[ok], tol, tol,
               f)


def _all_node_ids(index):
    cells = index.all_cluster_cells()
    return np.unique(np.concatenate([index.cell_nodes(c) for c in cells])
                     ).astype(np.int32)


@pytest.mark.parametrize("mode", ["update", "update_batch"])
def test_action1_doubles_node_noises(mode):
    """The port's update path applies action 1 as an exact 2x of both
    noises (mirrors tests/test_reeval_actions.py)."""
    m = GPisMap2D(device="cpu")
    m.update(*_wall_scan(2.03))
    ids = _all_node_ids(m.index)
    before = m.index.get_nodes(ids)
    ps0, gs0 = before["pos_sig"].copy(), before["grad_sig"].copy()
    assert np.all(ps0 > 0) and np.all(ps0 < 0.5)
    if mode == "update":
        m.update(*_wall_scan(8.07))
    else:
        m.update_batch([_wall_scan(8.07)])
    d = m.index.get_nodes(ids)
    assert d["alive"].all()
    doubled = (np.isclose(d["pos_sig"], 2 * ps0, rtol=1e-6)
               & np.isclose(d["grad_sig"], 2 * gs0, rtol=1e-6))
    unchanged = (d["pos_sig"] == ps0) & (d["grad_sig"] == gs0)
    assert np.all(doubled | unchanged)
    assert doubled.mean() >= 0.5
