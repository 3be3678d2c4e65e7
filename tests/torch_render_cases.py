"""What the port's render test files share (tests/test_torch_render.py,
tests/test_torch_render_hyper.py; not a test file): the 60-point circle
map of tests/test_render.py and the 40-point one of
tests/test_hypergrad.py as index dumps, the fits and render settings of
both packages on them, the rays and query points, and the tolerances.
JAX is imported only by the helpers that run it (_jax, _jax_fit)."""
import numpy as np
import pytest
import torch

from gpismap_tpu_torch import TREE_2D, CapacityParam
from gpismap_tpu_torch.models import cluster
from gpismap_tpu_torch.runtime.index import SpatialIndex

CPU = torch.device("cpu")
# port vs JAX on the same f32 map: rounding order only (PARITY.md)
TOL = dict(rtol=1e-4, atol=1e-4)
# port vs JAX gradients: f32 through a Cholesky fit and a tile evaluation
# whose sums run in other orders
GTOL = dict(rtol=1e-3, atol=1e-5)
# circle map of tests/test_render.py; hypergrad map of test_hypergrad.py
CIRCLE = dict(n=60, cap=dict(gp_support=32, retrain_batch=16, max_cells=128,
                             max_nodes=1024, test_tile=32,
                             test_active_cells=32, max_beams=64))
HYPER = dict(n=40, cap=dict(gp_support=16, retrain_batch=8, max_cells=64,
                            max_nodes=512, test_tile=16, test_active_cells=16,
                            max_beams=64))


def _circle_data(n, cap):
    """Index dumps of n points on the unit circle: the retrain batch
    (numpy) and the cluster grid's cell coords and slots."""
    idx = SpatialIndex(2, TREE_2D, max_slots=cap["max_cells"])
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    ids = idx.try_insert(pts)
    ok = ids >= 0
    normals = pts[ok] / np.linalg.norm(pts[ok], axis=1, keepdims=True)
    idx.set_node_data(ids[ok], np.full(ok.sum(), -0.2, np.float32),
                      np.full(ok.sum(), 0.02, np.float32), normals,
                      np.full(ok.sum(), 0.02, np.float32))
    rt = idx.collect_retrain(4.0, cap["gp_support"], cap["max_cells"])
    d = idx.dump_nodes()
    sup = rt["support"]
    supc = np.clip(sup, 0, None)
    centers, _, slots = idx.cell_info(idx.all_cluster_cells())
    return dict(slots=rt["slots"], slot_ok=rt["slots"] >= 0,
                x=d["pos"][supc], grad=d["grad"][supc], val=d["val"][supc],
                sigx=d["pos_sig"][supc], siggrad=d["grad_sig"][supc],
                valid=sup >= 0), (np.floor(centers / 1.6).astype(np.int64),
                                  slots)


def _cfg(mod, cap, n_steps):
    return mod.RenderConfig(
        cell_size=1.6, grid_half=128, noff=4, search_half=4.8, scale=1.2,
        val_const=1.01, grad_const=3.0 / 1.44 + 0.1, var_thre=0.4,
        default_var=1.01, tile=cap["test_tile"], max_cells=cap["max_cells"],
        max_active=cap["test_active_cells"], fbias=0.2, n_steps=n_steps,
        eps=1e-3, t_max=6.0)


def _jax():
    """(jax, jax.numpy, gpismap_tpu.render, gpismap_tpu.models.cluster)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu import render as jrender
    from gpismap_tpu.models import cluster as jcluster
    return jax, jnp, jrender, jcluster


def _jax_fit(cap, data, scale, noise=0.0):
    from gpismap_tpu.config import CapacityParam as JaxCapacity
    _, jnp, _, jcluster = _jax()
    a = {k: jnp.asarray(v) for k, v in data.items()}
    return jcluster.retrain_cells(
        jcluster.make_store(JaxCapacity(**cap), 2), a["slots"], a["slot_ok"],
        a["x"], a["grad"], a["val"], a["sigx"] + noise,
        a["siggrad"] + noise, a["valid"], scale)


def _fit(cap, data, scale, noise=0.0, val=None):
    a = {k: torch.as_tensor(v) for k, v in data.items()}
    return cluster.retrain_cells(
        cluster.make_store(CapacityParam(**cap), 2, CPU), a["slots"],
        a["slot_ok"], a["x"], a["grad"], a["val"] if val is None else val,
        a["sigx"] + noise, a["siggrad"] + noise, a["valid"], scale)


def _rays_circle8():
    """8 rays aimed at the circle and 2 pointing away from it."""
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False).astype(np.float32)
    o = np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang)], -1)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    return (np.concatenate([o, o[:2]], 0).astype(np.float32),
            np.concatenate([d, -d[:2]], 0).astype(np.float32))


def _aim(o):
    o = np.asarray(o, np.float32)
    return o, (-o / np.linalg.norm(o, axis=1, keepdims=True)).astype(
        np.float32)


RAYS3 = _aim([[3.0, 0.0], [0.0, 2.5], [-2.0, -2.0]])
RAYS_HYPER = _aim([[3.0, 0.0], [0.0, 3.0], [-2.5, -1.0]])
Q_HYPER = np.array([[1.5, 0.0], [0.0, 0.7], [-1.2, 0.4]], np.float32)


def _fd(fn, x0, h):
    return (fn(x0 + h) - fn(x0 - h)) / (2 * h)
