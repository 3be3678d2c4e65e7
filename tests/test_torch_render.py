"""gpismap_tpu.render vs the PyTorch port's render on the CPU: the
circle-map tests of tests/test_render.py.

The 60-point circle map of tests/test_render.py is built once from the
same index dumps for both packages (tests/torch_render_cases.py); every
JAX result (sphere_trace, jax.grad) is computed once per module (jit
compiles dominate). Depth, hit, position, normal and every gradient of
the port are held to JAX's and to a central difference with the JAX
test's tolerances. The hyperparameter gradients of tests/test_hypergrad.py
are in tests/test_torch_render_hyper.py, the kernels' autograd Functions
in tests/test_torch_render_backward.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch import render  # noqa: E402
from gpismap_tpu_torch.models import cluster  # noqa: E402
from torch_render_cases import (CIRCLE, CPU, GTOL, RAYS3, TOL,  # noqa: E402
                                _cfg, _circle_data, _fd, _fit, _jax,
                                _jax_fit, _rays_circle8)


@pytest.fixture(scope="module")
def circle():
    data, (coords, slots) = _circle_data(**CIRCLE)
    cap = CIRCLE["cap"]
    store = _fit(cap, data, 1.2)
    grid = cluster.build_grid(coords, slots, 2, 128, CPU)
    return dict(cap=cap, data=data, store=store, grid=grid,
                cfg=_cfg(render, cap, 48), coords=coords, slots=slots)


@pytest.fixture(scope="module")
def jax_circle(circle):
    """Every JAX result the circle tests compare with, computed once."""
    jax, jnp, jrender, jcluster = _jax()
    cap, data = circle["cap"], circle["data"]
    store = _jax_fit(cap, data, 1.2)
    grid = jcluster.build_grid(circle["coords"], circle["slots"], 2, 128)
    cfg = _cfg(jrender, cap, 48)
    out = {}
    tr = jrender.sphere_trace(store, grid, jnp.asarray(RAYS3[0]),
                              jnp.asarray(RAYS3[1]), cfg)
    out["trace"] = {k: np.asarray(v) for k, v in tr.items()}

    d1 = jnp.asarray([[-1.0, 0.0]], jnp.float32)

    def depth_of_x0(x0):
        o = jnp.stack([x0, jnp.zeros_like(x0)], -1).reshape(1, 2)
        return jrender.sphere_trace(store, grid, o, d1, cfg)["t"][0]

    out["g_origin"] = float(jax.grad(depth_of_x0)(jnp.float32(3.0)))

    o8, d8 = (jnp.asarray(a) for a in _rays_circle8())

    def loss_full(alpha):
        tr = jrender.sphere_trace(store._replace(alpha=alpha), grid, o8, d8,
                                  cfg)
        return jnp.sum(jnp.where(tr["hit"], tr["t"], 0.0))

    out["g_alpha_full"] = np.asarray(jax.grad(loss_full)(store.alpha))

    o1 = jnp.asarray([[3.0, 0.0]], jnp.float32)

    def depth_of_vals(val):
        st = jcluster.retrain_cells(
            store, jnp.arange(store.trained.shape[0], dtype=jnp.int32),
            store.trained, store.x, store.grad, val, store.sigx,
            store.siggrad, store.valid, cfg.scale)
        return jrender.sphere_trace(st, grid, o1, d1, cfg)["t"][0]

    out["g_val"] = np.asarray(jax.grad(depth_of_vals)(store.val))
    return out


# ---------------------------------------------------------------------------
# tests/test_render.py, mirrored

def test_sphere_trace_hits_circle_like_jax(circle, jax_circle):
    out = render.sphere_trace(circle["store"], circle["grid"],
                              torch.as_tensor(RAYS3[0]),
                              torch.as_tensor(RAYS3[1]), circle["cfg"])
    ref = jax_circle["trace"]
    hit = out["hit"].numpy()
    assert hit.all() and ref["hit"].all()
    np.testing.assert_array_equal(out["steps"].numpy(), ref["steps"])
    for k in ("t", "t_hat", "pos", "normal", "var"):
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k],
                                   err_msg=k, **TOL)
    # the JAX test's own checks: depth to the unit circle, outward normals
    expected = np.linalg.norm(RAYS3[0], axis=1) - 1.0
    np.testing.assert_allclose(out["t"].detach().numpy(), expected,
                               atol=0.05)
    pos = out["pos"].detach().numpy()
    cosang = np.sum(out["normal"].detach().numpy() * pos
                    / np.linalg.norm(pos, axis=1, keepdims=True), axis=1)
    assert np.all(cosang > 0.95)


def test_depth_gradient_wrt_origin_like_jax(circle, jax_circle):
    d = torch.tensor([[-1.0, 0.0]])

    def depth_of_x0(x0):
        o = torch.stack([x0, torch.zeros_like(x0)]).reshape(1, 2)
        return render.sphere_trace(circle["store"], circle["grid"], o, d,
                                   circle["cfg"])["t"][0]

    x0 = torch.tensor(3.0, requires_grad=True)
    (g,) = torch.autograd.grad(depth_of_x0(x0), x0)
    with torch.no_grad():
        fd = float(_fd(depth_of_x0, torch.tensor(3.0), 0.02))
    # moving the origin +dx away adds exactly +dx of depth
    np.testing.assert_allclose(float(g), 1.0, atol=0.05)
    np.testing.assert_allclose(float(g), fd, atol=0.05)
    np.testing.assert_allclose(float(g), jax_circle["g_origin"], **GTOL)


def test_hit_compacted_correction_gradient_matches_full(circle, jax_circle):
    """The correction over the hit rays alone gives the gradient of the
    full sphere_trace's hit-masked loss (and JAX's)."""
    store, grid, cfg = circle["store"], circle["grid"], circle["cfg"]
    o8, d8 = (torch.as_tensor(a) for a in _rays_circle8())
    alpha = store.alpha.clone().requires_grad_()
    out = render.sphere_trace(store._replace(alpha=alpha), grid, o8, d8, cfg)
    (g_full,) = torch.autograd.grad(
        torch.sum(torch.where(out["hit"], out["t"], 0.0)), alpha)
    idx = torch.nonzero(out["hit"]).reshape(-1)
    assert len(idx) >= 8            # the aimed rays all hit
    alpha2 = store.alpha.clone().requires_grad_()
    t, _, _, _ = render.implicit_correct(
        store._replace(alpha=alpha2), grid, o8[idx], d8[idx],
        out["t_hat"][idx], cfg)
    (g_hits,) = torch.autograd.grad(t.sum(), alpha2)
    np.testing.assert_allclose(g_hits.numpy(), g_full.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert g_full.abs().sum() > 0
    np.testing.assert_allclose(g_full.numpy(), jax_circle["g_alpha_full"],
                               **GTOL)


def test_depth_gradient_through_gp_training_like_jax(circle, jax_circle):
    """d depth / d support targets through retrain_cells (the fit's chol
    included) and the corrected march."""
    store, grid, cfg = circle["store"], circle["grid"], circle["cfg"]
    o = torch.tensor([[3.0, 0.0]])
    d = torch.tensor([[-1.0, 0.0]])

    def depth_of_vals(val):
        st = cluster.retrain_cells(
            store, torch.arange(store.trained.shape[0], dtype=torch.int32),
            store.trained, store.x, store.grad, val, store.sigx,
            store.siggrad, store.valid, cfg.scale)
        return render.sphere_trace(st, grid, o, d, cfg)["t"][0]

    val = store.val.clone().requires_grad_()
    (g,) = torch.autograd.grad(depth_of_vals(val), val)
    gn = g.numpy()
    assert np.isfinite(gn).all() and np.abs(gn).sum() > 0.0
    np.testing.assert_allclose(gn, jax_circle["g_val"], **GTOL)
    i = np.unravel_index(np.abs(gn).argmax(), gn.shape)
    h = 1e-3
    with torch.no_grad():
        vp, vm = store.val.clone(), store.val.clone()
        vp[i] += h
        vm[i] -= h
        fd = float((depth_of_vals(vp) - depth_of_vals(vm)) / (2 * h))
    np.testing.assert_allclose(gn[i], fd, rtol=0.1, atol=1e-3)
