"""gpismap_tpu.render vs the PyTorch port's render on the CPU: the
hyperparameter gradients of tests/test_hypergrad.py (single device).

The 40-point circle map of tests/test_hypergrad.py is built once from the
same index dumps for both packages (tests/torch_render_cases.py); every
JAX gradient is computed once per module (jit compiles dominate). Each
gradient of the port is held to JAX's and to a central difference with
the JAX test's tolerances. The circle-map tests of tests/test_render.py
are in tests/test_torch_render.py, the Functions' backwards in
tests/test_torch_render_backward.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch import render  # noqa: E402
from gpismap_tpu_torch.models import cluster  # noqa: E402
from torch_render_cases import (CPU, GTOL, HYPER, Q_HYPER,  # noqa: E402
                                RAYS_HYPER, _cfg, _circle_data, _fd, _fit,
                                _jax, _jax_fit)


@pytest.fixture(scope="module")
def hyper_map():
    data, (coords, slots) = _circle_data(**HYPER)
    return dict(cap=HYPER["cap"], data=data,
                grid=cluster.build_grid(coords, slots, 2, 128, CPU),
                cfg=_cfg(render, HYPER["cap"], 24), coords=coords,
                slots=slots)


@pytest.fixture(scope="module")
def jax_hyper(hyper_map):
    jax, jnp, jrender, jcluster = _jax()
    cap, data = hyper_map["cap"], hyper_map["data"]
    grid = jcluster.build_grid(hyper_map["coords"], hyper_map["slots"], 2,
                               128)
    cfg = _cfg(jrender, cap, 24)
    q = jnp.asarray(Q_HYPER)

    def loss_scale(s):
        f, _, vf = jrender.sdf_eval(_jax_fit(cap, data, s), grid, q, cfg,
                                    hyper=jrender.hyper_from_scale(s, 2))
        return jnp.sum(f) + jnp.sum(vf)

    def loss_noise(nb):
        s = jnp.asarray(1.2, jnp.float32)
        f, _, vf = jrender.sdf_eval(_jax_fit(cap, data, s, nb), grid, q, cfg,
                                    hyper=jrender.hyper_from_scale(s, 2))
        return jnp.sum(f) + jnp.sum(vf)

    o, d = (jnp.asarray(a) for a in RAYS_HYPER)
    base = jrender.sphere_trace(_jax_fit(cap, data, jnp.float32(1.2)), grid,
                                o, d, cfg)
    w = base["hit"].astype(jnp.float32)

    def depth_loss(s):
        tr = jrender.sphere_trace(_jax_fit(cap, data, s), grid, o, d, cfg,
                                  hyper=jrender.hyper_from_scale(s, 2))
        return jnp.sum(tr["t"] * w)

    return dict(
        g_scale=float(jax.grad(loss_scale)(jnp.float32(1.2))),
        g_noise=float(jax.grad(loss_noise)(jnp.float32(0.0))),
        g_depth_scale=float(jax.grad(depth_loss)(jnp.float32(1.2))),
        hit=np.asarray(base["hit"]))


# ---------------------------------------------------------------------------
# tests/test_hypergrad.py (single device), mirrored

def _check_fd(fn, x0, h, rtol=0.05, atol=2e-2):
    """(gradient, central difference) of scalar fn at x0, within the JAX
    test's tolerance of each other."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(fn(x), x)
    with torch.no_grad():
        fd = float(_fd(fn, torch.tensor(x0, dtype=torch.float32), h))
    g = float(g)
    assert np.isfinite(g), g
    assert abs(g - fd) < max(rtol * abs(fd), atol), (g, fd)
    return g


def test_sdf_grad_wrt_scale_and_noise(hyper_map, jax_hyper):
    """d posterior-SDF / d scale and / d noise through the fit, the
    per-call factorization (chol, linv) and the tile evaluation."""
    cap, data, grid, cfg = (hyper_map[k] for k in ("cap", "data", "grid",
                                                   "cfg"))
    q = torch.as_tensor(Q_HYPER)

    def loss_scale(s):
        f, _, vf = render.sdf_eval(_fit(cap, data, s), grid, q, cfg,
                                   hyper=render.hyper_from_scale(s, 2))
        return torch.sum(f) + torch.sum(vf)

    g = _check_fd(loss_scale, 1.2, 0.02)
    assert abs(g) > 1e-3, "scale gradient should be non-trivial"
    np.testing.assert_allclose(g, jax_hyper["g_scale"], **GTOL)

    def loss_noise(nb):
        s = torch.tensor(1.2)
        f, _, vf = render.sdf_eval(_fit(cap, data, s, nb), grid, q, cfg,
                                   hyper=render.hyper_from_scale(s, 2))
        return torch.sum(f) + torch.sum(vf)

    g = _check_fd(loss_noise, 0.0, 5e-3)
    assert abs(g) > 1e-3, "noise gradient should be non-trivial"
    np.testing.assert_allclose(g, jax_hyper["g_noise"], **GTOL)


def test_render_depth_grad_wrt_scale(hyper_map, jax_hyper):
    """d rendered depth / d scale through the march and the implicit
    correction (the north-star hyperparameter-gradient path)."""
    cap, data, grid, cfg = (hyper_map[k] for k in ("cap", "data", "grid",
                                                   "cfg"))
    o, d = (torch.as_tensor(a) for a in RAYS_HYPER)
    base = render.sphere_trace(_fit(cap, data, torch.tensor(1.2)), grid, o,
                               d, cfg)
    np.testing.assert_array_equal(base["hit"].numpy(), jax_hyper["hit"])
    w = base["hit"].to(torch.float32)
    assert float(w.sum()) >= 2, "rays must hit the circle"

    def depth_loss(s):
        tr = render.sphere_trace(_fit(cap, data, s), grid, o, d, cfg,
                                 hyper=render.hyper_from_scale(s, 2))
        return torch.sum(tr["t"] * w)

    g = _check_fd(depth_loss, 1.2, 0.02)
    np.testing.assert_allclose(g, jax_hyper["g_depth_scale"], **GTOL)
