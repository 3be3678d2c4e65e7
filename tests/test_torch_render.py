"""gpismap_tpu.render vs the PyTorch port's render on the CPU, and the
port's autograd Functions of the three kernels.

The 60-point circle map of tests/test_render.py and the 40-point one of
tests/test_hypergrad.py are built once from the same index dumps for both
packages; every JAX result (sphere_trace, jax.grad) is computed once per
module (jit compiles dominate). Depth, hit, position, normal and every
gradient of the port are held to JAX's and to a central difference with
the JAX tests' tolerances. The Functions' backward formulas are checked
against torch.autograd through the plain versions in float64; the
Functions themselves on the card by the `cuda` tests. JAX is imported by
the fixtures that compute its results, so that the CUDA tests also run on
a GPU host without jax.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch import TREE_2D, CapacityParam  # noqa: E402
from gpismap_tpu_torch import render  # noqa: E402
from gpismap_tpu_torch.models import cluster  # noqa: E402
from gpismap_tpu_torch.ops import chol as chol_ops  # noqa: E402
from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402
from gpismap_tpu_torch.runtime.index import SpatialIndex  # noqa: E402

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


# ---------------------------------------------------------------------------
# the autograd Functions' backward formulas, float64

def _spd(b, n, seed, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((b, n, n), generator=g, dtype=dtype) / n ** 0.5
    return a @ a.mT + 2.0 * torch.eye(n, dtype=dtype)


@pytest.mark.parametrize("n", [5, 40])
def test_chol_backward_matches_autograd(n):
    k = _spd(3, n, seed=n).requires_grad_()
    l = chol_ops.chol_reference(k)
    gl = torch.randn(l.shape, dtype=l.dtype,
                     generator=torch.Generator().manual_seed(1))
    (want,) = torch.autograd.grad(l, k, gl)
    ld = l.detach()
    got = chol_ops.chol_backward(ld, chol_ops.linv_reference(ld), gl)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got, got.mT, rtol=0, atol=0)


@pytest.mark.parametrize("n", [5, 40])
def test_linv_backward_matches_autograd(n):
    l = torch.linalg.cholesky(_spd(3, n, seed=n + 1)).requires_grad_()
    x = chol_ops.linv_reference(l)
    gx = torch.randn(x.shape, dtype=x.dtype,
                     generator=torch.Generator().manual_seed(2))
    (want,) = torch.autograd.grad(x, l, gx)
    got = chol_ops.linv_backward(x.detach(), gx)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def _tile_case(d, seed, dtype=torch.float64):
    """A small tile problem of a real cluster fit: S cells of M support
    nodes, NT tiles of T queries, one inactive tile, float64."""
    rng = np.random.default_rng(seed)
    s, m, nt, t = 3, 6, 5, 4
    x = rng.uniform(-1, 1, (s, m, d))
    valid = rng.uniform(size=(s, m)) > 0.2
    grad = rng.normal(size=(s, m, d))
    grad[:, 0] = 0.0                        # no gradient rows at node 0
    sigx = np.full((s, m), 0.02)
    siggrad = np.full((s, m), 0.02)
    tt = {k: torch.as_tensor(v) for k, v in dict(
        x=x, valid=valid, grad=grad, sigx=sigx, siggrad=siggrad).items()}
    from gpismap_tpu_torch.ops import gp, kernels
    gf, sx = gp.ongpis_prepare(tt["grad"], tt["sigx"], tt["siggrad"],
                               tt["valid"])
    k = kernels.matern32_deriv_train_cov(tt["x"], sx, tt["siggrad"], gf,
                                         tt["valid"], 1.2)
    linv = chol_ops.linv_reference(torch.linalg.cholesky(k))
    seg = torch.tensor([0, 2, -1, 1, 2], dtype=torch.int32)
    q = torch.as_tensor(rng.uniform(-1.2, 1.2, (nt, d, t)))
    alpha = torch.as_tensor(rng.normal(size=(s, m * (1 + d))))
    return (seg, linv.to(dtype), tt["x"].transpose(-1, -2).contiguous(),
            alpha, gf.to(dtype), tt["valid"].to(dtype), q.to(dtype))


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("chunk_tiles", [0, 2])
def test_tile_eval_backward_matches_autograd(d, chunk_tiles, monkeypatch):
    """tile_eval_backward (the tile Function's backward) vs autograd
    through the plain version, with tensor hyperparameters, in one chunk
    and in chunks of 2 tiles; the inactive tile's upstream gradient holds
    NaN, as the kernel's unwritten outputs may, and must not reach any
    input."""
    seg, linv, xt, alpha, gf, vl, qt = _tile_case(d, seed=d)
    if chunk_tiles:
        monkeypatch.setattr(tile_ops, "_BACKWARD_CHUNK_BYTES",
                            chunk_tiles * linv[0].numel()
                            * linv.element_size())
    hyper = [torch.tensor(v, dtype=torch.float64) for v in (1.2, 1.01,
                                                            2.2)]
    leaves = [a.clone().requires_grad_() for a in (linv, xt, alpha, qt)]
    hl = [h.clone().requires_grad_() for h in hyper]
    out = tile_ops.tile_eval_reference(seg, leaves[0], leaves[1], leaves[2],
                                       gf, vl, leaves[3], d, *hl)
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(o.shape, dtype=o.dtype, generator=gen)
             for o in out]
    want = torch.autograd.grad(out, leaves + hl, grads)
    for g in grads:
        g[2] = torch.nan                    # tile 2 is inactive
    got = tile_ops.tile_eval_backward(seg, linv, xt, alpha, gf, vl, qt, d,
                                      *hyper, grads)
    for name, a, b in zip(("linv", "xt", "alpha", "qt", "scale",
                           "val_const", "grad_const"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)
    assert float(got[0].abs().sum()) > 0 and float(got[4].abs()) > 0
    # float hyperparameters get no gradient, nor inputs not asked for
    got = tile_ops.tile_eval_backward(seg, linv, xt, alpha, gf, vl, qt, d,
                                      1.2, 1.01, 2.2, grads,
                                      needs=(False, True, False, True) + (
                                          True,) * 3)
    assert got[0] is None and got[2] is None
    assert got[4:] == (None, None, None)
    torch.testing.assert_close(got[1], want[1], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got[3], want[3], rtol=1e-10, atol=1e-10)


def test_functions_route_gradients_through_their_backward(monkeypatch):
    """_Chol, _Linv and _TileEval wired on the CPU with their launches
    stood in by the plain versions: the gradients of each input reach
    the right slot, through the closed forms and the recompute."""
    calls = []

    def fake_factor(name, x):
        calls.append(name)
        f = (chol_ops.chol_reference if name == "chol"
             else chol_ops.linv_reference)
        return f(x), True

    def fake_tile(*args):
        calls.append("tile")
        return tile_ops.tile_eval_reference(*args)

    monkeypatch.setattr(chol_ops, "_launch", fake_factor)
    monkeypatch.setattr(tile_ops, "_launch", fake_tile)
    k = _spd(2, 12, seed=5).requires_grad_()
    gw = torch.randn((2, 12, 12), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(6))
    (got,) = torch.autograd.grad(chol_ops._Linv.apply(chol_ops._Chol.apply(k)),
                                 k, gw)
    (want,) = torch.autograd.grad(
        chol_ops.linv_reference(chol_ops.chol_reference(k)), k, gw)
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
    # on the CPU the chol backward's L^-1 comes from the plain linv
    assert calls == ["chol", "linv"]

    seg, linv, xt, alpha, gf, vl, qt = _tile_case(3, seed=7)
    leaves = [a.clone().requires_grad_() for a in (linv, xt, alpha, qt)]
    scale = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    outs = [tile_ops._TileEval.apply(seg, leaves[0], leaves[1], leaves[2],
                                     gf, vl, leaves[3], 3, scale, 1.001,
                                     1875.0),
            tile_ops.tile_eval_reference(seg, leaves[0], leaves[1],
                                         leaves[2], gf, vl, leaves[3], 3,
                                         scale, 1.001, 1875.0)]
    act = seg >= 0
    grads = []
    for out in outs:
        loss = sum((o[act] * (i + 1)).sum() for i, o in enumerate(out))
        grads.append(torch.autograd.grad(loss, leaves + [scale]))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert calls[-1] == "tile"


# ---------------------------------------------------------------------------
# the Functions on the card

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; the Functions' backward "
                    "formulas are checked on the CPU above")


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [96, 384, 1280])
def test_cuda_factor_functions_match_autograd_of_plain(n):
    """chol and linv on the card: non-zero gradients within 1e-3 of
    autograd through chol_reference and linv_reference."""
    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(n)
    a = torch.randn((8, n, n), generator=g, device="cuda") / n ** 0.5
    k0 = (a @ a.mT + 2.0 * torch.eye(n, device="cuda")).contiguous()
    gw = torch.randn((8, n, n), generator=g, device="cuda")
    n0 = chol_ops.chol_launches
    k = k0.clone().requires_grad_()
    (got,) = torch.autograd.grad(chol_ops.linv(chol_ops.chol(k)), k, gw)
    assert chol_ops.chol_launches == n0 + 1
    k = k0.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        chol_ops.linv_reference(chol_ops.chol_reference(k)), k, gw)
    assert float(got.abs().max()) > 0
    assert _rel(got, want) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_tile_function_matches_autograd_of_plain(d):
    """tile_eval on the card: non-zero gradients of linv, xt, alpha, qt and
    the tensor hyperparameters within 1e-3 of autograd through
    tile_eval_reference (inactive tiles masked out of the loss)."""
    _need_cuda()
    seg, linv, xt, alpha, gf, vl, qt = (
        a.to("cuda", torch.float32).contiguous() if a.is_floating_point()
        else a.cuda() for a in _tile_case(d, seed=11, dtype=torch.float32))
    hyper = [torch.tensor(v, device="cuda") for v in (1.2, 1.01, 2.2)]
    act = seg >= 0
    grads = []
    for fn in (tile_ops.tile_eval, tile_ops.tile_eval_reference):
        leaves = [x.clone().requires_grad_() for x in (linv, xt, alpha, qt)]
        hl = [h.clone().requires_grad_() for h in hyper]
        out = fn(seg, leaves[0], leaves[1], leaves[2], gf, vl, leaves[3], d,
                 *hl)
        loss = sum((o[act] * (i + 1)).sum() for i, o in enumerate(out))
        grads.append(torch.autograd.grad(loss, leaves + hl))
    for a, b in zip(*grads):
        assert float(b.abs().max()) > 0
        assert _rel(a, b) < 1e-3
