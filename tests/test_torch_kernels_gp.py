"""PyTorch port vs the JAX package: covariance functions and GP fits.

Same inputs (numpy, from a seed) through gpismap_tpu.ops and
gpismap_tpu_torch.ops on the CPU, in float32. Tolerances allow only
rounding-order differences.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from gpismap_tpu.ops import gp as jgp  # noqa: E402
from gpismap_tpu.ops import kernels as jk  # noqa: E402
from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402
from gpismap_tpu_torch.ops import kernels as tk  # noqa: E402


def _nodes(rng, b, m, d, frac_invalid=0.2):
    """A batch of masked cluster-GP support sets with some no-gradient
    nodes (high gradient noise or zero gradient)."""
    x = rng.uniform(-1, 1, (b, m, d)).astype(np.float32)
    grad = rng.normal(size=(b, m, d)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    grad[rng.uniform(size=(b, m)) < 0.1] = 0.0
    siggrad = np.where(rng.uniform(size=(b, m)) < 0.3, 0.3,
                       rng.uniform(0.02, 0.09, (b, m))).astype(np.float32)
    sigx = rng.uniform(0.01, 0.1, (b, m)).astype(np.float32)
    val = (rng.normal(size=(b, m)) * 0.2).astype(np.float32)
    valid = rng.uniform(size=(b, m)) > frac_invalid
    return x, grad, val, sigx, siggrad, valid


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["ou_train", "ou_cross", "matern_train",
                                  "matern_cross"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_covariance_functions_match_jax(kind, d):
    rng = np.random.default_rng(10 + d)
    x, grad, _, sigx, siggrad, valid = _nodes(rng, 3, 9, d)
    xt = rng.uniform(-1, 1, (3, 5, d)).astype(np.float32)
    gradflag = valid & (siggrad <= 0.1001)
    J = {k: jnp.asarray(v) for k, v in dict(
        x=x, xt=xt, sigx=sigx, siggrad=siggrad, valid=valid,
        gradflag=gradflag).items()}
    T = {k: torch.as_tensor(np.asarray(v)) for k, v in J.items()}
    if kind == "ou_train":
        a = jk.ou_train_cov(J["x"], J["sigx"], J["valid"], 0.5)
        b = tk.ou_train_cov(T["x"], T["sigx"], T["valid"], 0.5)
    elif kind == "ou_cross":
        a = jk.ou_cross_cov(J["x"], J["valid"], J["xt"], 0.5)
        b = tk.ou_cross_cov(T["x"], T["valid"], T["xt"], 0.5)
    elif kind == "matern_train":
        a = jk.matern32_deriv_train_cov(J["x"], J["sigx"], J["siggrad"],
                                        J["gradflag"], J["valid"], 1.2)
        b = tk.matern32_deriv_train_cov(T["x"], T["sigx"], T["siggrad"],
                                        T["gradflag"], T["valid"], 1.2)
    else:
        a = jk.matern32_deriv_cross_cov(J["x"], J["gradflag"], J["valid"],
                                        J["xt"], 1.2)
        b = tk.matern32_deriv_cross_cov(T["x"], T["gradflag"], T["valid"],
                                        T["xt"], 1.2)
    assert tuple(a.shape) == tuple(b.shape)
    _close(a, b, 1e-5, 1e-6)


def test_matern_train_masking_and_2d_diagonal_quirk():
    """Masked rows are exact identity rows, and the 2D x-gradient
    diagonal is a^2 + sqrt(sigx*siggrad) (covFnc.cpp:352)."""
    rng = np.random.default_rng(3)
    x, _, _, sigx, siggrad, valid = _nodes(rng, 1, 6, 2, frac_invalid=0.3)
    gradflag = valid & (siggrad <= 0.1001)
    k = tk.matern32_deriv_train_cov(
        torch.as_tensor(x), torch.as_tensor(sigx), torch.as_tensor(siggrad),
        torch.as_tensor(gradflag), torch.as_tensor(valid), 1.2)[0].numpy()
    rowmask = np.concatenate([valid[0], gradflag[0], gradflag[0]])
    for i in np.nonzero(~rowmask)[0]:
        row = k[i].copy()
        assert row[i] == 1.0
        row[i] = 0.0
        assert np.all(row == 0.0)
    a2 = 3.0 / 1.44
    for i in np.nonzero(gradflag[0])[0]:
        np.testing.assert_allclose(
            k[6 + i, 6 + i], a2 + np.sqrt(sigx[0, i] * siggrad[0, i]),
            rtol=1e-6)
        np.testing.assert_allclose(k[12 + i, 12 + i], a2 + siggrad[0, i],
                                   rtol=1e-6)


def test_matern_cross_cov_coincident_points_are_finite():
    """The safe 1/r at r == 0 (kernels.py:82): a query on a support node
    gives finite entries, equal to JAX's."""
    x = np.array([[[0.3, -0.2], [1.0, 0.5]]], np.float32)
    xt = x[:, :1].copy()
    ones = np.ones((1, 2), bool)
    a = jk.matern32_deriv_cross_cov(jnp.asarray(x), jnp.asarray(ones),
                                    jnp.asarray(ones), jnp.asarray(xt), 1.2)
    b = tk.matern32_deriv_cross_cov(torch.as_tensor(x),
                                    torch.as_tensor(ones),
                                    torch.as_tensor(ones),
                                    torch.as_tensor(xt), 1.2)
    assert torch.isfinite(b).all()
    _close(a, b, 1e-6, 1e-6)


@pytest.mark.parametrize("d", [1, 2])
def test_fit_gpou_matches_jax(d):
    rng = np.random.default_rng(20 + d)
    b, m = 5, 26
    x = rng.uniform(-0.5, 0.5, (b, m, d)).astype(np.float32)
    f = rng.uniform(0.3, 2.0, (b, m)).astype(np.float32)
    valid = rng.uniform(size=(b, m)) > 0.3
    valid[0] = False                       # an empty group
    sj = jgp.fit_gpou(jnp.asarray(x), jnp.asarray(f), jnp.asarray(valid),
                      0.5, 0.01)
    st = tgp.fit_gpou(torch.as_tensor(x), torch.as_tensor(f),
                      torch.as_tensor(valid), 0.5, 0.01)
    np.testing.assert_array_equal(np.asarray(sj.trained), st.trained.numpy())
    _close(sj.l, st.l, 1e-5, 1e-6)
    _close(sj.alpha, st.alpha, 1e-4, 1e-4)
    _close(jgp.linv_from_chol(sj.l), tgp.linv_from_chol(st.l), 1e-4, 1e-4)


@pytest.mark.parametrize("m", [8, 16])
def test_fit_ongpis_and_linv_match_jax(m):
    rng = np.random.default_rng(30 + m)
    x, grad, val, sigx, siggrad, valid = _nodes(rng, 4, m, 2)
    J = [jnp.asarray(a) for a in (x, grad, val, sigx, siggrad, valid)]
    T = [torch.as_tensor(a) for a in (x, grad, val, sigx, siggrad, valid)]
    sj = jgp.fit_ongpis(*J, 1.2)
    st = tgp.fit_ongpis(*T, 1.2)
    np.testing.assert_array_equal(np.asarray(sj.gradflag),
                                  st.gradflag.numpy())
    _close(sj.l, st.l, 1e-4, 1e-5)
    _close(sj.alpha, st.alpha, 1e-3, 1e-3)
    lj = jgp.linv_from_chol(sj.l)
    lt = tgp.linv_from_chol(st.l)
    _close(lj, lt, 1e-3, 1e-3)
    # the tile kernel skips the upper triangle: it must be exactly zero
    assert torch.all(torch.triu(lt, diagonal=1) == 0)


def test_ongpis_prepare_matches_jax():
    rng = np.random.default_rng(4)
    _, grad, _, sigx, siggrad, valid = _nodes(rng, 3, 12, 2)
    gj, sj = jgp.ongpis_prepare(jnp.asarray(grad), jnp.asarray(sigx),
                                jnp.asarray(siggrad), jnp.asarray(valid))
    gt, st = tgp.ongpis_prepare(torch.as_tensor(grad),
                                torch.as_tensor(sigx),
                                torch.as_tensor(siggrad),
                                torch.as_tensor(valid))
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())


def test_gpou_posterior_gather_matches_jax():
    rng = np.random.default_rng(5)
    s, m, q = 6, 10, 37
    x = rng.uniform(-1, 1, (s, m, 1)).astype(np.float32)
    f = rng.uniform(0.3, 2.0, (s, m)).astype(np.float32)
    valid = rng.uniform(size=(s, m)) > 0.2
    valid[2] = False
    st = jgp.fit_gpou(jnp.asarray(x), jnp.asarray(f), jnp.asarray(valid),
                      0.5, 0.01)
    linv = jgp.linv_from_chol(st.l)
    cell = rng.integers(0, s, q).astype(np.int32)
    qq = rng.uniform(-1, 1, (q, 1)).astype(np.float32)
    mj, vj = jgp.gpou_posterior_gather(
        st.x, st.alpha, linv, st.valid, st.trained, jnp.asarray(cell),
        jnp.asarray(qq), 0.5, 0.01, chunk=16)
    mt, vt = tgp.gpou_posterior_gather(
        *(torch.as_tensor(np.asarray(a)) for a in
          (st.x, st.alpha, linv, st.valid, st.trained)),
        torch.as_tensor(cell).long(), torch.as_tensor(qq), 0.5, 0.01,
        chunk=16)
    _close(mj, mt, 1e-4, 1e-4)
    _close(vj, vt, 1e-4, 1e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_gpou_test_matches_jax(d):
    """gpou_test on one fitted GPou batch (the JAX fit's arrays fed to
    both), scale 0.5 and noise 0.01 as in tests/test_kernels_gp.py:102:
    means within 1e-5, variances within 1e-4."""
    rng = np.random.default_rng(40 + d)
    b, m, q = 4, 12, 9
    x = rng.uniform(-0.5, 0.5, (b, m, d)).astype(np.float32)
    f = rng.uniform(0.3, 2.0, (b, m)).astype(np.float32)
    valid = rng.uniform(size=(b, m)) > 0.3
    valid[0] = False                       # an empty group
    xt = rng.uniform(-0.5, 0.5, (b, q, d)).astype(np.float32)
    sj = jgp.fit_gpou(jnp.asarray(x), jnp.asarray(f), jnp.asarray(valid),
                      0.5, 0.01)
    st = tgp.GPouState(*(torch.as_tensor(np.array(a)) for a in sj))
    mj, vj = jgp.gpou_test(sj, jnp.asarray(xt), 0.5, 0.01)
    mt, vt = tgp.gpou_test(st, torch.as_tensor(xt), 0.5, 0.01)
    _close(mj, mt, 1e-5, 1e-5)
    _close(vj, vt, 1e-4, 1e-4)


@pytest.mark.parametrize("d", [2, 3])
def test_ongpis_test_matches_jax(d):
    """ongpis_test on one fitted cluster-GP batch (the JAX fit's arrays
    fed to both), with the constants of tests/test_kernels_gp.py:136
    (2D: scale 1.2, 1.01, 3/l^2 + 0.1; 3D: scale 0.04 on coordinates
    shrunk by 0.02, 1.001, 3/l^2 + 0.001): f and grad within 1e-5,
    the variances within 1e-4 (relative to their size: 3D var_grad is
    near 1875)."""
    rng = np.random.default_rng(50 + d)
    x, grad, val, sigx, siggrad, valid = _nodes(rng, 3, 10, d)
    xt = rng.uniform(-1, 1, (3, 7, d)).astype(np.float32)
    scale = 1.2 if d == 2 else 0.04
    if d == 3:
        x, xt = x * 0.02, xt * 0.02
    vc, gc = ((1.01, 3.0 / scale ** 2 + 0.1) if d == 2
              else (1.001, 3.0 / scale ** 2 + 0.001))
    sj = jgp.fit_ongpis(*(jnp.asarray(a) for a in
                          (x, grad, val, sigx, siggrad, valid)), scale)
    st = tgp.OnGPISState(*(torch.as_tensor(np.array(a)) for a in sj))
    oj = jgp.ongpis_test(sj, jnp.asarray(xt), scale, vc, gc)
    ot = tgp.ongpis_test(st, torch.as_tensor(xt), scale, vc, gc)
    for name, a, b, tol in zip(("f", "grad", "varf", "vargrad"), oj, ot,
                               (1e-5, 1e-5, 1e-4, 1e-4)):
        assert tuple(b.shape) == a.shape, name
        _close(a, b, tol, tol)
