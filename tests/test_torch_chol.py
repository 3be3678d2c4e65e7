"""Batched Cholesky and L^-1 of the cluster-GP systems: the PyTorch port's
plain versions vs the Pallas kernels and the JAX fit path, the CPU
routing, and (on a CUDA card only) the CUDA kernels vs the plain versions.

JAX is imported inside the tests that compare with it, so that the
CUDA-only tests also run on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_chol.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.ops import chol as chol_ops  # noqa: E402
from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402

# Cholesky factors of the synthetic SPD batches: the tolerance of
# tests/test_pallas.py (f32, rounding order only)
L_TOL = 2e-4
# L^-1 error relative to max |L^-1|: the inverse's entries grow with the
# system's condition, so an absolute bound would depend on it
LINV_REL_TOL = 1e-4
# masked rows/cols of tests/test_pallas.py:149, as (matrix, index)
MASKED = [(0, 5), (0, 380), (1, 100)]


def _spd_batch(rng, b, mp, masked=()):
    """SPD [b, mp, mp] as in tests/test_pallas.py, with identity-masked
    rows and columns the way ops/kernels.py pads."""
    a = rng.normal(size=(b, mp, mp)).astype(np.float32) / np.sqrt(mp)
    k = a @ np.swapaxes(a, -1, -2) + 2.0 * np.eye(mp, dtype=np.float32)
    for m, i in masked:
        k[m, i, :] = 0.0
        k[m, :, i] = 0.0
        k[m, i, i] = 1.0
    return k


def _upper_is_zero(x):
    return bool(torch.all(torch.triu(x, diagonal=1) == 0))


def test_chol_reference_matches_pallas_kernel():
    """chol_reference == chol_pallas (interpret mode), identity-masked
    rows included, on the inputs of tests/test_pallas.py at B = 2."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.ops.pallas_chol import chol_pallas

    k = _spd_batch(np.random.default_rng(1), 2, 384, MASKED)
    l_pl = np.asarray(chol_pallas(jnp.asarray(k), interpret=True))
    l_t = chol_ops.chol_reference(torch.as_tensor(k))
    np.testing.assert_allclose(l_t.numpy(), l_pl, rtol=L_TOL, atol=L_TOL)
    assert _upper_is_zero(l_t)
    assert (np.triu(l_pl, 1) == 0).all()


def test_linv_reference_matches_pallas_kernel():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.ops.pallas_chol import linv_pallas

    k = _spd_batch(np.random.default_rng(2), 2, 256)
    l = np.linalg.cholesky(k.astype(np.float64)).astype(np.float32)
    w_pl = np.asarray(linv_pallas(jnp.asarray(l), interpret=True))
    w_t = chol_ops.linv_reference(torch.as_tensor(l))
    np.testing.assert_allclose(w_t.numpy(), w_pl, rtol=L_TOL, atol=L_TOL)
    assert _upper_is_zero(w_t)


def test_fit_and_factor_path_matches_jax_with_pallas_gate(monkeypatch):
    """The port's fit_ongpis + linv_from_chol == the JAX package's with
    GPISMAP_PALLAS_CHOL=1 (its Pallas kernels in interpret mode), on the
    masked MP = 384 system of tests/test_pallas.py:178-203, to its 5e-3."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.ops import gp as jgp

    rng = np.random.default_rng(3)
    b, m, d = 2, 128, 2
    x = rng.uniform(-1, 1, (b, m, d)).astype(np.float32)
    g = rng.normal(size=(b, m, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    val = np.full((b, m), -0.2, np.float32)
    sig = np.full((b, m), 0.05, np.float32)
    valid = rng.uniform(size=(b, m)) > 0.3
    args = (x, g, val, sig, sig, valid)

    monkeypatch.setenv("GPISMAP_PALLAS_CHOL", "1")
    assert jgp._use_pallas_chol(3 * m)
    sj = jgp.fit_ongpis(*(jnp.asarray(a) for a in args), 0.2)
    wj = jgp.linv_from_chol(sj.l)
    st = tgp.fit_ongpis(*(torch.as_tensor(a) for a in args), 0.2)
    wt = tgp.linv_from_chol(st.l)
    for name, a, t in (("l", sj.l, st.l), ("alpha", sj.alpha, st.alpha),
                       ("linv", wj, wt)):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=5e-3,
                                   atol=5e-3, err_msg=name)
    assert _upper_is_zero(wt)


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors go through the plain versions and launch no kernel;
    other devices are refused."""
    k = torch.as_tensor(_spd_batch(np.random.default_rng(4), 3, 48,
                                   [(1, 7)]))
    before = (chol_ops.chol_launches, chol_ops.linv_launches)
    l = chol_ops.chol(k)
    assert torch.equal(l, chol_ops.chol_reference(k))
    w = chol_ops.linv(l)
    assert torch.equal(w, chol_ops.linv_reference(l))
    assert torch.equal(tgp.linv_from_chol(l), w)
    assert (chol_ops.chol_launches, chol_ops.linv_launches) == before
    for fn in (chol_ops.chol, chol_ops.linv):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(k.to("meta"))


def _cuda_case(b, mp, seed):
    """SPD [b, mp, mp] on the card; every third matrix has two masked
    identity rows."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((b, mp, mp), generator=g, device="cuda") / mp ** 0.5
    k = a @ a.mT + 2.0 * torch.eye(mp, device="cuda")
    masked = [(i, j) for i in range(0, b, 3) for j in (3, mp - 2)]
    for i, j in masked:
        k[i, j, :] = 0.0
        k[i, :, j] = 0.0
        k[i, j, j] = 1.0
    return k.contiguous(), masked


@pytest.mark.cuda
@pytest.mark.parametrize("b,mp", [(b, mp) for b in (1, 8, 64)
                                  for mp in (96, 192, 384)]
                         + [(512, 384), (4, 48), (3, 100)])
def test_cuda_kernels_match_plain_versions(b, mp):
    """chol and linv on the card == their plain versions: the retrain's
    batches (B 1 to 64 at the bucket sizes 96/192/384), the fill (B = 512
    at 384) and ragged sizes; identity-masked rows come out exact,
    strict upper triangles are exact zeros, and each call counts one
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the chol/linv kernels "
                    "have no CPU mode")
    k, masked = _cuda_case(b, mp, seed=b * 1000 + mp)
    before = chol_ops.chol_launches
    l = chol_ops.chol(k)
    torch.cuda.synchronize()
    assert chol_ops.chol_launches == before + 1
    l_ref = chol_ops.chol_reference(k)
    assert float((l - l_ref).abs().max()) <= L_TOL
    assert _upper_is_zero(l)
    eye = torch.eye(mp, device="cuda")
    for i, j in masked:
        assert torch.equal(l[i, j], eye[j]) and torch.equal(l[i, :, j],
                                                            eye[j])

    before = chol_ops.linv_launches
    w = chol_ops.linv(l)
    torch.cuda.synchronize()
    assert chol_ops.linv_launches == before + 1
    w_ref = chol_ops.linv_reference(l)
    rel = float((w - w_ref).abs().max() / w_ref.abs().max())
    assert rel <= LINV_REL_TOL
    assert _upper_is_zero(w)
    for i, j in masked:
        assert torch.equal(w[i, j], eye[j]) and torch.equal(w[i, :, j],
                                                            eye[j])
    with pytest.raises(ValueError, match="not contiguous"):
        chol_ops.chol(k.mT)
    with pytest.raises(ValueError, match="n=513"):
        chol_ops.linv(torch.zeros((1, 513, 513), device="cuda"))
