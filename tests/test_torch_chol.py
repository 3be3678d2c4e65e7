"""Batched Cholesky and L^-1 of the cluster-GP systems: the PyTorch port's
plain versions vs the Pallas kernels and the JAX fit path, the CPU
routing, an f32 emulation of the CUDA linv's merge schedule vs the plain
version, and (on a CUDA card only) the CUDA kernels vs the plain versions.

JAX is imported inside the tests that compare with it, so that the
CUDA-only tests also run on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_chol.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_scenes  # noqa: E402
from gpismap_tpu_torch.models import cluster as tcl  # noqa: E402
from gpismap_tpu_torch.ops import chol as chol_ops  # noqa: E402
from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402
from gpismap_tpu_torch.ops import kernels as tkern  # noqa: E402

# Cholesky factors of the synthetic SPD batches: the tolerance of
# tests/test_pallas.py (f32, rounding order only)
L_TOL = 2e-4
# L^-1 error relative to max |L^-1|: the inverse's entries grow with the
# system's condition, so an absolute bound would depend on it
LINV_REL_TOL = 1e-4
# masked rows/cols of tests/test_pallas.py:149, as (matrix, index)
MASKED = [(0, 5), (0, 380), (1, 100)]
# the CUDA linv's diagonal block width (csrc/chol.cu, NB) and the rows on
# either side of each merge boundary it meets up to n = 1280
NB = 64
MERGE_EDGES = [j for e in (64, 128, 256, 512, 1024) for j in (e - 1, e)]


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


@pytest.mark.parametrize("mp", [640, 1280])
def test_references_match_pallas_kernels_3d_sizes(mp):
    """chol_reference and linv_reference == chol_pallas and linv_pallas
    (interpret mode) at the 3D bucket sizes above 512 (MP = 640, 1280),
    with identity-masked rows, at B = 1: interpret mode runs those in
    seconds."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.ops.pallas_chol import chol_pallas, linv_pallas

    k = _spd_batch(np.random.default_rng(mp), 1, mp, [(0, 7), (0, mp - 3)])
    l_pl = np.asarray(chol_pallas(jnp.asarray(k), interpret=True))
    l_t = chol_ops.chol_reference(torch.as_tensor(k))
    np.testing.assert_allclose(l_t.numpy(), l_pl, rtol=L_TOL, atol=L_TOL)
    assert _upper_is_zero(l_t)
    l = np.linalg.cholesky(k.astype(np.float64)).astype(np.float32)
    w_pl = np.asarray(linv_pallas(jnp.asarray(l), interpret=True))
    w_t = chol_ops.linv_reference(torch.as_tensor(l)).numpy()
    assert np.abs(w_t - w_pl).max() <= LINV_REL_TOL * np.abs(w_pl).max()
    assert (np.triu(w_t, 1) == 0).all()


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


def _merge_linv(l: torch.Tensor) -> torch.Tensor:
    """f32 emulation of the CUDA linv's algorithm (csrc/chol.cu): invert
    the NB-wide diagonal blocks (the last one padded with the identity),
    then merge them level by level, s = NB, 2 NB, ... while s < n: pair
    A = [2 p s, (2 p + 1) s) with D = [(2 p + 1) s, min((2 p + 2) s, n))
    and set W[D, A] = -D^-1 (C A^-1), C = L[D, A]."""
    b, n, _ = l.shape
    w = torch.zeros_like(l)
    for k0 in range(0, n, NB):
        wk = min(NB, n - k0)
        blk = torch.eye(NB).repeat(b, 1, 1)
        blk[:, :wk, :wk] = l[:, k0:k0 + wk, k0:k0 + wk]
        inv = torch.linalg.solve_triangular(blk, torch.eye(NB).expand(
            blk.shape), upper=False)
        w[:, k0:k0 + wk, k0:k0 + wk] = torch.tril(inv[:, :wk, :wk])
    s = NB
    while s < n:
        for a0 in range(0, n - s, 2 * s):
            d0, d1 = a0 + s, min(a0 + 2 * s, n)
            t = l[:, d0:d1, a0:d0] @ w[:, a0:d0, a0:d0]
            w[:, d0:d1, a0:d0] = -(w[:, d0:d1, d0:d1] @ t)
        s *= 2
    return w


def _check_merge_linv(l, w_ref, edges=()):
    """The emulation on l vs w_ref, relative to max |L^-1|; identity rows
    and columns exact, the strict upper triangle exact zeros."""
    w = _merge_linv(l)
    w_ref = torch.as_tensor(np.array(w_ref))
    assert float((w - w_ref).abs().max() / w_ref.abs().max()) <= LINV_REL_TOL
    assert _upper_is_zero(w)
    eye = torch.eye(l.shape[-1])
    for j in edges:
        if j < l.shape[-1]:
            assert torch.equal(w[:, j], eye[j].expand(l.shape[0], -1))
            assert torch.equal(w[:, :, j], eye[j].expand(l.shape[0], -1))


@pytest.mark.parametrize("b,n", [(2, 96), (2, 192), (2, 320), (2, 384),
                                 (1, 1000), (1, 1280)])
def test_merge_schedule_matches_plain_and_pallas(b, n):
    """The CUDA linv's merge schedule, emulated in f32, == linv_reference
    and (n a multiple of 128) linv_pallas in interpret mode, relative to
    max |L^-1|, with identity-masked rows on either side of every merge
    boundary (j = 63, 64, 127, 128, ..., 1023, 1024): those rows and
    columns come out exact."""
    k = _spd_batch(np.random.default_rng(n), b, n,
                   [(m, j) for m in range(b) for j in MERGE_EDGES if j < n])
    l = chol_ops.chol_reference(torch.as_tensor(k))
    _check_merge_linv(l, chol_ops.linv_reference(l), MERGE_EDGES)
    if n % 128 == 0:
        pytest.importorskip("jax")
        import jax.numpy as jnp
        from gpismap_tpu.ops.pallas_chol import linv_pallas

        _check_merge_linv(l, linv_pallas(jnp.asarray(l.numpy()),
                                         interpret=True), MERGE_EDGES)


@pytest.fixture(scope="module")
def fit_3d():
    """The port's GPisMap3D on the CPU after one frame of
    tests/torch_scenes.py's tiny 3D scene (64x48 camera, gp_support 32):
    the retrain's K batches (n = 64 and 128) and the mapper."""
    from gpismap_tpu_torch import CameraParam, CapacityParam, GPisMap3D

    cam = CameraParam(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64,
                      height=48)
    m = GPisMap3D(cap=CapacityParam(gp_support=32, retrain_batch=8,
                                    max_cells=256, max_nodes=4096,
                                    test_tile=16, test_active_cells=128,
                                    max_beams=64),
                  camera=cam, device="cpu")
    ks, chol = [], chol_ops.chol

    def keep(k):
        ks.append(k)
        return chol(k)

    try:
        chol_ops.chol = keep
        m.update(*torch_scenes.object_frames(1, cam)[0])
    finally:
        chol_ops.chol = chol
    return ks, m


def _full_size_3d_system(m, size=320):
    """The cluster-GP train covariance [1, 4 size, 4 size] of the `size`
    mapped nodes nearest the map's centroid, at the 3D map's scale, in the
    [f; gx; gy; gz] layout; rows past the map's nodes are masked."""
    nd = m.index.dump_nodes()
    alive = np.nonzero(nd["alive"])[0]
    pos = nd["pos"][alive]
    near = alive[np.argsort(((pos - pos.mean(0)) ** 2).sum(1))[:size]]
    cnt = len(near)

    def pad(a):
        out = np.zeros((1, size) + a.shape[1:], a.dtype)
        out[0, :cnt] = a[near]
        return torch.as_tensor(out)

    valid = torch.zeros((1, size), dtype=torch.bool)
    valid[0, :cnt] = True
    gradflag, sigx = tgp.ongpis_prepare(pad(nd["grad"]), pad(nd["pos_sig"]),
                                        pad(nd["grad_sig"]), valid)
    return tkern.matern32_deriv_train_cov(pad(nd["pos"]), sigx,
                                          pad(nd["grad_sig"]), gradflag,
                                          valid, m.p.map_scale_param)


@pytest.mark.parametrize("which", ["retrain", "full size"])
def test_merge_schedule_on_3d_fit_factors(fit_3d, which):
    """The emulated merge schedule == linv_reference, relative to max
    |L^-1|, on the Cholesky factors of a real 3D fit: the retrain batches
    of the tiny 3D scene (n = 64 and 128), and an n = 1280 system (M = 320,
    the 3D default) of the same map's nodes."""
    ks, m = fit_3d
    if which == "retrain":
        assert ks and {k.shape[-1] for k in ks} == {64, 128}
    else:
        ks = [_full_size_3d_system(m)]
        assert ks[0].shape == (1, 1280, 1280)
    for k in ks:
        l = chol_ops.chol_reference(k)
        _check_merge_linv(l, chol_ops.linv_reference(l))


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
                         + [(512, 384), (4, 48), (3, 100), (2, 1000), (5, 65)]
                         + [(b, mp) for b in (1, 8, 64)
                            for mp in (320, 640, 1280)])
def test_cuda_kernels_match_plain_versions(b, mp):
    """chol and linv on the card == their plain versions: the retrain's
    batches (B 1 to 64 at the bucket sizes 96/192/384 in 2D and
    320/640/1280 in 3D), the fill (B = 512 at 384) and ragged sizes (not
    multiples of chol's 64-wide panel);
    identity-masked rows come out exact,
    strict upper triangles are exact zeros, each call counts one
    launch, and one linv() issues 1 + 2 ceil(log2(ceil(n / 64))) CUDA
    launches."""
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
    assert chol_ops.cuda_launches_per_linv(mp) == 1 + 2 * math.ceil(
        math.log2(math.ceil(mp / NB)))
    w_ref = chol_ops.linv_reference(l)
    rel = float((w - w_ref).abs().max() / w_ref.abs().max())
    assert rel <= LINV_REL_TOL
    assert _upper_is_zero(w)
    for i, j in masked:
        assert torch.equal(w[i, j], eye[j]) and torch.equal(w[i, :, j],
                                                            eye[j])
    with pytest.raises(ValueError, match="not contiguous"):
        chol_ops.chol(k.mT)
    with pytest.raises(ValueError, match="n=1281"):
        chol_ops.linv(torch.zeros((1, 1281, 1281), device="cuda"))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the chol kernels have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("b,mp", [(3, 130), (2, 1280)])
def test_cuda_chol_masked_rows_on_panel_boundaries(b, mp):
    """Identity-masked rows and columns on either side of each panel
    boundary (j = NB - 1 and NB, and the last panel's first row; NB is
    chol's panel width) come out exactly as identity rows and columns of
    L."""
    _need_cuda()
    k, _ = _cuda_case(b, mp, seed=7 * mp)
    idx = [NB - 1, NB, (mp - 1) // NB * NB]
    for i in range(b):
        for j in idx:
            k[i, j, :] = 0.0
            k[i, :, j] = 0.0
            k[i, j, j] = 1.0
    l = chol_ops.chol(k)
    l_ref = chol_ops.chol_reference(k)
    torch.cuda.synchronize()
    assert float((l - l_ref).abs().max() / max(1.0, float(l_ref.abs().max()))
                 ) <= L_TOL
    assert _upper_is_zero(l)
    eye = torch.eye(mp, device="cuda")
    for i in range(b):
        for j in idx:
            assert torch.equal(l[i, j], eye[j])
            assert torch.equal(l[i, :, j], eye[j])


@pytest.mark.cuda
@pytest.mark.parametrize("b,mp", [(2, 200), (1, 1280)])
def test_cuda_chol_clamps_pivots(b, mp):
    """The pivot clamp of pallas_chol.py:72: K = 0 gives exactly
    sqrt(float32(1e-30)) I; a rank-deficient positive semi-definite batch
    (rows and columns of zeros, on panel boundaries among them) gives a
    finite L whose zero rows have the clamped diagonal and which equals,
    bit for bit, the factor of the same batch with those rows masked by
    the identity everywhere else."""
    _need_cuda()
    clamp = torch.sqrt(torch.tensor(1e-30, dtype=torch.float32)).item()
    l0 = chol_ops.chol(torch.zeros((b, mp, mp), device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(l0, clamp * torch.eye(mp, device="cuda").expand(
        b, mp, mp))

    k, _ = _cuda_case(b, mp, seed=11 * mp)
    zero = [5, NB - 1, NB, mp - 1]
    k_zero, k_masked = k.clone(), k.clone()
    for j in zero:
        k_zero[:, j, :] = 0.0
        k_zero[:, :, j] = 0.0
        k_masked[:, j, :] = 0.0
        k_masked[:, :, j] = 0.0
        k_masked[:, j, j] = 1.0
    l = chol_ops.chol(k_zero)
    l_masked = chol_ops.chol(k_masked)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(l).all())
    for j in zero:
        assert bool((l[:, j, j] == clamp).all())
        l[:, j, j] = 1.0
    assert torch.equal(l, l_masked)


@pytest.mark.cuda
def test_cuda_chol_is_batch_independent():
    """Matrix i of a B = 64, n = 1280 batch factored alone is bitwise
    equal to its factor in the batch: no block's arithmetic depends on
    the other matrices."""
    _need_cuda()
    k, _ = _cuda_case(64, 1280, seed=12)
    l = chol_ops.chol(k)
    for i in (0, 1, 31, 63):
        alone = chol_ops.chol(k[i:i + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(alone[0], l[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("b,mp", [(2, 1280), (2, 1000)])
def test_cuda_linv_masked_rows_on_merge_boundaries(b, mp):
    """linv on the card == the plain version, relative to max |L^-1|, with
    identity-masked rows and columns on either side of every merge
    boundary (j = 63, 64, 127, 128, ..., 1023, 1024), which come out
    exactly as identity rows and columns of L^-1."""
    _need_cuda()
    k, _ = _cuda_case(b, mp, seed=13 * mp)
    edges = [j for j in MERGE_EDGES if j < mp]
    for j in edges:
        k[:, j, :] = 0.0
        k[:, :, j] = 0.0
        k[:, j, j] = 1.0
    l = chol_ops.chol_reference(k).contiguous()
    w = chol_ops.linv(l)
    w_ref = chol_ops.linv_reference(l)
    torch.cuda.synchronize()
    assert float((w - w_ref).abs().max() / w_ref.abs().max()) <= LINV_REL_TOL
    assert _upper_is_zero(w)
    eye = torch.eye(mp, device="cuda")
    for i in range(b):
        for j in edges:
            assert torch.equal(w[i, j], eye[j])
            assert torch.equal(w[i, :, j], eye[j])


@pytest.mark.cuda
def test_cuda_linv_is_batch_independent():
    """Matrix i of a B = 64, n = 1280 batch inverted alone is bitwise equal
    to its inverse in the batch."""
    _need_cuda()
    k, _ = _cuda_case(64, 1280, seed=14)
    l = chol_ops.chol(k)
    w = chol_ops.linv(l)
    for i in (0, 1, 31, 63):
        alone = chol_ops.linv(l[i:i + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(alone[0], w[i]), i


# Relative gap, on the card, between a bucketed fit and the same system at
# full padding, as (chol relative to max |L|, the refreshed L^-1 relative
# to max |L^-1|): 10x the gap measured on an H100 with the merge-schedule
# linv (2D: 5.78e-7 and 6.37e-7; 3D: 3.33e-7 and 2.66e-7), and never
# above 1e-4. The [f; gx; gy(; gz)] layout puts the padded rows inside the
# matrix, so the small and the full system group their sums into 64-wide
# blocks differently and agree only to rounding.
BUCKET_GAP = {2: (5.8e-6, 6.4e-6), 3: (3.4e-6, 2.7e-6)}


@pytest.mark.cuda
@pytest.mark.parametrize("d,mb,m", [(2, 32, 128), (3, 80, 320)])
def test_cuda_bucketed_fit_matches_full_padding(d, mb, m):
    """One masked cluster system fitted on the card at its support bucket
    (mb rows per block, as the retrain does) and at full padding (m, as
    the factor-cache fill does): the small fit's chol, and the refresh
    _embed_linv(linv(L_small)), against chol and linv of the full one."""
    _need_cuda()
    rng = np.random.default_rng(d)
    b, nvalid, scale = 8, mb - 5, (1.2 if d == 2 else 0.04)
    x = np.zeros((b, m, d), np.float32)
    g = np.zeros((b, m, d), np.float32)
    x[:, :mb] = rng.uniform(-scale, scale, (b, mb, d))
    g[:, :mb] = rng.normal(size=(b, mb, d))
    g[:, :mb] /= np.linalg.norm(g[:, :mb], axis=-1, keepdims=True)
    val = np.full((b, m), -0.2, np.float32)
    sig = np.full((b, m), 0.02, np.float32)
    valid = np.zeros((b, m), bool)
    valid[:, :nvalid] = True
    full = [torch.as_tensor(a, device="cuda") for a in (x, g, val, sig, sig,
                                                        valid)]
    small = [a[:, :mb].contiguous() for a in full]
    l_small = tgp.fit_ongpis(*small, scale).l
    l_full = tgp.fit_ongpis(*full, scale).l
    mp = (1 + d) * m
    chol_gap = float((tcl._embed_linv(l_small, mp, d) - l_full).abs().max()
                     / l_full.abs().max())
    w_fill = chol_ops.linv(l_full)
    w_refresh = tcl._embed_linv(chol_ops.linv(l_small), mp, d)
    torch.cuda.synchronize()
    linv_gap = float((w_refresh - w_fill).abs().max() / w_fill.abs().max())
    print(f"d={d}: bucketed vs full padding, chol {chol_gap:.3g}, "
          f"linv {linv_gap:.3g} relative")
    assert chol_gap <= BUCKET_GAP[d][0]
    assert linv_gap <= BUCKET_GAP[d][1]
