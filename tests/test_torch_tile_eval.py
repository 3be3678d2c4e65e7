"""Tile evaluation of the map query: the PyTorch port's plain version vs
the JAX package, the tile plan vs JAX, and (on a CUDA card only) the CUDA
kernel vs the plain version.

JAX is imported inside the tests that compare with it, so that the
CUDA-only test also runs on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tile_eval.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.models import cluster as tcl  # noqa: E402
from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402
from gpismap_tpu_torch.ops import kernels as tk  # noqa: E402
from gpismap_tpu_torch.ops import segmented as tseg  # noqa: E402
from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402

SCALE, VAL_CONST, GRAD_CONST = 1.2, 1.01, 3.0 / 1.44 + 0.1
BIG = np.iinfo(np.int32).max


def _tile_case(rng, s, m, t, nt, d=2):
    """A masked cluster store of s cells, its L^-1 factors, and nt tiles
    of t queries (the last tile inactive) in the tile kernel's layout."""
    mp = m * (1 + d)
    x = rng.uniform(-1, 1, (s, m, d)).astype(np.float32)
    grad = rng.normal(size=(s, m, d)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    valid = rng.uniform(size=(s, m)) > 0.2
    store = tcl.ClusterStore(
        x=torch.as_tensor(x), grad=torch.as_tensor(grad),
        val=torch.full((s, m), -0.2), sigx=torch.full((s, m), 0.05),
        siggrad=torch.full((s, m), 0.05), valid=torch.as_tensor(valid),
        alpha=torch.as_tensor(rng.normal(size=(s, mp)).astype(np.float32)),
        trained=torch.ones(s, dtype=torch.bool))
    gf, sx = tgp.ongpis_prepare(store.grad, store.sigx, store.siggrad,
                                store.valid)
    k = tk.matern32_deriv_train_cov(store.x, sx, store.siggrad, gf,
                                    store.valid, SCALE)
    linv = tgp.linv_from_chol(torch.linalg.cholesky(k)).contiguous()
    segs = rng.integers(0, s, nt).astype(np.int32)
    segs[-1] = -1
    q = rng.uniform(-1, 1, (nt, t, d)).astype(np.float32)
    args = (torch.as_tensor(segs), linv, store.x.transpose(-1, -2)
            .contiguous(), store.alpha, gf.float(), store.valid.float(),
            torch.as_tensor(q).transpose(-1, -2).contiguous())
    return store, args, q


def _kw(d=2):
    return dict(d=d, scale=SCALE, val_const=VAL_CONST, grad_const=GRAD_CONST)


def test_reference_matches_pallas_kernel_and_xla_twin():
    """tile_eval_reference == tile_eval_pallas (interpret mode) and the
    JAX twin _ongpis_eval_tile, on the shapes of tests/test_pallas.py."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.models.cluster import ClusterStore, _ongpis_eval_tile
    from gpismap_tpu.ops.pallas_tile import tile_eval_pallas

    store, args, q = _tile_case(np.random.default_rng(0), 4, 16, 8, 6)
    out = tile_ops.tile_eval_reference(*args, **_kw())
    ja = [jnp.asarray(a.numpy()) for a in args]
    pal = tile_eval_pallas(*ja, interpret=True, **_kw())
    jstore = ClusterStore(**{k: jnp.asarray(v.numpy())
                             for k, v in store._asdict().items()})
    segs = np.maximum(args[0].numpy(), 0)
    twin = _ongpis_eval_tile(jstore, ja[1], jnp.arange(4, dtype=jnp.int32),
                             jnp.asarray(segs), jnp.asarray(q), SCALE,
                             VAL_CONST, GRAD_CONST)
    twin = (twin[0], jnp.swapaxes(twin[1], -1, -2), twin[2],
            jnp.swapaxes(twin[3], -1, -2))
    act = args[0].numpy() >= 0
    for name, o, p, w in zip(("f", "g", "vf", "vg"), out, pal, twin):
        np.testing.assert_allclose(o.numpy()[act], np.asarray(p)[act],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(o.numpy()[act], np.asarray(w)[act],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("panel", [None, 32, 16])
def test_reference_3d_matches_pallas_kernel_and_xla_twin(panel):
    """At d = 3 (MP = 4M = 64): tile_eval_reference == tile_eval_pallas
    (interpret mode), also on its row-panelled path (panel_override, as
    the Pallas kernel runs MP > 512), and == the JAX twin
    _ongpis_eval_tile, to 1e-4 (f32 rounding order only)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.models.cluster import ClusterStore, _ongpis_eval_tile
    from gpismap_tpu.ops.pallas_tile import tile_eval_pallas

    store, args, q = _tile_case(np.random.default_rng(30), 4, 16, 8, 6, d=3)
    out = tile_ops.tile_eval_reference(*args, **_kw(d=3))
    ja = [jnp.asarray(a.numpy()) for a in args]
    pal = tile_eval_pallas(*ja, interpret=True, panel_override=panel,
                           **_kw(d=3))
    jstore = ClusterStore(**{k: jnp.asarray(v.numpy())
                             for k, v in store._asdict().items()})
    segs = np.maximum(args[0].numpy(), 0)
    twin = _ongpis_eval_tile(jstore, ja[1], jnp.arange(4, dtype=jnp.int32),
                             jnp.asarray(segs), jnp.asarray(q), SCALE,
                             VAL_CONST, GRAD_CONST)
    twin = (twin[0], jnp.swapaxes(twin[1], -1, -2), twin[2],
            jnp.swapaxes(twin[3], -1, -2))
    act = args[0].numpy() >= 0
    assert out[1].shape == (6, 3, 8)
    for name, o, p, w in zip(("f", "g", "vf", "vg"), out, pal, twin):
        np.testing.assert_allclose(o.numpy()[act], np.asarray(p)[act],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(o.numpy()[act], np.asarray(w)[act],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_ongpis_eval_tile_twin_matches_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.models import cluster as jcl

    store, args, q = _tile_case(np.random.default_rng(1), 5, 8, 16, 4)
    linv = args[1]
    slot_of = np.array([2, 0, 4, 1, 3], np.int32)
    segs = np.array([0, 3, 4, 2], np.int32)
    out = tcl._ongpis_eval_tile(store, linv, torch.as_tensor(slot_of),
                                torch.as_tensor(segs), torch.as_tensor(q),
                                SCALE, VAL_CONST, GRAD_CONST)
    jstore = jcl.ClusterStore(**{k: jnp.asarray(v.numpy())
                                 for k, v in store._asdict().items()})
    ref = jcl._ongpis_eval_tile(jstore, jnp.asarray(linv.numpy()),
                                jnp.asarray(slot_of), jnp.asarray(segs),
                                jnp.asarray(q), SCALE, VAL_CONST, GRAD_CONST)
    for name, a, b in zip(("f", "g", "vf", "vg"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_tile_eval_cpu_runs_the_plain_version():
    """CPU tensors go through the plain version and launch no kernel;
    other devices are refused."""
    _, args, _ = _tile_case(np.random.default_rng(2), 3, 8, 8, 5)
    before = tile_ops.launches
    out = tile_ops.tile_eval(*args, **_kw())
    ref = tile_ops.tile_eval_reference(*args, **_kw())
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tile_ops.launches == before
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        tile_ops.tile_eval(*meta, **_kw())


def _plan_cases():
    rng = np.random.default_rng(7)
    cases = []
    for trial in range(4):
        max_cells = int(rng.choice([64, 256]))
        max_active = 16
        tile = int(rng.choice([4, 16]))
        p = int(rng.integers(1, 600))
        n_act = int(rng.integers(1, max_active + 1))
        act = np.sort(rng.choice(max_cells, n_act, replace=False))
        uniq = np.full(max_active, BIG, np.int64)
        uniq[:n_act] = act
        pool = np.concatenate([act, rng.integers(0, max_cells, 8),
                               [-1, -1, max_cells + 3]])
        cases.append((rng.choice(pool, p), uniq, max_cells, max_active,
                      tile))
    # the 2D production shape: 3 * 4096 pairs over 300 of 4096 cells
    act = np.sort(rng.choice(4096, 300, replace=False))
    uniq = np.full(512, BIG, np.int64)
    uniq[:300] = act
    cases.append((np.where(rng.random(3 * 4096) < 0.3, -1,
                           rng.choice(act, 3 * 4096)), uniq, 4096, 512,
                  256))
    # a slot-id space too wide for JAX's packed int32 key
    act = np.sort(rng.choice(40_000, 9, replace=False))
    uniq = np.full(16, BIG, np.int64)
    uniq[:9] = act
    cases.append((rng.choice(np.concatenate([act, [-1, 17, 40_005]]),
                             33_000), uniq, 40_000, 16, 16))
    return cases


@pytest.mark.parametrize("case", range(6))
def test_plan_tiles_for_slots_identical_to_jax(case):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from gpismap_tpu.ops import segmented as jseg

    seg, uniq, max_cells, max_active, tile = _plan_cases()[case]
    seg = seg.astype(np.int32)
    uniq = uniq.astype(np.int32)
    pj, nj = jseg.plan_tiles_for_slots(jnp.asarray(seg), jnp.asarray(uniq),
                                       max_cells, max_active, tile)
    pt, nt = tseg.plan_tiles_for_slots(torch.as_tensor(seg),
                                       torch.as_tensor(uniq), max_cells,
                                       max_active, tile)
    np.testing.assert_array_equal(np.asarray(pj.pair_ids),
                                  pt.pair_ids.numpy())
    np.testing.assert_array_equal(np.asarray(pj.tile_seg),
                                  pt.tile_seg.numpy())
    assert pt.pair_ids.dtype == pt.tile_seg.dtype == torch.int32
    assert int(pj.n_tiles) == int(pt.n_tiles)
    assert int(nj) == int(nt)


def _check_cuda_kernel(args, d):
    """One launch of the CUDA kernel on args (on the card) == the plain
    version on the active tiles, max abs error <= 1e-4 (f32 rounding
    order only). Returns the kernel's outputs."""
    before = tile_ops.launches
    out = tile_ops.tile_eval(*args, **_kw(d=d))
    torch.cuda.synchronize()
    assert tile_ops.launches == before + 1
    ref = tile_ops.tile_eval_reference(*args, **_kw(d=d))
    act = args[0] >= 0
    for name, a, b in zip(("f", "g", "vf", "vg"), out, ref):
        err = float((a[act] - b[act]).abs().max()) if bool(act.any()) else 0.
        assert err <= 1e-4, (name, err)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,nt", [(16, 8, 6), (128, 256, 40),
                                    (40, 100, 9), (13, 40, 5), (16, 8, 1)])
def test_cuda_kernel_matches_plain_version(m, t, nt):
    """The CUDA kernel == tile_eval_reference on the card, at the shapes
    of tests/test_pallas.py, the 2D production shape (M=128, MP=384,
    T=256), ragged sizes (MP and T not multiples of the kernel's
    blocking), MP=39 (not a multiple of 4: the scalar L^-1 loads) and a
    plan whose one tile is inactive (no block works, no fault); inactive
    tiles are left alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the tile kernel has no "
                    "CPU mode")
    _, args, _ = _tile_case(np.random.default_rng(m), 6, m, t, nt)
    args = tuple(a.cuda() for a in args)
    _check_cuda_kernel(args, 2)
    with pytest.raises(ValueError, match="got 4"):
        tile_ops.tile_eval(*args, **_kw(d=4))


@pytest.mark.cuda
@pytest.mark.parametrize("m,t,nt", [(320, 128, 24), (16, 8, 6),
                                    (40, 100, 9), (100, 36, 5),
                                    (64, 200, 4), (320, 128, 1)])
def test_cuda_kernel_3d_matches_plain_version(m, t, nt):
    """The d=3 instance of the CUDA kernel == tile_eval_reference on the
    card: the 3D production shape (M=320, MP=1280, T=128), the shapes of
    tests/test_pallas.py, ragged sizes (MP not a multiple of the 128 rows
    of a row panel, T(1+D) not a multiple of the 128 columns of a block),
    T=200 (a column block straddling two derivative blocks) and a plan
    whose one tile is inactive."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the tile kernel has no "
                    "CPU mode")
    _, args, _ = _tile_case(np.random.default_rng(m + 3), 6, m, t, nt, d=3)
    args = tuple(a.cuda() for a in args)
    _check_cuda_kernel(args, 3)


@pytest.mark.cuda
def test_cuda_kernel_3d_is_deterministic_and_batch_independent():
    """At the 3D production shape (M=320, MP=1280, T=128), two calls give
    bitwise-equal outputs, and a tile evaluated alone gives bitwise the
    outputs it gets inside a batch of 24 (every output has one writer and
    a fixed summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the tile kernel has no "
                    "CPU mode")
    _, args, _ = _tile_case(np.random.default_rng(11), 6, 320, 128, 24, d=3)
    args = tuple(a.cuda() for a in args)
    out = _check_cuda_kernel(args, 3)
    again = tile_ops.tile_eval(*args, **_kw(d=3))
    act = args[0] >= 0
    for a, b in zip(out, again):
        assert torch.equal(a[act], b[act])
    for i in (0, 7, 22):
        one = (args[0][i:i + 1],) + args[1:6] + (args[6][i:i + 1],)
        alone = tile_ops.tile_eval(*one, **_kw(d=3))
        for a, b in zip(out, alone):
            assert torch.equal(a[i:i + 1], b)
