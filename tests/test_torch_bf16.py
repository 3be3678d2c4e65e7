"""The tile evaluation's bf16 variance variant (GPISMAP_PALLAS_BF16) in
the PyTorch port: its plain version against the JAX package's Pallas
kernel with bf16=True (interpret mode) on the CPU, the switch through the
mappers and map_test, and (on a CUDA card only) the kernel's bf16
instance against the plain version and the f32 kernel.

The variant rounds both multiplicands of the variance product L^-1 K* to
bfloat16 (nearest even) and accumulates in f32; K*, the mean and the
squares stay f32. So f and g are bitwise the f32 evaluation's, and the
variances move by the bf16 rounding (the JAX gate,
tests/test_pallas.py:67-78: var_f within 2e-2, var_grad within 5e-2).

JAX and the tiny maps (tests/torch_maps.py, which imports the JAX
package) are imported inside the tests that use them, so that the CUDA
cases also run on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_bf16.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.models import cluster as tcl  # noqa: E402
from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402
import torch_bf16_checks as bc  # noqa: E402
from test_torch_tile_eval import _kw, _tile_case  # noqa: E402

# the JAX package's bf16 gate against the f32 evaluation
# (tests/test_pallas.py:76-78)
BF16_VF_TOL, BF16_VG_TOL = 2e-2, 5e-2
# bf16 kernel vs the bf16 plain version on the card: each variance within
# its limit (torch_bf16_checks.variance_limits), KERNEL_TOL of its
# column's f32 summation scale plus a bf16 step of each K* entry that two
# correct f32 evaluations may round to different bf16 values
KERNEL_TOL = 1e-4


def _act(args):
    return args[0] >= 0


@pytest.mark.parametrize("d,panel", [(2, None), (3, None), (3, 32),
                                     (3, 16)])
def test_reference_bf16_matches_pallas_bf16(d, panel):
    """tile_eval_reference(bf16=True) == tile_eval_pallas(bf16=True)
    (interpret mode; at d=3 also row-panelled, as the Pallas kernel runs
    MP > 512) on tests/test_pallas.py's shapes: var_f and var_grad within
    rtol/atol 1e-5; f and g bitwise the port's own f32 plain output and
    within 1e-4 of JAX's; var_f off the f32 output somewhere (the
    rounding really happened)."""
    import jax.numpy as jnp
    from gpismap_tpu.ops.pallas_tile import tile_eval_pallas

    _, args, _ = _tile_case(np.random.default_rng(40 + d), 4, 16, 8, 6, d=d)
    out = tile_ops.tile_eval_reference(*args, **_kw(d), bf16=True)
    f32 = tile_ops.tile_eval_reference(*args, **_kw(d))
    ja = [jnp.asarray(a.numpy()) for a in args]
    pal = tile_eval_pallas(*ja, interpret=True, panel_override=panel,
                           bf16=True, **_kw(d))
    act = _act(args).numpy()
    for name, o, r, p in zip(("f", "g"), out[:2], f32[:2], pal[:2]):
        assert torch.equal(o, r), name
        np.testing.assert_allclose(o.numpy()[act], np.asarray(p)[act],
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for name, o, p in zip(("vf", "vg"), out[2:], pal[2:]):
        np.testing.assert_allclose(o.numpy()[act], np.asarray(p)[act],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert bool((out[2][act] != f32[2][act]).any())


def test_bf16_with_grad_raises():
    """The variant is forward-only (the Pallas kernel has no VJP): a call
    that would record a gradient raises NotImplementedError, for a tensor
    input and for a hyperparameter; under no_grad it runs."""
    _, args, _ = _tile_case(np.random.default_rng(7), 3, 8, 4, 3)
    leaf = args[1].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        tile_ops.tile_eval(args[0], leaf, *args[2:], **_kw(), bf16=True)
    kw = dict(_kw(), scale=torch.tensor(1.2, requires_grad=True))
    with pytest.raises(NotImplementedError, match="forward-only"):
        tile_ops.tile_eval(*args, **kw, bf16=True)
    with torch.no_grad():
        out = tile_ops.tile_eval(args[0], leaf, *args[2:], **_kw(),
                                 bf16=True)
    ref = tile_ops.tile_eval_reference(*args, **_kw(), bf16=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    # the f32 evaluation stays differentiable
    tile_ops.tile_eval(args[0], leaf, *args[2:], **_kw())[2].sum().backward()
    assert leaf.grad is not None


def _f32(x):
    return x.float().double()


def _fma(a, b, c):
    return _f32(a * b + c)


def _kstar_like_kernel(args, d, scale, rng):
    """K* of the active tiles of args as csrc/tile_eval.cu's kstar<D>
    computes it in f32: its operation order, fused multiply-adds where
    nvcc contracts them, and expf off by up to its 2 ulps."""
    tiles = bc.tiles_of(args, bc.active(args[0]))
    seg = tiles[0].long()
    x, q = tiles[2][seg].double(), tiles[6].double()
    a = _f32(torch.tensor(math.sqrt(3.0) / scale, dtype=torch.float64))
    a2 = _f32(a * a)
    dd = [_f32(x[:, i, :, None] - q[:, i, None, :]) for i in range(d)]
    r2 = _f32(dd[0] * dd[0])
    for i in range(1, d):
        r2 = _fma(dd[i], dd[i], r2)
    r = _f32(torch.sqrt(r2))
    e = _f32(torch.exp(-_f32(a * r)))
    e = _f32(e * (1.0 + torch.as_tensor(rng.uniform(-2, 2, e.shape))
                  * 2.0 ** -23))
    inv_r = torch.where(r > 0, _f32(1.0 / torch.where(r > 0, r, 1.0)), 0.0)
    vm = (tiles[5][seg] > 0.5).double()[:, :, None]
    gm = vm * (tiles[4][seg] > 0.5).double()[:, :, None]
    m, t = r.shape[-2:]
    out = torch.zeros(r.shape[0], m * (1 + d), t * (1 + d),
                      dtype=torch.float64)
    for rb in range(1 + d):
        for cb in range(1 + d):
            if rb == 0 and cb == 0:
                v = _f32(_fma(a, r, 1.0) * e) * vm
            elif rb == 0:
                v = _f32(_f32(a2 * dd[cb - 1]) * e) * vm
            elif cb == 0:
                v = -_f32(_f32(a2 * dd[rb - 1]) * e) * gm
            else:
                p = _f32(_f32(a * dd[rb - 1]) * dd[cb - 1])
                inner = _fma(-p, inv_r, 1.0 if rb == cb else 0.0)
                v = _f32(_f32(a2 * inner) * e) * gm
            out[:, rb * m:(rb + 1) * m, cb * t:(cb + 1) * t] = v
    return out


@pytest.mark.parametrize("d", [2, 3])
def test_kstar_error_bound_covers_f32_evaluations(d):
    """torch's f32 K* and an emulation of the CUDA kernel's lie within
    half of the error bound that decides which K* entries may round to
    other bf16 values, also with queries spread to a r of about 20."""
    rng = np.random.default_rng(3)
    for spread in (1.0, 6.0):
        _, args, _ = _tile_case(np.random.default_rng(50 + d), 4, 40, 64, 6,
                                d=d)
        args = args[:6] + (args[6] * spread,)
        scale = _kw(d)["scale"]
        assert bc.kstar_model_ratio(args, d, scale) <= 0.5
        ks64, err = bc.kstar_f64_and_error(
            bc.tiles_of(args, bc.active(args[0])), d, scale)
        nz = ks64 != 0
        gap = (_kstar_like_kernel(args, d, scale, rng) - ks64).abs()
        assert float((gap / err)[nz].max()) <= 0.5


@pytest.mark.parametrize("d", [2, 3])
def test_bf16_limits_hold_summation_order_and_catch_f32(d):
    """variance_limits on the CPU: the same bf16 product summed in
    float64 lies well within the limits of the plain version (f32 sums),
    and the f32 evaluation (no bf16 rounding) lies outside them."""
    _, args, _ = _tile_case(np.random.default_rng(60 + d), 4, 40, 64, 6,
                            d=d)
    kw = _kw(d)
    t = args[6].shape[-1]
    act = _act(args)
    ref = tile_ops.tile_eval_reference(*args, **kw, bf16=True)
    lims = bc.variance_limits(args, kw, KERNEL_TOL)
    tiles = bc.tiles_of(args, bc.active(args[0]))
    lb = args[1][tiles[0].long()].to(torch.bfloat16).double()
    kb = bc.kstar(tiles, kw["scale"]).to(torch.bfloat16).double()
    vs = torch.matmul(lb, kb).pow(2).sum(-2)
    vf, vg = ref[2].double(), ref[3].double()
    vf[act] = kw["val_const"] - vs[:, :t]
    vg[act] = kw["grad_const"] - vs[:, t:].reshape(-1, d, t)
    assert all(float(x[act].max()) <= 0.01
               for x in bc.shares((None, None, vf, vg), ref, lims))
    f32 = tile_ops.tile_eval_reference(*args, **kw)
    assert all(float(x[act].max()) > 1.0
               for x in bc.shares(f32, ref, lims))
    assert bool(lims[2][act].any()) and not bool(lims[2][act].all())


def test_cpu_mapper_ignores_the_switch(monkeypatch):
    """A GPisMap2D on the CPU gives bitwise the same test() with
    GPISMAP_PALLAS_BF16 on as off, as the JAX mapper does off its
    accelerator; no kernel is launched."""
    import torch_maps
    from test_torch_slice import _queries

    m = torch_maps.built(2, 3)
    q = _queries()
    monkeypatch.delenv("GPISMAP_PALLAS_BF16", raising=False)
    off = m.test(q)
    before = (tile_ops.launches, tile_ops.launches_bf16)
    for value in ("1", "on"):
        monkeypatch.setenv("GPISMAP_PALLAS_BF16", value)
        assert not m._pallas_bf16()
        np.testing.assert_array_equal(m.test(q), off)
    assert (tile_ops.launches, tile_ops.launches_bf16) == before
    assert bool((off[:, 3] < 1.0 + m.p.map_noise_param).any())


def test_map_test_bf16_sharded_matches_unsharded():
    """cluster.map_test(bf16=True) == map_test_sharded(bf16=True) on a
    size-1 mesh, bitwise (map_test_sharded passes bf16 on through its
    keywords); and the variances differ from bf16=False's, so the switch
    reaches the tile evaluation."""
    import torch_maps
    from gpismap_tpu_torch.parallel.mesh import data_mesh
    from test_torch_slice import _queries

    m = torch_maps.built(2, 3)
    qt = torch.as_tensor(_queries())
    kw = dict(m._test_kwargs(), factors=m._get_factors())
    one = tcl.map_test(m.store, m.grid, qt, bf16=True, **kw)
    sharded = tcl.map_test_sharded(m.store, m.grid, qt,
                                   mesh=data_mesh(device="cpu"), bf16=True,
                                   **kw)
    for a, b in zip(one[:4], sharded[:4]):
        assert torch.equal(a, b)
    for a, b in zip(one[4], sharded[4]):
        assert int(a) == int(b)
    f32 = tcl.map_test(m.store, m.grid, qt, **kw)
    assert int(one[4].n_pairs) == int(f32[4].n_pairs) > 0
    assert bool((one[2] != f32[2]).any())


def _cuda_args(seed, m, t, nt, d):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the tile kernel has no "
                    "CPU mode")
    _, args, _ = _tile_case(np.random.default_rng(seed), 6, m, t, nt, d=d)
    return tuple(a.cuda() for a in args)


def _check_bf16_kernel(args, d, jax_gate: bool):
    """One launch of the bf16 kernel on args (counted in launches_bf16,
    not in launches): var_f and var_grad within their limits of the bf16
    plain version (and the f32 kernel outside them somewhere); f and g
    bitwise the f32 kernel's; var_f off the f32 kernel's somewhere; with
    jax_gate, the variances within the JAX package's bf16 gate of the f32
    kernel's. Returns the outputs."""
    before = (tile_ops.launches, tile_ops.launches_bf16)
    out = tile_ops.tile_eval(*args, **_kw(d), bf16=True)
    torch.cuda.synchronize()
    assert (tile_ops.launches, tile_ops.launches_bf16) == (
        before[0], before[1] + 1)
    act = _act(args)
    if not bool(act.any()):
        return out
    ref = tile_ops.tile_eval_reference(*args, **_kw(d), bf16=True)
    lims = bc.variance_limits(args, _kw(d), KERNEL_TOL)
    assert all(float(x[act].max()) <= 1.0
               for x in bc.shares(out, ref, lims))
    assert bc.kstar_model_ratio(args, d, _kw(d)["scale"]) <= 1.0
    f32 = tile_ops.tile_eval(*args, **_kw(d))
    assert max(float(x[act].max()) for x in bc.shares(f32, ref, lims)) > 1.0
    for name, a, b in zip(("f", "g"), out[:2], f32[:2]):
        assert torch.equal(a[act], b[act]), name
    assert bool((out[2][act] != f32[2][act]).any())
    if jax_gate:
        assert float((out[2][act] - f32[2][act]).abs().max()) < BF16_VF_TOL
        assert float((out[3][act] - f32[3][act]).abs().max()) < BF16_VG_TOL
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,t,nt", [
    (2, 16, 8, 6), (2, 13, 40, 5), (2, 40, 100, 9), (2, 128, 256, 40),
    (3, 16, 8, 6), (3, 13, 40, 5), (3, 40, 100, 9), (3, 64, 200, 4),
    (3, 320, 128, 24), (2, 16, 8, 1)])
def test_cuda_bf16_kernel_matches_plain_version(d, m, t, nt):
    """The bf16 kernel on the card: tests/test_pallas.py's shape (M=16,
    T=8; there also the JAX gate against the f32 kernel), ragged sizes
    (M=13: MP=39 or 52, not a multiple of 4 at d=2 (the scalar L^-1
    loads) nor of the 128-row panel; T(1+D) not a multiple of the 128
    columns of a block), T=200 at d=3 (a column block straddling two
    derivative blocks), the production shapes (d=2 M=128 T=256, d=3
    M=320 T=128) and a plan whose one tile is inactive."""
    args = _cuda_args(100 * d + m, m, t, nt, d)
    _check_bf16_kernel(args, d, jax_gate=(m, t) == (16, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,t", [(2, 128, 256), (3, 320, 128)])
def test_cuda_bf16_kernel_is_deterministic_and_batch_independent(d, m, t):
    """At the production shapes: two calls bitwise equal, a tile alone
    bitwise as inside the batch, and a permuted batch of tiles bitwise
    the permuted outputs (no atomics, fixed summation order)."""
    args = _cuda_args(17 + d, m, t, 24, d)
    out = _check_bf16_kernel(args, d, jax_gate=False)
    again = tile_ops.tile_eval(*args, **_kw(d), bf16=True)
    act = _act(args)
    for a, b in zip(out, again):
        assert torch.equal(a[act], b[act])
    for i in (0, 7, 22):
        one = (args[0][i:i + 1],) + args[1:6] + (args[6][i:i + 1],)
        alone = tile_ops.tile_eval(*one, **_kw(d), bf16=True)
        for a, b in zip(out, alone):
            assert torch.equal(a[i:i + 1], b)
    perm = torch.randperm(args[0].shape[0],
                          generator=torch.Generator().manual_seed(0)).cuda()
    shuf = (args[0][perm],) + args[1:6] + (args[6][perm].contiguous(),)
    moved = tile_ops.tile_eval(*shuf, **_kw(d), bf16=True)
    pa = act[perm]
    for a, b in zip(out, moved):
        assert torch.equal(a[perm][pa], b[pa])


class _FailingLaunch:
    """The bf16 kernel's library with its launch refused (CUDA error 2)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def tile_eval_bf16_launch(*args):
        return 2


@pytest.mark.cuda
def test_cuda_bf16_launch_failure_raises(monkeypatch):
    """A refused bf16 launch raises, names the variant and its shared
    memory, and counts nothing: no fallback to the f32 kernel."""
    args = _cuda_args(5, 16, 8, 6, 2)
    lib = _FailingLaunch(tile_ops._lib_bf16())
    monkeypatch.setattr(tile_ops, "_lib_bf16", lambda: lib)
    before = (tile_ops.launches, tile_ops.launches_bf16)
    with pytest.raises(RuntimeError, match="bf16 kernel launch failed"):
        tile_ops.tile_eval(*args, **_kw(2), bf16=True)
    assert (tile_ops.launches, tile_ops.launches_bf16) == before
