"""The tile evaluation's gradient in the PyTorch port: the closed-form VJP
tile_eval_vjp_reference (the backward kernels' plain twin) against
autograd through the plain version (tile_eval_backward) in float64 and
against jax.vjp of the JAX package's XLA twin _ongpis_eval_tile in
float32; and (on a CUDA card only) the backward kernels
(csrc/tile_eval_backward.cu, through _launch_backward and the tile
Function) against the twin. On a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tile_backward.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402
from gpismap_tpu_torch.ops import kernels as tk  # noqa: E402
from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402

SCALE, VAL_CONST, GRAD_CONST = 1.2, 1.01, 3.0 / 1.44 + 0.1
NAMES = ("linv", "xt", "alpha", "qt", "scale", "val_const", "grad_const")
# the tile plan: cells interleaved, tile 2 inactive, cell 3 unused
SEG = [2, 0, -1, 2, 1, 0]
# subsets of the 7 gradients (NAMES order), each with or without a
# cotangent of the variances: all; the render's (alpha, scale, grad_const
# and linv, the variances off the loss); linv alone
NEEDS = {"all": ((True,) * 7, True),
         "render": ((True, False, True, False, True, False, True), False),
         "linv": ((True,) + (False,) * 6, True)}


def _case(d, seed, m=16, t=8, s=4, seg=SEG, dtype=torch.float64):
    """A masked cluster store of s cells of m nodes (cell 1 without
    gradient rows, nodes 0-2 of every cell without gradients, about a
    fifth of the nodes invalid), its L^-1 factors and len(seg) tiles of t
    queries, from a numpy seed: (store as numpy, tile-op args)."""
    rng = np.random.default_rng(seed)
    mp = m * (1 + d)
    x = rng.uniform(-1, 1, (s, m, d))
    grad = rng.normal(size=(s, m, d))
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    grad[:, :3] = 0.0
    grad[1] = 0.0
    valid = rng.uniform(size=(s, m)) > 0.2
    q = rng.uniform(-1, 1, (len(seg), t, d))
    store = dict(x=x.astype(np.float32), grad=grad.astype(np.float32),
                 val=np.full((s, m), -0.2, np.float32),
                 sigx=np.full((s, m), 0.05, np.float32),
                 siggrad=np.full((s, m), 0.05, np.float32), valid=valid,
                 alpha=rng.normal(size=(s, mp)).astype(np.float32),
                 trained=np.ones(s, bool))
    tt = {k: torch.as_tensor(v) for k, v in store.items()}
    gf, sx = tgp.ongpis_prepare(tt["grad"], tt["sigx"], tt["siggrad"],
                                tt["valid"])
    k = tk.matern32_deriv_train_cov(tt["x"].double(), sx.double(),
                                    tt["siggrad"].double(), gf, tt["valid"],
                                    SCALE)
    linv = tgp.linv_from_chol(torch.linalg.cholesky(k))
    store["linv"] = np.ascontiguousarray(linv.float().numpy())
    args = (torch.tensor(seg, dtype=torch.int32),
            torch.as_tensor(store["linv"]).to(dtype),
            tt["x"].transpose(-1, -2).contiguous().to(dtype),
            tt["alpha"].to(dtype), gf.to(dtype), tt["valid"].to(dtype),
            torch.as_tensor(q).transpose(-1, -2).contiguous().to(dtype))
    return store, args


def _hyper(dtype=torch.float64, device="cpu"):
    return [torch.tensor(v, dtype=dtype, device=device)
            for v in (SCALE, VAL_CONST, GRAD_CONST)]


def _cotangents(args, d, seed, with_var):
    """Random cotangents of (f, g, vf, vg), NaN on inactive tiles (as the
    kernel's unwritten outputs may hold); zero variance cotangents
    without with_var."""
    nt, _, t = args[6].shape
    gen = torch.Generator().manual_seed(seed)
    shapes = ((nt, t), (nt, d, t), (nt, t), (nt, d, t))
    grads = [torch.randn(sh, generator=gen, dtype=torch.float64)
             .to(args[1].device, args[1].dtype) for sh in shapes]
    if not with_var:
        grads[2].zero_()
        grads[3].zero_()
    for g in grads:
        g[args[0] < 0] = torch.nan
    return grads


@pytest.mark.parametrize("case", list(NEEDS))
@pytest.mark.parametrize("d", [2, 3])
def test_vjp_reference_matches_autograd_of_plain(d, case, monkeypatch):
    """tile_eval_vjp_reference == tile_eval_backward (autograd through
    the plain version) in float64 within 1e-10, for each needs subset,
    with cells interleaved in the plan, an inactive tile whose NaN
    cotangents reach nothing and nodes without gradient rows; the twin in
    one chunk and in chunks of 2 tiles. Without a cotangent of the
    variances (None) the twin gives what zero cotangents give."""
    needs, with_var = NEEDS[case]
    _, args = _case(d, seed=10 + d)
    hyper = _hyper()
    grads = _cotangents(args, d, seed=d, with_var=with_var)
    want = tile_ops.tile_eval_backward(*args, d, *hyper, grads, needs)
    runs = [grads] if with_var else [grads, grads[:2] + [None, None]]
    for chunk_tiles in (0, 2):
        if chunk_tiles:
            monkeypatch.setattr(tile_ops, "_BACKWARD_CHUNK_BYTES",
                                chunk_tiles * args[1][0].numel()
                                * args[1].element_size())
        for gs in runs:
            got = tile_ops.tile_eval_vjp_reference(*args, d, *hyper, gs,
                                                   needs)
            for name, a, b, n in zip(NAMES, got, want, needs):
                if not n:
                    assert a is None and b is None, name
                    continue
                torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10,
                                           msg=name)
    # dL is nonzero only through the variances' cotangents
    assert (float(want[0].abs().max()) > 0) == with_var


def _jax_vjp(store, args, d, grads):
    """jax.vjp of gpismap_tpu.models.cluster._ongpis_eval_tile with scale
    traced, at the store and plan of args, for each cotangent set of
    grads (one jit): the gradients of (linv, xt, alpha, qt, scale,
    val_const, grad_const) in the port's layouts."""
    import jax
    import jax.numpy as jnp
    from gpismap_tpu.models import cluster as jcl

    jstore = jcl.ClusterStore(**{k: jnp.asarray(store[k]) for k in (
        "x", "grad", "val", "sigx", "siggrad", "valid", "alpha", "trained")})
    seg = args[0].numpy()
    act = seg >= 0
    slot_of = jnp.arange(len(store["x"]), dtype=jnp.int32)
    segs = jnp.asarray(np.where(act, seg, 0).astype(np.int32))

    def fn(linv, x, alpha, q, scale, vc, gc):
        st = jstore._replace(x=x, alpha=alpha)
        return jcl._ongpis_eval_tile(st, linv, slot_of, segs, q, scale, vc,
                                     gc)

    @jax.jit
    def vjp(primals, cot):
        return jax.vjp(fn, *primals)[1](cot)

    q = args[6].numpy().transpose(0, 2, 1)
    primals = (jnp.asarray(store["linv"]), jstore.x, jstore.alpha,
               jnp.asarray(q), jnp.float32(SCALE), jnp.float32(VAL_CONST),
               jnp.float32(GRAD_CONST))
    out = []
    for gs in grads:
        cot = [np.where(act.reshape((-1,) + (1,) * (g.dim() - 1)),
                        g.numpy(), 0.0).astype(np.float32) for g in gs]
        cot = (cot[0], cot[1].transpose(0, 2, 1), cot[2],
               cot[3].transpose(0, 2, 1))
        res = [np.asarray(g) for g in vjp(primals, tuple(
            jnp.asarray(c) for c in cot))]
        res[1] = res[1].transpose(0, 2, 1)
        res[3] = res[3].transpose(0, 2, 1)
        out.append(res)
    return out


@pytest.mark.parametrize("d", [2, 3])
def test_vjp_reference_matches_jax_vjp(d):
    """tile_eval_vjp_reference in float32 == jax.vjp of the JAX package's
    _ongpis_eval_tile on the same numpy-seeded inputs, within 1e-4 of each
    gradient's largest magnitude (f32 rounding order only, PARITY.md),
    for each needs subset; where JAX's gradient is exactly zero (linv
    without a cotangent of the variances), so is the twin's."""
    pytest.importorskip("jax")
    store, args = _case(d, seed=20 + d, dtype=torch.float32)
    hyper = _hyper(torch.float32)
    cots = {case: _cotangents(args, d, seed=30 + d, with_var=with_var)
            for case, (_, with_var) in NEEDS.items()}
    refs = dict(zip(cots, _jax_vjp(store, args, d, list(cots.values()))))
    for case, (needs, _) in NEEDS.items():
        grads, ref = cots[case], refs[case]
        got = tile_ops.tile_eval_vjp_reference(*args, d, *hyper, grads,
                                               needs)
        for name, a, b, n in zip(NAMES, got, ref, needs):
            if not n:
                continue
            a = a.numpy()
            lim = 1e-4 * float(np.abs(b).max())
            err = float(np.abs(a - b).max())
            assert err <= lim, (case, name, err, lim)


@pytest.mark.parametrize("d", [2, 3])
def test_coincident_pair_keeps_hyper_gradients_finite(d):
    """A query on a support node (r = 0): the gradients of scale, alpha,
    linv and the constants from the twin are finite and equal to
    autograd's through the plain version (float64, 1e-10); xt and qt are
    not differentiated there (the plain version's sqrt backward gives NaN
    at r = 0, as in the JAX package)."""
    _, args = _case(d, seed=40 + d)
    qt = args[6].clone()
    qt[0, :, 3] = args[2][SEG[0], :, 5]         # query 3 on node 5
    qt[3, :, 0] = args[2][SEG[3], :, 0]         # query 0 on node 0
    args = args[:6] + (qt,)
    needs = (True, False, True, False, True, True, True)
    hyper = _hyper()
    grads = _cotangents(args, d, seed=d, with_var=True)
    want = tile_ops.tile_eval_backward(*args, d, *hyper, grads, needs)
    got = tile_ops.tile_eval_vjp_reference(*args, d, *hyper, grads, needs)
    for name, a, b, n in zip(NAMES, got, want, needs):
        if not n:
            continue
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)


def test_chunks_keep_whole_cells_within_the_cap():
    """The backward's chunk plan: runs of consecutive cells within the
    cap; a cell over the cap runs alone."""
    assert tile_ops._chunks([3, 3, 3], 6) == [(0, 2), (2, 3)]
    assert tile_ops._chunks([9, 1, 1], 6) == [(0, 1), (1, 3)]
    assert tile_ops._chunks([0, 0], 6) == [(0, 2)]
    assert tile_ops._chunks([], 6) == []


# ---------------------------------------------------------------------------
# the backward kernels on the card

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the backward kernels "
                    "have no CPU mode; their twin is checked above")


def _cuda_case(d, m, t, nt, seed):
    """_case on the card in float32, nt tiles over 6 cells (the last
    tile inactive, cells interleaved)."""
    seg = [(3 * i + 1) % 6 for i in range(nt - 1)] + [-1]
    _, args = _case(d, seed, m=m, t=t, s=6, seg=seg, dtype=torch.float32)
    return tuple(a.cuda() for a in args)


def _counts():
    return dict(tile_ops.launches_backward_by_kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(NEEDS))
@pytest.mark.parametrize("d,m,t,nt", [(2, 16, 8, 6), (3, 16, 8, 6),
                                      (2, 128, 256, 12), (3, 320, 128, 8),
                                      (3, 13, 40, 5)])
def test_cuda_kernels_match_vjp_reference(d, m, t, nt, case):
    """The backward kernels (_launch_backward) == tile_eval_vjp_reference
    on the card within 1e-4 of each gradient's largest magnitude (f32
    summation order only), at the tests' shapes, the 2D and 3D
    production shapes (M=128, T=256; M=320, T=128) and a ragged one (MP
    not a multiple of 4); bitwise equal in two runs; each kernel's
    launches counted. Without a cotangent of the variances the Z and dL
    kernels do not launch and dL is exactly zero."""
    _need_cuda()
    needs, with_var = NEEDS[case]
    args = _cuda_case(d, m, t, nt, seed=m + d)
    hyper = _hyper(torch.float32, "cuda")
    grads = _cotangents(args, d, seed=7, with_var=with_var)
    runs = [grads] if with_var else [grads, grads[:2] + [None, None]]
    for gs in runs:
        before = _counts()
        got = tile_ops._launch_backward(*args, d, *hyper, gs, needs)
        again = tile_ops._launch_backward(*args, d, *hyper, gs, needs)
        torch.cuda.synchronize()
        n = {k: (v - before[k]) // 2 for k, v in _counts().items()}
        ref = tile_ops.tile_eval_vjp_reference(*args, d, *hyper, gs, needs)
        for name, a, b, w, c in zip(NAMES, got, ref, needs, again):
            if not w:
                assert a is None, name
                continue
            assert torch.equal(a, c), name
            lim = 1e-4 * float(b.abs().max())
            assert float((a - b).abs().max()) <= lim, name
        z_runs = gs[2] is not None
        assert n == {"z": int(z_runs), "linv": int(z_runs),
                     "kstar": int(any(needs[1:5]))}, n
        if not with_var:
            assert float(got[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 3])
def test_cuda_function_backward_runs_the_kernels(d, monkeypatch):
    """tile_eval on the card differentiates through the backward kernels
    only: launches_backward grows, tile_eval_backward and the plain
    version are never called, and the gradients agree with autograd
    through the plain version within 1e-3 of their largest magnitude."""
    _need_cuda()
    args = _cuda_case(d, 16, 8, 6, seed=50 + d)
    leaves = [args[i].clone().requires_grad_() for i in (1, 2, 3, 6)]
    hl = [h.requires_grad_() for h in _hyper(torch.float32, "cuda")]
    act = args[0] >= 0

    def loss(fn):
        out = fn(args[0], leaves[0], leaves[1], leaves[2], args[4], args[5],
                 leaves[3], d, *hl)
        return sum((o[act] * (i + 1)).sum() for i, o in enumerate(out))

    want = torch.autograd.grad(loss(tile_ops.tile_eval_reference),
                               leaves + hl)

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card path")

    monkeypatch.setattr(tile_ops, "tile_eval_backward", refuse)
    monkeypatch.setattr(tile_ops, "tile_eval_reference", refuse)
    n0 = tile_ops.launches_backward
    got = torch.autograd.grad(loss(tile_ops.tile_eval), leaves + hl)
    assert tile_ops.launches_backward == n0 + 3
    for name, a, b in zip(NAMES, got, want):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), \
            name
