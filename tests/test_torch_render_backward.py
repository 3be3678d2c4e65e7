"""The PyTorch port's autograd Functions of the three kernels (_Chol,
_Linv, _TileEval): their backward formulas against torch.autograd
through the plain versions in float64 on the CPU, their routing of each
gradient, and (on a CUDA card only) the Functions themselves against
autograd through the plain versions. These tests need no map; the render
tests are in tests/test_torch_render.py and
tests/test_torch_render_hyper.py. On a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_render_backward.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.ops import chol as chol_ops  # noqa: E402
from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402


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
    stood in by the plain versions (the tile backward's by its closed-form
    twin, tile_eval_vjp_reference): the gradients of each input reach the
    right slot, through the closed forms; the autograd recompute
    (tile_eval_backward) is never reached."""
    calls = []

    def fake_factor(name, x):
        calls.append(name)
        f = (chol_ops.chol_reference if name == "chol"
             else chol_ops.linv_reference)
        return f(x), True

    def fake_tile(*args):
        calls.append("tile")
        return tile_ops.tile_eval_reference(*args)

    def fake_tile_backward(*args):
        calls.append("tile backward")
        return tile_ops.tile_eval_vjp_reference(*args)

    def refuse(*args, **kwargs):
        raise AssertionError("the tile Function reached tile_eval_backward")

    monkeypatch.setattr(chol_ops, "_launch", fake_factor)
    monkeypatch.setattr(tile_ops, "_launch", fake_tile)
    monkeypatch.setattr(tile_ops, "_launch_backward", fake_tile_backward)
    monkeypatch.setattr(tile_ops, "tile_eval_backward", refuse)
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
    assert calls[-2:] == ["tile", "tile backward"]


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
