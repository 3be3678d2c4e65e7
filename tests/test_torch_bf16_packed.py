"""The bf16 tile kernel's kept-stage packing (ops/tile_eval.py): the list
of kept 16-row stages against a brute force, the packed plain evaluation
against the bf16 plain version on the CPU, and (on a CUDA card only) the
kernel against both.

A stage of K* is kept if one of its 16 rows is an f row of a valid node
or a gradient row of a node with gradflag * valid; the others add exact
zeros to V = L~ K~ (their K* rows are zero, and their rows and columns of
L^-1 the identity's). So the packed evaluation gives the same f and g,
and variances that differ only by the order of the f32 sums. Tolerance:
each sum of MP exact bf16 products is off by at most gamma_MP = MP u of
the sum of its terms' magnitudes A = |L~| |K~|, so colsum(V^2) moves by
at most 3 MP u c_j with c_j = sum_i |V_ij| A_ij in each evaluation;
the test allows 6 MP u c_j between the two.

CUDA cases run on a GPU host without jax:
    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_bf16_packed.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gpismap_tpu_torch.ops import tile_eval as tile_ops  # noqa: E402
import torch_bf16_checks as bc  # noqa: E402

SCALE, VAL_CONST, GRAD_CONST = 1.2, 1.01, 3.0 / 1.44 + 0.1
U32 = 2.0 ** -24
# bf16 kernel vs the bf16 plain version on the card (tests/test_torch_bf16.py)
KERNEL_TOL = 1e-4
# cells (valid nodes, share of them with gradient rows): ragged, with
# gradient-free nodes, empty, full
CELLS = {13: [(5, 1.0), (9, 0.5), (0, 1.0), (13, 1.0)],
         40: [(17, 1.0), (33, 0.4), (0, 1.0), (40, 1.0), (1, 0.0)]}


def _kw(d):
    return dict(d=d, scale=SCALE, val_const=VAL_CONST, grad_const=GRAD_CONST)


def _kept_brute(valid, gradflag, d):
    """The kept stages of each slot by a loop over the rows."""
    s, m = valid.shape
    mp = m * (1 + d)
    out = []
    for c in range(s):
        rows = [bool(valid[c, r % m]) if r < m
                else bool(valid[c, r % m] and gradflag[c, r % m])
                for r in range(mp)]
        out.append([j for j in range(-(-mp // 16))
                    if any(rows[16 * j:16 * j + 16])])
    return out


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("m", [13, 16, 40])
def test_kept_stages_match_brute_force(d, m):
    """Slots with ragged n, gradient-free nodes, empty and full, and M %
    16 != 0 (M = 13, 40: MP not a multiple of 16): the ascending kept
    stages, -1 after them, and their count."""
    rng = np.random.default_rng(m + d)
    valid = np.zeros((6, m), bool)
    gradflag = np.zeros((6, m), bool)
    for c, n in enumerate((0, m, m // 2, 1, 3, m - 1)):
        valid[c, :n] = True
        gradflag[c, :n] = rng.uniform(size=n) < (0.0 if c == 3 else 0.6)
    gradflag[1] = True                       # full
    valid[4, m - 1] = True                   # a node past a gap
    stages, count = tile_ops.kept_stages(torch.as_tensor(valid).float(),
                                         torch.as_tensor(gradflag).float(), d)
    ns = -(-m * (1 + d) // 16)
    assert stages.shape == (6, ns) and stages.dtype == torch.int32
    assert count.dtype == torch.int32
    for c, want in enumerate(_kept_brute(valid, gradflag, d)):
        assert int(count[c]) == len(want)
        assert stages[c].tolist() == want + [-1] * (ns - len(want))
    assert int(count[0]) == 0 and int(count[1]) == ns


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("m", [13, 40])
def test_packed_reference_matches_bf16_reference(d, m):
    """tile_eval_packed_reference vs tile_eval_reference(bf16=True) on
    cells laid out as the mapper lays them out: f and g bitwise, var_f
    and var_grad within 6 MP u c_j (the module docstring); the empty
    cell's variances are the constants; and some stages were skipped."""
    args = bc.masked_plan(np.random.default_rng(7 * m + d), d, m, 24, 12,
                          CELLS[m], SCALE)
    kw = _kw(d)
    ref = tile_ops.tile_eval_reference(*args, **kw, bf16=True)
    out = tile_ops.tile_eval_packed_reference(*args, **kw)
    for a, b in zip(out[:2], ref[:2]):
        assert torch.equal(a, b)
    act = args[0] >= 0
    tiles = bc.tiles_of(args, bc.active(args[0]))
    lb = args[1][tiles[0].long()].to(torch.bfloat16).double()
    kb = bc.kstar(tiles, SCALE).to(torch.bfloat16).double()
    c = (torch.matmul(lb, kb).abs() * torch.matmul(lb.abs(), kb.abs())
         ).sum(-2)
    t = args[6].shape[-1]
    mp = m * (1 + d)
    lim = 6 * mp * U32 * c
    for a, b, lim_ in ((out[2], ref[2], lim[:, :t]),
                       (out[3], ref[3], lim[:, t:].reshape(-1, d, t))):
        gap = (a[act].double() - b[act].double()).abs()
        assert bool((gap <= lim_).all()), float((gap - lim_).max())
    empty = args[0] == 2                    # the empty cell
    assert bool(empty.any())
    assert bool((out[2][empty] == VAL_CONST).all())
    assert bool((out[3][empty] == GRAD_CONST).all())
    _, count = tile_ops.kept_stages(args[5], args[4], d)
    assert int(count.sum()) < len(CELLS[m]) * (-(-mp // 16))


def _check_kernel(args, d):
    """One launch of the bf16 kernel on args: counted in launches_bf16;
    f and g bitwise the f32 kernel's; every variance within its limit of
    the bf16 plain version (tests/test_torch_bf16.py) and within 6 MP u
    c_j + that limit of the packed plain version."""
    before = (tile_ops.launches, tile_ops.launches_bf16)
    out = tile_ops.tile_eval(*args, **_kw(d), bf16=True)
    torch.cuda.synchronize()
    assert (tile_ops.launches, tile_ops.launches_bf16) == (
        before[0], before[1] + 1)
    act = args[0] >= 0
    f32 = tile_ops.tile_eval(*args, **_kw(d))
    for a, b in zip(out[:2], f32[:2]):
        assert torch.equal(a[act], b[act])
    lims = bc.variance_limits(args, _kw(d), KERNEL_TOL)
    for ref in (tile_ops.tile_eval_reference(*args, **_kw(d), bf16=True),
                tile_ops.tile_eval_packed_reference(*args, **_kw(d))):
        assert all(float(x[act].max()) <= 1.0
                   for x in bc.shares(out, ref, lims))


@pytest.mark.cuda
@pytest.mark.parametrize("d,m", [(2, 13), (2, 40), (3, 13), (3, 40),
                                 (2, 128), (3, 320)])
def test_cuda_bf16_kernel_on_packed_cells(d, m):
    """The bf16 kernel on the card on mapper-like cells (ragged, with
    gradient-free nodes, empty, full; at M = 128 and 320 the production
    widths) against the bf16 plain version and the packed one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the tile kernel has no "
                    "CPU mode")
    cells = CELLS.get(m, [(m // 3, 1.0), (m, 1.0), (0, 1.0),
                          (m // 2, 0.5)])
    args = bc.masked_plan(np.random.default_rng(m + d), d, m,
                          128 if d == 3 else 256, 12, cells, SCALE,
                          device="cuda")
    _check_kernel(args, d)
