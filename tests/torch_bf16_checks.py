"""Checks of the tile evaluation's bf16 variant (not a test file): which
K* columns two correct f32 evaluations may round to different bf16
values, and how far a correct bf16 variance may lie from the bf16 plain
version's. tests/test_torch_bf16.py and chip_smoke.py phase 17 share
them; they import torch and the port only.

Two correct evaluations of the variant (the CUDA kernel and the plain
version) differ in two ways:

- A K* entry. Both compute it in f32 with other operations (the
  kernel's expf, operation order and fused multiply-adds against
  torch's), so they may differ by a few f32 roundings of the entry's
  terms, and where a bf16 rounding boundary lies that close, round the
  entry to neighbouring bf16 values. kstar_f64_and_error bounds an f32
  evaluation's error of an entry by KSTAR_ERR_ULPS unit roundoffs of its
  largest term, times 2 + a r (the exponential turns r's relative error
  into a r times as much). On the second-derivative diagonal a^2 e and
  a^3 dx^2 e / r cancel, so the term there is at least a^2 e even where
  the entry is near 0.
- The order of the f32 sums of V = L~ K~ (L~, K~ the bf16 operands,
  whose products are exact in f32) and of colsum(V^2). A sum's error is
  a few roundings of the sum of its terms' magnitudes, so column j's
  variance may move by about u c_j, c_j = sum_i |V_ij| A_ij with
  A = |L~| |K~|. c_j is at least colsum(V^2), and far more where L^-1 is
  ill-conditioned and V's sums cancel.

variance_limits turns both into a limit per variance of column j:
  tol c_j + 2 sum_i |V_ij| B_ij + sum_i B_ij^2,   B = 2^-7 |L~| |K~_amb|,
K~_amb holding K~'s ambiguous entries (0 elsewhere): an entry rounded
the other way moves by one bf16 step, at most 2^-7 of its magnitude.
"""
import math

import numpy as np
import torch

from gpismap_tpu_torch.ops import gp, kernels

# unit roundoff of f32
U32 = 2.0 ** -24
# f32 roundings of its largest term that one evaluation of a K* entry
# may be off by, times 2 + a r (tests/test_torch_bf16.py reads how much
# of it torch's evaluation and an emulation of the CUDA kernel's use)
KSTAR_ERR_ULPS = 16
# one bf16 step relative to the magnitude of the value it rounds, at most
BF16_STEP = 2.0 ** -7
# active tiles per chunk of the float64 and |L~| |K~| work
CHUNK = 32


def active(tile_seg: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(tile_seg >= 0).reshape(-1)


def tiles_of(args, tiles: torch.Tensor):
    """The tile arguments restricted to `tiles` (active ones)."""
    return (args[0][tiles],) + tuple(args[1:6]) + (args[6][tiles],)


def kstar(args, scale, dtype=None) -> torch.Tensor:
    """The plain version's K* [A, MP, T(1+d)] of the tiles of args (all
    active), with the inputs cast to dtype (default: as given)."""
    tile_seg, _, xt, _, gradflag, valid, qt = args
    seg = tile_seg.long()
    x = xt[seg].transpose(-1, -2)
    q = qt.transpose(-1, -2)
    if dtype is not None:
        x, q = x.to(dtype), q.to(dtype)
    return kernels.matern32_deriv_cross_cov(
        x, gradflag[seg] > 0.5, valid[seg] > 0.5, q, scale)


def kstar_f64_and_error(args, d: int, scale):
    """(K* in float64, the bound on an f32 evaluation's error of each
    entry), both [A, MP, T(1+d)], over the tiles of args (all active).
    Masked rows are exact zeros in every evaluation; their bound is 0."""
    tile_seg, _, xt, _, gradflag, valid, qt = args
    seg = tile_seg.long()
    ks = kstar(args, scale, torch.float64)
    x = xt[seg].double()                                 # [A, d, M]
    q = qt.double()                                      # [A, d, T]
    diff = x[:, :, :, None] - q[:, :, None, :]           # [A, d, M, T]
    r = torch.sqrt(torch.sum(diff * diff, dim=1))        # [A, M, T]
    a = math.sqrt(3.0) / float(scale)
    m, t = r.shape[-2:]
    term = ks.abs()
    gm = (gradflag[seg] > 0.5) & (valid[seg] > 0.5)
    a2e = (a * a) * torch.exp(-a * r) * gm[:, :, None]
    for i in range(1, 1 + d):
        term[:, i * m:(i + 1) * m, i * t:(i + 1) * t] += a2e
    growth = (2.0 + a * r).repeat(1, 1 + d, 1 + d)
    return ks, KSTAR_ERR_ULPS * U32 * growth * term


def ambiguous_entries(ks64: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """The K* entries whose f32 evaluations within err of the float64
    value may round to different bf16 values: a bf16 rounding boundary
    lies in [ks64 - err, ks64 + err]. (f32 rounding is monotone, so every
    f32 value of that interval lies in [f32(lo), f32(hi)].)"""
    lo = (ks64 - err).float().to(torch.bfloat16)
    hi = (ks64 + err).float().to(torch.bfloat16)
    return (lo != hi) & (ks64 != 0)


def kstar_model_ratio(args, d: int, scale) -> float:
    """The largest |K*_f32 - K*_f64| / (its error bound) over the nonzero
    K* entries of the active tiles, K*_f32 the plain version's on args'
    device: at most 1 where the bound holds for that evaluation."""
    act = active(args[0])
    worst = 0.0
    for s in range(0, act.numel(), CHUNK):
        part = tiles_of(args, act[s:s + CHUNK])
        ks64, err = kstar_f64_and_error(part, d, scale)
        gap = (kstar(part, scale).double() - ks64).abs()
        nz = ks64 != 0
        if bool(nz.any()):
            worst = max(worst, float((gap / err)[nz].max()))
    return worst


def variance_limits(args, kwargs, tol: float):
    """(lim_vf [NT, T], lim_vg [NT, d, T], ambiguous columns
    [NT, 1 + d, T]): how far a correct bf16 evaluation's var_f and
    var_grad may lie from the bf16 plain version's on the tile arguments
    args (the module docstring), tol the summation-order part relative
    to c_j; a column is ambiguous where one of its K* entries is. Zero
    and False on inactive tiles."""
    d, scale = kwargs["d"], kwargs["scale"]
    nt, _, t = args[6].shape
    dev = args[6].device
    lim = torch.zeros((nt, (1 + d) * t), dtype=torch.float64, device=dev)
    amb_cols = torch.zeros((nt, (1 + d) * t), dtype=torch.bool, device=dev)
    act = active(args[0])
    for s in range(0, act.numel(), CHUNK):
        tiles = act[s:s + CHUNK]
        part = tiles_of(args, tiles)
        amb = ambiguous_entries(*kstar_f64_and_error(part, d, scale))
        lb = args[1][part[0].long()].to(torch.bfloat16).float()
        kb = kstar(part, scale).to(torch.bfloat16).float()
        v = torch.matmul(lb, kb).abs_().double()
        lb.abs_()
        kb.abs_()
        mag = torch.matmul(lb, kb).double()
        step = BF16_STEP * torch.matmul(lb, kb * amb).double()
        lim[tiles] = (tol * torch.sum(v * mag, dim=-2)
                      + 2.0 * torch.sum(v * step, dim=-2)
                      + torch.sum(step * step, dim=-2))
        amb_cols[tiles] = amb.any(dim=1)
    return (lim[:, :t], lim[:, t:].reshape(nt, d, t),
            amb_cols.reshape(nt, 1 + d, t))


def shares(out, ref, lims):
    """(var_f [NT, T], var_grad [NT, d, T]): |out - ref| over its limit
    (out, ref: tile_eval outputs; lims: variance_limits'); a bf16
    evaluation is within its limits where every share is at most 1.
    Read them on the active tiles only."""
    return tuple((a.double() - b.double()).abs() / lim.clamp(min=1e-300)
                 for a, b, lim in zip(out[2:], ref[2:], lims[:2]))


def masked_plan(rng, d: int, m: int, t: int, nt: int, cells, scale,
                device="cpu"):
    """Tile arguments (tile_seg, linv, xt, alpha, gradflag, valid, qt) of
    one cluster cell per entry (n, grad_share) of cells, laid out as the
    mapper lays them out: n valid nodes in the slot's first rows
    (models/cluster.py gathers the support into a prefix), a random
    grad_share of them with gradient rows (the others get gradient noise
    0.2, past ongpis_prepare's 0.1001); their train covariance factored
    on `device` into L^-1. nt tiles of t random queries over random
    cells, the last tile inactive. Nodes and queries lie in [-1, 1]^d."""
    s = len(cells)
    x = rng.uniform(-1, 1, (s, m, d)).astype(np.float32)
    grad = rng.normal(size=(s, m, d)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    valid = np.zeros((s, m), bool)
    siggrad = np.full((s, m), 0.05, np.float32)
    for c, (n, share) in enumerate(cells):
        valid[c, :n] = True
        siggrad[c, :n][rng.uniform(size=n) >= share] = 0.2
    tv = torch.as_tensor(valid, device=device)
    tx = torch.as_tensor(x, device=device)
    gf, sx = gp.ongpis_prepare(torch.as_tensor(grad, device=device),
                               torch.full((s, m), 0.05, device=device),
                               torch.as_tensor(siggrad, device=device), tv)
    k = kernels.matern32_deriv_train_cov(
        tx, sx, torch.as_tensor(siggrad, device=device), gf, tv, scale)
    linv = gp.linv_from_chol(torch.linalg.cholesky(k).contiguous())
    segs = rng.integers(0, s, nt).astype(np.int32)
    segs[-1] = -1
    q = rng.uniform(-1, 1, (nt, d, t)).astype(np.float32)
    alpha = rng.normal(size=(s, m * (1 + d))).astype(np.float32)
    return (torch.as_tensor(segs, device=device), linv,
            tx.transpose(-1, -2).contiguous(),
            torch.as_tensor(alpha, device=device), gf.float(), tv.float(),
            torch.as_tensor(q, device=device))
