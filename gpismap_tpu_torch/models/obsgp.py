"""Partitioned 1D observation GP of a LiDAR scan (batched).

Port of the 1D half of gpismap_tpu/models/obsgp.py: the reference trains
one tiny OU-kernel GP per overlapping group of scan samples
(ObsGP.cpp:85-187); here all groups train as one batched Cholesky with
validity masks, and test points evaluate by gathering their group's
precomputed L^-1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ObsGPParam
from ..ops import gp

# sentinel variance of out-of-range / boundary queries (ObsGP.cpp:161)
_PAD_INVALID = 1e6


class ObsGP1DState(NamedTuple):
    """Batched partitioned 1D scan GP (reference: ObsGP.h:81-102)."""

    x: torch.Tensor          # [G, M, 1] per-group angles
    valid: torch.Tensor      # [G, M]
    alpha: torch.Tensor      # [G, M]
    linv: torch.Tensor       # [G, M, M]
    trained: torch.Tensor    # [G] bool — group exists (g < n_group)
    bounds: torch.Tensor     # [G + 1] group boundary angles, +inf padded
    liml: torch.Tensor       # scalar: bounds[0] + margin
    limr: torch.Tensor       # scalar: last bound - margin
    any_trained: torch.Tensor  # scalar bool — nGroup >= 2


def _group_layout(n: torch.Tensor, gs: int, ov: int, g_max: int, m: int):
    """Start index and size of each group (ObsGP.cpp:91-136): nGroup =
    n/gs + 1; all but the last two have size gs+ov starting at g*gs; the
    last two split the remainder (rem in [gs, 2gs)) in half with ov
    overlap. n is a 0-d int tensor. Returns (start [G], size [G],
    n_group)."""
    n_group = n // gs + 1
    g = torch.arange(g_max, device=n.device)
    rem = n - (n_group - 2) * gs
    start = torch.where(g == n_group - 1, (n_group - 2) * gs + rem // 2,
                        g * gs)
    size = torch.where(g < n_group - 2, gs + ov,
                       torch.where(g == n_group - 2, rem // 2 + ov + 1,
                                   rem - rem // 2))
    size = torch.clamp(size, 0, m)
    exists = (g < n_group) & (n_group >= 2)
    size = torch.where(exists, size, 0)
    return start, size, n_group


def fit_obsgp1d(theta: torch.Tensor, f: torch.Tensor, valid: torch.Tensor,
                param: ObsGPParam, g_max: int = 32) -> ObsGP1DState:
    """Train the partitioned 1D observation GP (ObsGP.cpp:85-143).

    theta: [N] beam angles (ascending); f: [N] regression targets
    (1/sqrt(range), GPisMap.cpp:133); valid: [N] range-gate mask.
    Invalid beams are compacted out (stable, valid first) before
    grouping, as the reference's preprocessing drops them
    (GPisMap.cpp:124-143).
    """
    gs, ov = param.group_size, param.overlap
    m = gs + ov  # max group size (see _group_layout)
    dev = theta.device

    nb = theta.shape[0]
    order = torch.argsort((~valid).to(torch.int32), stable=True)
    theta_c = theta[order]
    f_c = f[order]
    n = torch.sum(valid).to(torch.int64)

    start, size, n_group = _group_layout(n, gs, ov, g_max, m)

    ar = torch.arange(m, device=dev)
    idx = start[:, None] + ar[None, :]                      # [G, M]
    in_group = ar[None, :] < size[:, None]
    idx_c = torch.clamp(idx, 0, nb - 1)
    gx = theta_c[idx_c][..., None]                          # [G, M, 1]
    gf = f_c[idx_c]

    st = gp.fit_gpou(gx, gf, in_group, param.scale, param.noise)
    linv = gp.gpou_linv(st.l)

    # boundary angles (ObsGP.cpp:93,102,117,129): bounds[0] = theta[0];
    # interior g: theta[g*gs + gs + ov/2]; g == nG-2: theta[start +
    # rem//2 + ov - ov//2]; last bound: theta[n-1]
    g = torch.arange(g_max, device=dev)
    rem = n - (n_group - 2) * gs
    bidx = torch.where(g < n_group - 2, g * gs + gs + ov - ov // 2,
                       torch.where(g == n_group - 2,
                                   (n_group - 2) * gs + rem // 2 + ov
                                   - ov // 2,
                                   n - 1))
    bidx = torch.where(g == n_group - 1, n - 1, bidx)
    bounds_core = theta_c[torch.clamp(bidx, 0, nb - 1)]
    bounds = torch.cat([theta_c[:1], bounds_core])
    bvalid = torch.arange(g_max + 1, device=dev) <= n_group
    bounds = torch.where(bvalid, bounds, torch.inf)

    liml = bounds[0] + param.margin
    limr = theta_c[torch.clamp(n - 1, 0, nb - 1)] - param.margin
    return ObsGP1DState(
        x=gx, valid=in_group, alpha=st.alpha, linv=linv,
        trained=(g < n_group) & (n_group >= 2) & torch.any(in_group, -1),
        bounds=bounds, liml=liml, limr=limr,
        any_trained=(n_group >= 2) & (n > 0))


def obsgp1d_test(state: ObsGP1DState, q: torch.Tensor, param: ObsGPParam,
                 chunk: int = 4096):
    """Posterior at angles q [Q] (ObsGP.cpp:145-187). Returns (mean [Q],
    var [Q]); out-of-range / boundary-coincident queries get the 1e6
    sentinel (ObsGP.cpp:161)."""
    # owning group: count of interior boundaries strictly below q
    # (the reference walks bounds with strict comparisons, ObsGP.cpp:171-181)
    below = state.bounds[None, 1:] < q[:, None]            # [Q, G]
    gidx = torch.sum(below, dim=-1)
    gidx_c = torch.clamp(gidx, 0, state.bounds.shape[0] - 2)
    lo = state.bounds[gidx_c]
    hi = state.bounds[gidx_c + 1]
    in_margin = (q >= state.liml) & (q <= state.limr)
    strict = (q > lo) & (q < hi)
    ok = in_margin & strict & state.any_trained

    mean, var = gp.gpou_posterior_gather(
        state.x, state.alpha, state.linv, state.valid, state.trained,
        gidx_c, q[:, None], param.scale, param.noise, chunk)
    return (torch.where(ok, mean, 0.0),
            torch.where(ok, var, _PAD_INVALID))
