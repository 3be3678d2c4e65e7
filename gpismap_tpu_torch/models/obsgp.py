"""Partitioned observation GPs of a LiDAR scan (1D) or a depth image (2D).

Port of gpismap_tpu/models/obsgp.py: the reference trains one tiny
OU-kernel GP per overlapping group of scan samples (1D, ObsGP.cpp:85-187)
or per grid cell of a depth image (2D, ObsGP.cpp:193-463); here all
groups train as one batched Cholesky with validity masks, and test points
evaluate by gathering their group's precomputed L^-1 (obsgp2d_test), or,
for queries grouped by a static owning cell, by dense products against
the shifted cell grid (obsgp2d_test_blocked). fit_obsgp2d's c_cap fits
only the nonempty cells.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class ObsGP2DState(NamedTuple):
    """Batched partitioned 2D depth-grid GP (reference: ObsGP.h:105-148)."""

    x: torch.Tensor          # [C, M, 2] per-cell (v, u) inputs
    valid: torch.Tensor      # [C, M]
    alpha: torch.Tensor      # [C, M]
    linv: torch.Tensor       # [C, M, M]
    trained: torch.Tensor    # [C]
    val_i: torch.Tensor      # [nG0 + 1] v boundaries
    val_j: torch.Tensor      # [nG1 + 1] u boundaries


def partition_1axis(n: int, gs: int, ov: int):
    """Static per-axis partition (ObsGP.cpp:204-265). Returns
    (n_groups, i0 [nG], i1 [nG] inclusive, boundary_index [nG])."""
    n_groups = (n - ov) // gs + 1
    i0 = [g * gs for g in range(n_groups)]
    i1 = [g * gs + gs + ov - 1 if g < n_groups - 1 else n - 1
          for g in range(n_groups)]
    # boundary sample: i1 - ov//2 for interior, n-1 for the last
    bnd = [i1[g] - ov // 2 if g < n_groups - 1 else n - 1
           for g in range(n_groups)]
    return n_groups, i0, i1, bnd


def fit_obsgp2d(v_coords: torch.Tensor, u_coords: torch.Tensor,
                f: torch.Tensor, param: ObsGPParam,
                c_cap: int = None) -> ObsGP2DState:
    """Train the partitioned 2D observation GP (ObsGP.cpp:280-342).

    v_coords: [NI] row ray coordinates (v = (row - cy)/fy, ascending);
    u_coords: [NJ] column ray coordinates (u = (col - cx)/fx, ascending);
    f: [NI, NJ] regression target (inverse depth 1/z; <= 0 marks invalid
    pixels, ObsGP.cpp:304).

    c_cap: fit only the nonempty cells, at most c_cap of them, nonempty
    first by a stable sort, and scatter alpha and L^-1 back into the full
    cell layout (untrained cells keep zeros, which no query reads: the
    posterior of an untrained cell is the sentinel). Each cell's system is
    independent, so a trained cell's alpha and L^-1 are its full fit's.
    Callers pass the pow2 bucket of the host-known nonempty-cell count
    (api3d._obs_cell_cap); None, or c_cap >= the cell count, fits every
    cell.
    """
    dev = f.device
    ni, nj = int(v_coords.shape[0]), int(u_coords.shape[0])
    gs, ov = param.group_size, param.overlap
    ng0, i0s, i1s, bnd_i = partition_1axis(ni, gs, ov)
    ng1, j0s, j1s, bnd_j = partition_1axis(nj, gs, ov)
    win = gs + ov  # max window extent per axis (i1 - i0 + 1 <= gs + ov)

    def window(starts, ends, n):
        w = (torch.tensor(starts, device=dev)[:, None]
             + torch.arange(win, device=dev)[None, :])          # [nG, W]
        inr = w <= torch.tensor(ends, device=dev)[:, None]
        return torch.clamp(w, 0, n - 1), inr

    i0c, irange = window(i0s, i1s, ni)
    j0c, jrange = window(j0s, j1s, nj)
    # cell (a, b) window pixels ordered column-outer/row-inner, the
    # reference's gather order (ObsGP.cpp:301-309)
    rows = i0c[:, None, None, :]            # [nG0, 1, 1, W] (inner)
    cols = j0c[None, :, :, None]            # [1, nG1, W, 1] (outer)
    fv = f[rows, cols]                      # [nG0, nG1, Wj, Wi]
    inwin = irange[:, None, None, :] & jrange[None, :, :, None]
    pix_ok = inwin & (fv > 0)

    vs = v_coords[rows] + torch.zeros_like(fv)
    us = u_coords[cols] + torch.zeros_like(fv)
    m = win * win
    c = ng0 * ng1
    # cell-major flatten: cell index (a, b) -> a * nG1 + b
    x = torch.stack([vs, us], dim=-1).reshape(c, m, 2)
    fcell = fv.reshape(c, m)
    vmask = pix_ok.reshape(c, m)
    trained = torch.any(vmask, dim=-1)

    if c_cap is not None and c_cap < c:
        sel = torch.argsort((~trained).to(torch.int8), stable=True)[:c_cap]
        st = gp.fit_gpou(x[sel], fcell[sel], vmask[sel], param.scale,
                         param.noise)
        # the selected empty cells drop onto a dummy trailing row
        tgt = torch.where(trained[sel], sel, c)
        alpha = x.new_zeros((c + 1, m))
        alpha[tgt] = st.alpha
        linv = x.new_zeros((c + 1, m, m))
        linv[tgt] = gp.gpou_linv(st.l)
        alpha, linv = alpha[:-1], linv[:-1]
    else:
        st = gp.fit_gpou(x, fcell, vmask, param.scale, param.noise)
        alpha, linv = st.alpha, gp.gpou_linv(st.l)
    val_i = torch.cat([v_coords[:1], v_coords[torch.tensor(bnd_i,
                                                           device=dev)]])
    val_j = torch.cat([u_coords[:1], u_coords[torch.tensor(bnd_j,
                                                           device=dev)]])
    return ObsGP2DState(x=x, valid=vmask, alpha=alpha, linv=linv,
                        trained=trained, val_i=val_i, val_j=val_j)


def ownership_1axis(coords_np: np.ndarray, bnd_np: np.ndarray) -> np.ndarray:
    """Static per-cell ownership along one partition axis: the
    obsgp2d_test cell lookup (the count of interior boundaries <= x,
    ObsGP.cpp:381-391) on the static coordinate grid. Returns idx [nG, W],
    the coordinate indices each cell owns (-1 padded); ownership regions
    are contiguous and W is the largest count."""
    a_of = (bnd_np[None, :] <= coords_np[:, None]).sum(-1)
    a_of = np.clip(a_of, 0, len(bnd_np) - 1)
    ng = len(bnd_np)
    w = int(np.bincount(a_of, minlength=ng).max())
    idx = np.full((ng, w), -1, np.int32)
    for a in range(ng):
        rows = np.nonzero(a_of == a)[0]
        idx[a, :len(rows)] = rows
    return idx


def obsgp2d_test_blocked(state: ObsGP2DState, q: torch.Tensor,
                         param: ObsGPParam, roff: int = 1):
    """obsgp2d_test for queries grouped by a static base cell.

    q: [nG0, nG1, T, 2]; block (i, j) holds queries whose owning cell is
    within `roff` cells of (i, j) (the caller guarantees it from the
    camera geometry). Instead of gathering each query's [M, M] factor,
    every offset of the (2 roff + 1)^2 ring evaluates all blocks against
    the shifted cell grid with dense batched products, and the owning
    cell's match selects the result. The offsets run one after another,
    so the peak memory is one offset's [nG0, nG1, T, M] products. Same
    cell lookup, margins and sentinels as obsgp2d_test.

    Returns (mean, var) [nG0, nG1, T].
    """
    ng0 = state.val_i.shape[0] - 1
    ng1 = state.val_j.shape[0] - 1
    mres = state.x.shape[1]
    v, u = q[..., 0], q[..., 1]
    m_ok = ((v >= state.val_i[0] + param.margin)
            & (v <= state.val_i[-1] - param.margin)
            & (u >= state.val_j[0] + param.margin)
            & (u <= state.val_j[-1] - param.margin))
    # owning cell, by obsgp2d_test's comparisons
    a = torch.searchsorted(state.val_i[1:].contiguous(),
                           v.reshape(-1).contiguous(),
                           right=True).reshape(v.shape)
    b = torch.searchsorted(state.val_j[1:].contiguous(),
                           u.reshape(-1).contiguous(),
                           right=True).reshape(u.shape)
    a = torch.clamp(a, 0, ng0 - 1)
    b = torch.clamp(b, 0, ng1 - 1)

    x4 = state.x.reshape(ng0, ng1, mres, 2)
    al4 = state.alpha.reshape(ng0, ng1, mres)
    li4 = state.linv.reshape(ng0, ng1, mres, mres)
    vl4 = state.valid.reshape(ng0, ng1, mres)
    tr4 = state.trained.reshape(ng0, ng1)

    def shift(arr, da, db):
        """entry (i, j) -> arr[i + da, j + db], zero outside the grid."""
        out = torch.zeros_like(arr)
        i0, i1 = max(-da, 0), ng0 - max(da, 0)
        j0, j1 = max(-db, 0), ng1 - max(db, 0)
        out[i0:i1, j0:j1] = arr[i0 + da:i1 + da, j0 + db:j1 + db]
        return out

    ii = torch.arange(ng0, device=q.device)[:, None, None]
    jj = torch.arange(ng1, device=q.device)[None, :, None]
    mean = torch.zeros_like(v)
    var = torch.full_like(v, _PAD_INVALID)
    for da in range(-roff, roff + 1):
        for db in range(-roff, roff + 1):
            ok = ((a == ii + da) & (b == jj + db)
                  & shift(tr4, da, db)[:, :, None])
            diff = shift(x4, da, db)[:, :, None, :, :] - q[:, :, :, None, :]
            r = torch.sqrt(torch.sum(diff * diff, -1))       # [g0,g1,T,M]
            del diff
            ks = torch.where(shift(vl4, da, db)[:, :, None, :],
                             torch.exp(-r / param.scale), 0.0)
            del r
            mn = torch.einsum('ghtm,ghm->ght', ks, shift(al4, da, db))
            vv = torch.einsum('ghmn,ghtn->ghtm', shift(li4, da, db), ks)
            del ks
            vr = 1.0 + param.noise - torch.sum(vv * vv, -1)
            del vv
            # an untrained owning cell keeps the sentinel
            mean = torch.where(ok, mn, mean)
            var = torch.where(ok, vr, var)
    return (torch.where(m_ok, mean, 0.0),
            torch.where(m_ok, var, _PAD_INVALID))


def obsgp2d_test(state: ObsGP2DState, vu: torch.Tensor, param: ObsGPParam,
                 chunk: int = 4096):
    """Posterior at vu [Q, 2] = (v, u) pairs (ObsGP.cpp:352-408), each
    query gathering its owning cell's factor. Returns (mean [Q], var [Q])
    with the 1e6 sentinel outside the margins."""
    ng1 = state.val_j.shape[0] - 1
    v, u = vu[:, 0], vu[:, 1]
    m_ok = ((v >= state.val_i[0] + param.margin)
            & (v <= state.val_i[-1] - param.margin)
            & (u >= state.val_j[0] + param.margin)
            & (u <= state.val_j[-1] - param.margin))
    # first boundary strictly greater (reference `if (x < *it) break`,
    # ObsGP.cpp:381-391): the count of interior boundaries <= x, which
    # searchsorted(right=True) gives on the ascending boundaries
    a = torch.searchsorted(state.val_i[1:].contiguous(), v.contiguous(),
                           right=True)
    b = torch.searchsorted(state.val_j[1:].contiguous(), u.contiguous(),
                           right=True)
    a = torch.clamp(a, 0, state.val_i.shape[0] - 2)
    b = torch.clamp(b, 0, ng1 - 1)
    mean, var = gp.gpou_posterior_gather(
        state.x, state.alpha, state.linv, state.valid, state.trained,
        a * ng1 + b, vu, param.scale, param.noise, chunk)
    return (torch.where(m_ok, mean, 0.0),
            torch.where(m_ok, var, _PAD_INVALID))
