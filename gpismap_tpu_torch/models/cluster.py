"""Cluster-GP store + batched map query.

Port of gpismap_tpu/models/cluster.py (the default 2D path): per-cluster
GP state in flat slot-indexed tensors (the replacement of the
reference's per-QuadTree OnGPIS registry, quadtree.h:124), and the
batched SDF query with 3-nearest-cell variance blending
(GPisMap.cpp:665-763).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CapacityParam
from ..ops import gp, kernels, segmented
from ..ops import tile_eval as tile_ops

_INT32_MAX = 2 ** 31 - 1


class ClusterStore(NamedTuple):
    """Per-slot trained cluster GPs, slot-indexed [C, ...]. Stores no
    Cholesky factors: the support data and alpha persist, and the query
    factorizes the cells it touches."""

    x: torch.Tensor         # [C, M, D] support positions
    grad: torch.Tensor      # [C, M, D] support normals
    val: torch.Tensor       # [C, M] SDF targets
    sigx: torch.Tensor      # [C, M] position noise (pre-adjustment)
    siggrad: torch.Tensor   # [C, M] gradient noise
    valid: torch.Tensor     # [C, M] bool
    alpha: torch.Tensor     # [C, M(1+D)]
    trained: torch.Tensor   # [C] bool


def make_store(cap: CapacityParam, dim: int,
               device: torch.device) -> ClusterStore:
    c, m = cap.max_cells, cap.gp_support

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ClusterStore(x=z(c, m, dim), grad=z(c, m, dim), val=z(c, m),
                        sigx=z(c, m), siggrad=z(c, m),
                        valid=z(c, m, dtype=torch.bool),
                        alpha=z(c, m * (1 + dim)),
                        trained=z(c, dtype=torch.bool))


def _scatter_rows(old: torch.Tensor, tgt: torch.Tensor,
                  new: torch.Tensor) -> torch.Tensor:
    """old with rows tgt set to new; tgt == len(old) drops onto a dummy
    trailing row (the JAX package's `.at[].set(mode='drop')`)."""
    ext = torch.cat([old, old.new_zeros((1,) + old.shape[1:])])
    return ext.index_put_((tgt,), new)[:-1]


def _retrain_impl(store: ClusterStore, slots: torch.Tensor,
                  slot_ok: torch.Tensor, x: torch.Tensor, grad: torch.Tensor,
                  val: torch.Tensor, sigx: torch.Tensor,
                  siggrad: torch.Tensor, valid: torch.Tensor, scale):
    """Fit a batch of cluster GPs and scatter them into their slots
    (the batched form of updateGPs, GPisMap.cpp:596-663).

    slots: [B] destination slot per cell (rows with slot_ok False are
    dropped). The batch may carry fewer support rows than the store
    (x: [B, mb, D], mb <= M): the fit then runs at the small size and is
    zero-padded into the store layout, which identity-row masking makes
    exact. Returns (new store, Cholesky factor l [B, mb(1+D), mb(1+D)]).
    """
    st = gp.fit_ongpis(x, grad, val, sigx, siggrad, valid, scale)
    m = store.x.shape[1]
    mb = x.shape[1]
    d = x.shape[-1]
    alpha = st.alpha
    if mb < m:
        def padm(a):
            out = a.new_zeros((a.shape[0], m) + a.shape[2:])
            out[:, :mb] = a
            return out

        x, grad = padm(x), padm(grad)
        val, sigx, siggrad = padm(val), padm(sigx), padm(siggrad)
        valid = padm(valid)
        # alpha is per block [f(M), gx(M), gy(M)]: pad each block from mb
        # to M (padded rows have alpha == 0 by masking)
        alpha = padm(alpha.reshape(-1, 1 + d, mb).transpose(1, 2))
        alpha = alpha.transpose(1, 2).reshape(-1, (1 + d) * m)
    tgt = torch.where(slot_ok, slots.long(), store.x.shape[0])
    new_store = ClusterStore(
        x=_scatter_rows(store.x, tgt, x),
        grad=_scatter_rows(store.grad, tgt, grad),
        val=_scatter_rows(store.val, tgt, val),
        sigx=_scatter_rows(store.sigx, tgt, sigx),
        siggrad=_scatter_rows(store.siggrad, tgt, siggrad),
        valid=_scatter_rows(store.valid, tgt, valid),
        alpha=_scatter_rows(store.alpha, tgt, alpha),
        trained=_scatter_rows(store.trained, tgt, torch.any(valid, -1)))
    return new_store, st.l


def retrain_cells(store: ClusterStore, slots: torch.Tensor,
                  slot_ok: torch.Tensor, x: torch.Tensor, grad: torch.Tensor,
                  val: torch.Tensor, sigx: torch.Tensor,
                  siggrad: torch.Tensor, valid: torch.Tensor,
                  scale) -> ClusterStore:
    """_retrain_impl without the Cholesky factor."""
    return _retrain_impl(store, slots, slot_ok, x, grad, val, sigx,
                         siggrad, valid, scale)[0]


class NodeMirror(NamedTuple):
    """Device copy of the host node table, indexed by node id. Kept in
    sync by scattering only the nodes each frame mutates
    (api.GPisMap2D._sync_mirror), so the retrain gathers its support on
    the device from the support ids alone."""

    pos: torch.Tensor       # [N, D]
    grad: torch.Tensor      # [N, D]
    val: torch.Tensor       # [N]
    pos_sig: torch.Tensor   # [N]
    grad_sig: torch.Tensor  # [N]


def make_mirror(cap: CapacityParam, dim: int,
                device: torch.device) -> NodeMirror:
    n = cap.max_nodes

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return NodeMirror(pos=z(n, dim), grad=z(n, dim), val=z(n),
                      pos_sig=z(n), grad_sig=z(n))


def scatter_mirror(mirror: NodeMirror, ids: torch.Tensor, pos, grad, val,
                   pos_sig, grad_sig) -> NodeMirror:
    """Write the given nodes' current host values into the mirror, in
    place (the JAX package returns a new mirror); ids of -1 are dropped.
    Returns the mirror.

    Raises ValueError for an id at or above the mirror's length
    (cap.max_nodes): the JAX mirror drops such a row silently, and its
    retrain then gathers a clipped, wrong row."""
    n = mirror.val.shape[0]
    keep = torch.nonzero(ids >= 0).reshape(-1)
    tgt = ids[keep].long()
    if len(tgt) and int(tgt.max()) >= n:
        raise ValueError(f"node id {int(tgt.max())} does not fit the node "
                         f"mirror of {n} rows (cap.max_nodes)")
    for old, new in zip(mirror, (pos, grad, val, pos_sig, grad_sig)):
        old.index_copy_(0, tgt, new[keep])
    return mirror


def retrain_cells_from_mirror_with_l(store: ClusterStore,
                                     mirror: NodeMirror,
                                     slots: torch.Tensor,
                                     slot_ok: torch.Tensor,
                                     sup: torch.Tensor, scale):
    """retrain_cells with the support gathered on the device from the node
    mirror by the support ids sup [B, mb] (-1 = padding), returning also
    the fit's Cholesky factor l [B, (1+D)mb, (1+D)mb], which the factor
    cache refresh inverts (update_factors_from_l). Returns (store, l)."""
    c = torch.clamp(sup, 0, mirror.val.shape[0] - 1).long()
    return _retrain_impl(store, slots, slot_ok, mirror.pos[c],
                         mirror.grad[c], mirror.val[c], mirror.pos_sig[c],
                         mirror.grad_sig[c], sup >= 0, scale)


def retrain_cells_from_mirror(store: ClusterStore, mirror: NodeMirror,
                              slots: torch.Tensor, slot_ok: torch.Tensor,
                              sup: torch.Tensor, scale) -> ClusterStore:
    """retrain_cells_from_mirror_with_l without the Cholesky factor."""
    return retrain_cells_from_mirror_with_l(store, mirror, slots, slot_ok,
                                            sup, scale)[0]


def _factorize_cells(store: ClusterStore, slots: torch.Tensor,
                     scale) -> torch.Tensor:
    """L^-1 for the given slots: [S, M', M']. Entries with slot < 0 get
    identity factors (what the masked fit of an empty cell gives)."""
    mp = store.alpha.shape[-1]
    out = torch.eye(mp, dtype=store.x.dtype,
                    device=store.x.device).repeat(slots.shape[0], 1, 1)
    live = torch.nonzero(slots >= 0).reshape(-1)
    if len(live):
        sc = slots[live].long()
        vl = store.valid[sc]
        gradflag, sigx = gp.ongpis_prepare(store.grad[sc], store.sigx[sc],
                                           store.siggrad[sc], vl)
        k = kernels.matern32_deriv_train_cov(store.x[sc], sigx,
                                             store.siggrad[sc], gradflag,
                                             vl, scale)
        out[live] = gp.linv_from_chol(gp._chol(k))
    return out


def factorize_slots(store: ClusterStore, slots: torch.Tensor, scale,
                    max_active: int):
    """Factor cache fill for a slot set (padded with -1): the reference
    keeps each cell's Cholesky factor between updates (OnGPIS.h `L`).
    Returns (linv_buf [S, M', M'], uniq [S] sorted ascending with
    int32-max sentinels for padding)."""
    sl = torch.where(slots >= 0, slots, _INT32_MAX).to(torch.int32)
    sl = torch.sort(sl).values[:max_active]
    slot_of = torch.where(sl < _INT32_MAX, sl, -1)
    return _factorize_cells(store, slot_of, scale), torch.where(
        slot_of >= 0, slot_of, _INT32_MAX)


def _embed_linv(linv_s: torch.Tensor, mp: int, d: int) -> torch.Tensor:
    """Scatter a small-system L^-1 [B, (1+d)mb, (1+d)mb] into the
    identity-padded full layout [B, mp, mp]. Exact: the masked identity
    rows of the padding leave the Cholesky recursion's real rows as they
    are, so the full L^-1 is the small one at the real rows' positions."""
    mp_s = linv_s.shape[-1]
    if mp_s == mp:
        return linv_s
    m = mp // (1 + d)
    mb = mp_s // (1 + d)
    idx = torch.cat([b * m + torch.arange(mb, device=linv_s.device)
                     for b in range(1 + d)])
    full = torch.eye(mp, dtype=linv_s.dtype,
                     device=linv_s.device).repeat(linv_s.shape[0], 1, 1)
    full[:, idx[:, None], idx[None, :]] = linv_s
    return full


def _update_factors_from_l_impl(linv_buf: torch.Tensor, uniq: torch.Tensor,
                                slots: torch.Tensor, l: torch.Tensor,
                                d: int) -> torch.Tensor:
    """Body of update_factors_from_l: L^-1 of every row of l, embedded
    into the cache layout and copied in place into the rows of linv_buf
    whose slot is in uniq; rows whose slot misses uniq are dropped."""
    max_active = linv_buf.shape[0]
    sl = torch.where(slots >= 0, slots, _INT32_MAX).to(torch.int32)
    pos = torch.clamp(torch.searchsorted(uniq, sl), 0, max_active - 1)
    hit = torch.nonzero((sl < _INT32_MAX) & (uniq[pos] == sl)).reshape(-1)
    linv_full = _embed_linv(gp.linv_from_chol(l), linv_buf.shape[-1], d)
    linv_buf.index_copy_(0, pos[hit], linv_full[hit])
    return linv_buf


def update_factors_from_l(linv_buf: torch.Tensor, uniq: torch.Tensor,
                          slots: torch.Tensor, l: torch.Tensor,
                          d: int) -> torch.Tensor:
    """Factor-cache refresh from the retrain fit's own Cholesky factor
    (the reference keeps each fit's L, OnGPIS.h): only the triangular
    inverse is left to compute.

    linv_buf [S, M', M'] and uniq [S] are a factorize_slots cache; slots
    [B] are aligned row for row with l [B, (1+d)mb, (1+d)mb] (mb <= M, a
    support bucket). linv_buf is written in place (the JAX package
    donates it) and returned."""
    if l.shape[0] != slots.shape[0] or l.shape[-1] > linv_buf.shape[-1]:
        raise ValueError(f"update_factors_from_l: l {tuple(l.shape)} does "
                         f"not fit slots {tuple(slots.shape)} and the cache "
                         f"{tuple(linv_buf.shape)}")
    return _update_factors_from_l_impl(linv_buf, uniq, slots, l, d)


def _ongpis_eval_tile(store: ClusterStore, linv_buf: torch.Tensor,
                      slot_of: torch.Tensor, segs: torch.Tensor,
                      q: torch.Tensor, scale, val_const, grad_const):
    """Plain twin of the tile evaluation in the store's layout
    (gpismap_tpu/models/cluster.py:_ongpis_eval_tile): segs [G] compact
    cell ids (clipped into range), q [G, T, D]. Returns (f [G, T],
    grad [G, T, D], varf [G, T], vargrad [G, T, D])."""
    d = q.shape[-1]
    segc = torch.clamp(segs, 0, linv_buf.shape[0] - 1).to(torch.int32)
    xt, alpha, gf, vl = _cell_args(store, slot_of)
    f, g, vf, vg = tile_ops.tile_eval_reference(
        segc, linv_buf, xt, alpha, gf, vl, q.transpose(-1, -2), d, scale,
        val_const, grad_const)
    return f, g.transpose(-1, -2), vf, vg.transpose(-1, -2)


def _cell_args(store: ClusterStore, slot_of: torch.Tensor):
    """Per compact cell, the tile kernel's cell inputs: (xt [S, D, M],
    alpha [S, M'], gradflag [S, M] and valid [S, M] as float 0/1)."""
    slc = torch.clamp(slot_of, 0, store.x.shape[0] - 1).long()
    cvalid = store.valid[slc] & (slot_of >= 0)[:, None]
    gf_c, _ = gp.ongpis_prepare(store.grad[slc], store.sigx[slc],
                                store.siggrad[slc], cvalid)
    return (store.x[slc].transpose(-1, -2).contiguous(), store.alpha[slc],
            gf_c.to(torch.float32), cvalid.to(torch.float32))


def _grid_candidates(grid: torch.Tensor, q: torch.Tensor, cell_size: float,
                     grid_half: int, noff: int, search_half: float,
                     trained: torch.Tensor):
    """Per query: cluster-cell candidates within the search box.

    grid: dense [(2*grid_half)^D] slot map (slot or -1), row-major over
    integer cell coords k + grid_half, cell center = (k + 0.5)*cell_size.
    Returns (slots [Q, K], sqd [Q, K], ok [Q, K]), K = (2*noff+1)^D.
    """
    d = q.shape[-1]
    k0 = torch.floor(q / cell_size).to(torch.int64)          # [Q, D]
    r = torch.arange(-noff, noff + 1, device=q.device)
    offs = torch.stack(torch.meshgrid(*([r] * d), indexing='ij'),
                       dim=-1).reshape(-1, d)                # [K, D]
    kc = k0[:, None, :] + offs[None, :, :]                   # [Q, K, D]
    centers = (kc.to(q.dtype) + 0.5) * cell_size
    inb = torch.all((kc >= -grid_half) & (kc < grid_half), dim=-1)
    gidx = kc + grid_half
    side = 2 * grid_half
    flat = gidx[..., 0]
    for a in range(1, d):
        flat = flat * side + gidx[..., a]
    flat = torch.where(inb, flat, 0)
    slots = torch.where(inb, grid.reshape(-1)[flat], -1)      # [Q, K]
    diff = centers - q[:, None, :]
    sqd = torch.sum(diff * diff, dim=-1)
    # AABB intersect (non-strict, quadtree.h:100-105): box half =
    # search_half, cell half = cell_size/2
    reach = search_half + cell_size * 0.5
    inter = torch.all(torch.abs(diff) <= reach, dim=-1)
    ok = (slots >= 0) & inter & trained[torch.clamp(slots, min=0)] & inb
    return slots, sqd, ok


class TestInfo(NamedTuple):
    """Per-call counters returned by map_test.

    n_dropped: (query, rank) evaluations whose cell fell outside the
        factor buffer (max_active overflow / factor-cache miss).
    n_pairs: (query, rank) pairs evaluated through the tile plan.
    n_phase2: queries sent through a second phase (0: single phase).
    """

    n_dropped: torch.Tensor
    n_pairs: torch.Tensor
    n_phase2: torch.Tensor


def _eval_pairs(store: ClusterStore, linv_buf: torch.Tensor,
                slot_of: torch.Tensor, plan: segmented.TilePlan, npair: int,
                q: torch.Tensor, div: int, scale, val_const, grad_const):
    """Evaluate one planned pair set through the tile op, then ONE packed
    scatter back to pair order (pair p belongs to query p // div).
    Returns (f [P], g [P, D], vf [P] (inf where not evaluated),
    vg [P, D])."""
    d = q.shape[-1]
    xt, alpha, gf, vl = _cell_args(store, slot_of)
    qt = q[torch.clamp(plan.pair_ids, min=0).long() // div]   # [NT, T, D]
    f_t, g_t, vf_t, vg_t = tile_ops.tile_eval(
        plan.tile_seg, linv_buf, xt, alpha, gf, vl,
        qt.transpose(-1, -2).contiguous(), d=d, scale=scale,
        val_const=val_const, grad_const=grad_const)
    # inactive tiles and padding slots drop onto a dummy trailing row
    mask = (plan.pair_ids >= 0) & (plan.tile_seg[:, None] >= 0)
    tgt = torch.where(mask, plan.pair_ids, npair).reshape(-1).long()
    packed_t = torch.cat([f_t[:, None, :], vf_t[:, None, :], g_t, vg_t],
                         dim=1).transpose(-1, -2)            # [NT, T, 2+2D]
    init = q.new_zeros((npair + 1, 2 + 2 * d))
    init[:, 1] = torch.inf                                   # vf default
    packed = init.index_put_((tgt,), packed_t.reshape(-1, 2 + 2 * d))[:-1]
    return packed[:, 0], packed[:, 2:2 + d], packed[:, 1], packed[:, 2 + d:]


def map_test(store: ClusterStore, grid: torch.Tensor, q: torch.Tensor,
             cell_size, grid_half: int, noff: int, search_half, scale,
             val_const, grad_const, var_thre, default_var, tile: int,
             max_cells: int, max_active: int = 512, factors=None):
    """Batched SDF+gradient+variance query (GPisMap.cpp:665-763).

    Per query: collect the trained cluster cells intersecting the search
    box, evaluate the nearest cell's GP, and fall back to the up-to-3
    nearest with variance-weighted blending of the best two when the
    nearest is uncertain. Single phase: all 3Q (query, rank) pairs go
    through one tile plan.

    factors: optional (linv_buf, uniq) cache from factorize_slots;
    without it, each distinct touched cell (at most max_active; overflow
    pairs are dropped and counted) is factorized once for this call.
    Returns (f [Q], grad [Q, D], varf [Q], vargrad [Q, D], TestInfo).
    """
    nq, d = q.shape
    slots, sqd, ok = _grid_candidates(grid, q, cell_size, grid_half, noff,
                                      search_half, store.trained)
    n_cand = torch.sum(ok, dim=-1)
    # 3 nearest candidates by center distance (GPisMap.cpp:695-698): three
    # masked argmin passes (first lowest index on ties)
    cur = torch.where(ok, sqd, torch.inf)
    cols = torch.arange(cur.shape[-1], device=q.device)
    tops = []
    for _ in range(3):
        i = torch.argmin(cur, dim=-1)
        tops.append(i)
        cur = torch.where(cols[None, :] == i[:, None], torch.inf, cur)
    top_idx = torch.stack(tops, dim=-1)                       # [Q, 3]
    top_slot = torch.gather(slots, 1, top_idx)
    top_ok = (torch.gather(ok, 1, top_idx)
              & (torch.arange(3, device=q.device)[None, :]
                 < n_cand[:, None]))
    seg3 = torch.where(top_ok, top_slot, -1).to(torch.int32)  # [Q, 3]

    if factors is None:
        u = torch.unique(torch.where(seg3 >= 0, seg3, _INT32_MAX))
        uniq = u.new_full((max_active,), _INT32_MAX)
        uniq[:min(len(u), max_active)] = u[:max_active]
        slot_of = torch.where(uniq < _INT32_MAX, uniq, -1)
        linv_buf = _factorize_cells(store, slot_of, scale)
    else:
        linv_buf, uniq = factors
        slot_of = torch.where(uniq < _INT32_MAX, uniq, -1)

    plan, n_pairs = segmented.plan_tiles_for_slots(
        seg3.reshape(-1), uniq, max_cells, max_active, tile)
    n_dropped = (torch.sum(seg3 >= 0) - n_pairs).to(torch.int32)
    f_p, g_p, vf_p, vg_p = _eval_pairs(store, linv_buf, slot_of, plan,
                                       3 * nq, q, 3, scale, val_const,
                                       grad_const)
    f3 = f_p.reshape(nq, 3)
    g3 = g_p.reshape(nq, 3, d)
    vf3 = torch.where(top_ok, vf_p.reshape(nq, 3), torch.inf)
    vg3 = vg_p.reshape(nq, 3, d)

    # --- selection / blending (GPisMap.cpp:685-758) ---
    # The two smallest variances of the up-to-3 results by stable
    # compare-selects (strict < keeps argsort's tie order).
    def pick(c, a, b):
        return torch.where(c[:, None] if a.ndim == 2 else c, a, b)

    v0, v1, v2 = vf3[:, 0], vf3[:, 1], vf3[:, 2]
    b01 = v1 < v0
    lo_v, hi_v = pick(b01, v1, v0), pick(b01, v0, v1)
    c_best = v2 < lo_v            # rank-2 wins outright
    c_sec = v2 < hi_v             # rank-2 is (at least) second
    vb0 = pick(c_best, v2, lo_v)
    vb1 = pick(c_best, lo_v, pick(c_sec, v2, hi_v))

    def best2(x3):
        x0, x1, x2 = x3[:, 0], x3[:, 1], x3[:, 2]
        lo, hi = pick(b01, x1, x0), pick(b01, x0, x1)
        return (pick(c_best, x2, lo),
                pick(c_best, lo, pick(c_sec, x2, hi)))

    fb0, fb1 = best2(f3)
    gb0, gb1 = best2(g3)
    vgb0, vgb1 = best2(vg3)

    # best < thr -> best; else variance-weighted blend of the two best with
    # w1 = var_best - thr, w2 = var_second - thr (GPisMap.cpp:735-756)
    best_lt = vb0 < var_thre
    fin1 = torch.isfinite(vb1)
    w1 = vb0 - var_thre
    w2 = torch.where(fin1, vb1, vb0) - var_thre
    w12 = torch.where(torch.abs(w1 + w2) > 0, w1 + w2, 1.0)

    def mix(a_best, a_second):
        sh = (-1,) + (1,) * (a_best.ndim - 1)
        return ((w2.reshape(sh) * a_best + w1.reshape(sh) * a_second)
                / w12.reshape(sh))

    f2nd = torch.where(fin1, fb1, fb0)
    v2nd = torch.where(fin1, vb1, vb0)
    g2nd = torch.where(fin1[:, None], gb1, gb0)
    vg2nd = torch.where(fin1[:, None], vgb1, vgb0)

    f_mix = torch.where(best_lt, fb0, mix(fb0, f2nd))
    vf_mix = torch.where(best_lt, vb0, mix(vb0, v2nd))
    g_mix = torch.where(best_lt[:, None], gb0, mix(gb0, g2nd))
    vg_mix = torch.where(best_lt[:, None], vgb0, mix(vgb0, vg2nd))

    # single candidate -> nearest result regardless of variance
    # (GPisMap.cpp:686-692); >= 2 -> nearest if confident, else blend
    use_near = (n_cand == 1) | (vf3[:, 0] <= var_thre)
    none = n_cand == 0

    def sel(near, mixv, defv):
        sh = (-1,) + (1,) * (near.ndim - 1)
        return torch.where(none.reshape(sh), defv,
                           torch.where(use_near.reshape(sh), near, mixv))

    f_out = sel(f3[:, 0], f_mix, 0.0)
    g_out = sel(g3[:, 0], g_mix, 0.0)
    vf_out = sel(vf3[:, 0], vf_mix, default_var)
    vg_out = sel(vg3[:, 0], vg_mix, 0.0)
    # guard: queries whose results never materialised (inf var)
    bad = ~torch.isfinite(vf_out)
    vf_out = torch.where(bad, default_var, vf_out)
    f_out = torch.where(bad, 0.0, f_out)
    g_out = torch.where(bad[:, None], 0.0, g_out)
    vg_out = torch.where(bad[:, None], 0.0, vg_out)
    return f_out, g_out, vf_out, vg_out, TestInfo(
        n_dropped=n_dropped, n_pairs=n_pairs,
        n_phase2=torch.zeros((), dtype=torch.int32, device=q.device))


def build_grid_device(coords: torch.Tensor, slots: torch.Tensor, dim: int,
                      grid_half: int) -> torch.Tensor:
    """Dense cluster grid built on the device from the (padded) live-cell
    list: coords [C, D] integer cell coords, slots [C] (-1 rows dropped).
    Cells have unique coords, so the scatter order does not matter."""
    side = 2 * grid_half
    k = coords.to(torch.int64) + grid_half
    inb = torch.all((k >= 0) & (k < side), dim=-1)
    flat = k[..., 0]
    for a in range(1, dim):
        flat = flat * side + k[..., a]
    flat = torch.where(inb & (slots >= 0), flat, side ** dim)
    g = torch.full((side ** dim + 1,), -1, dtype=torch.int32,
                   device=coords.device)
    g[flat] = slots.to(torch.int32)
    return g[:-1].reshape((side,) * dim)


def build_grid(cell_coords: np.ndarray, slots: np.ndarray, dim: int,
               grid_half: int, device: torch.device) -> torch.Tensor:
    """Dense cluster grid from host cell tables (cells outside the grid
    are dropped)."""
    side = 2 * grid_half
    grid = np.full((side,) * dim, -1, np.int32)
    if len(cell_coords):
        k = np.asarray(cell_coords) + grid_half
        inb = np.all((k >= 0) & (k < side), axis=-1)
        grid[tuple(k[inb].T)] = np.asarray(slots)[inb]
    return torch.as_tensor(grid, device=device)
