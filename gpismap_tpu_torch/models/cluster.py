"""Cluster-GP store + batched map query.

Port of gpismap_tpu/models/cluster.py (the default 2D path): per-cluster
GP state in flat slot-indexed tensors (the replacement of the
reference's per-QuadTree OnGPIS registry, quadtree.h:124), and the
batched SDF query with 3-nearest-cell variance blending
(GPisMap.cpp:665-763). The query finds its candidate cells through the
dense grid's window or a precomputed candidate table (NeighborTable),
and evaluates them in one phase or in two (two_phase); the four
combinations give the same results.

The fit (retrain_cells), the factorization (factorize_slots and the
query's own) and map_test are differentiable in the store fields, the
queries, scale, val_const and grad_const (tensors), on the CPU through
the plain versions and on the card through the kernels' autograd
Functions (ops/chol.py, ops/tile_eval.py); render.implicit_correct
relies on it. They keep no host copy of a differentiated value, and
write in place only into tensors they have just made. The factor-cache
upkeep (update_factors_from_l) writes into the cache in place and is
not differentiable; it runs in the update, never under a gradient.

The cache upkeep has two forms: update_factors_from_l inverts the
retrain fit's own Cholesky factor (the default), update_factors
re-factorizes the retrained cells, at a refresh_bucket's size where
their support allows (with a mesh, or with GPISMAP_NODE_MIRROR=0, whose
retrains keep no factor). map_test_sharded splits the queries over the
ranks of a parallel.mesh.Mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import CapacityParam
from ..ops import gp, kernels, segmented
from ..ops import tile_eval as tile_ops
from ..runtime import spans

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


def fit_cells(x: torch.Tensor, grad: torch.Tensor, val: torch.Tensor,
              sigx: torch.Tensor, siggrad: torch.Tensor, valid: torch.Tensor,
              scale, m: int):
    """Fit a batch of cluster GPs (the batched form of updateGPs,
    GPisMap.cpp:596-663) and lay each out as a store row of M support
    rows.

    The batch may carry fewer support rows than the store (x: [B, mb, D],
    mb <= m): the fit then runs at the small size and is zero-padded into
    the store layout, which identity-row masking makes exact. Returns
    (rows, l): rows a ClusterStore of B rows (scatter_cells writes them
    into their slots), l the Cholesky factor [B, mb(1+D), mb(1+D)]."""
    st = gp.fit_ongpis(x, grad, val, sigx, siggrad, valid, scale)
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
    return ClusterStore(x=x, grad=grad, val=val, sigx=sigx, siggrad=siggrad,
                        valid=valid, alpha=alpha,
                        trained=torch.any(valid, -1)), st.l


def scatter_cells(store: ClusterStore, slots: torch.Tensor,
                  slot_ok: torch.Tensor, rows: ClusterStore) -> ClusterStore:
    """The store with fit_cells rows written into their slots [B] (rows
    with slot_ok False are dropped)."""
    tgt = torch.where(slot_ok, slots.long(), store.x.shape[0])
    return ClusterStore(*(_scatter_rows(old, tgt, new)
                          for old, new in zip(store, rows)))


def _retrain_impl(store: ClusterStore, slots: torch.Tensor,
                  slot_ok: torch.Tensor, x: torch.Tensor, grad: torch.Tensor,
                  val: torch.Tensor, sigx: torch.Tensor,
                  siggrad: torch.Tensor, valid: torch.Tensor, scale):
    """fit_cells, then scatter_cells into the slots [B]. Returns (new
    store, Cholesky factor l [B, mb(1+D), mb(1+D)])."""
    rows, l = fit_cells(x, grad, val, sigx, siggrad, valid, scale,
                        store.x.shape[1])
    return scatter_cells(store, slots, slot_ok, rows), l


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
    return _retrain_impl(store, slots, slot_ok,
                         *mirror_support(mirror, sup), scale)


def mirror_support(mirror: NodeMirror, sup: torch.Tensor):
    """The support of the ids sup [B, mb] (-1 = padding) gathered from the
    node mirror: (x, grad, val, sigx, siggrad, valid), fit_cells' first
    six arguments."""
    c = torch.clamp(sup, 0, mirror.val.shape[0] - 1).long()
    return (mirror.pos[c], mirror.grad[c], mirror.val[c], mirror.pos_sig[c],
            mirror.grad_sig[c], sup >= 0)


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
    identity-padded full layout [B, mp, mp]. The masked identity rows of
    the padding leave the Cholesky recursion's real rows as they are, so
    the full L^-1 is the small one at the real rows' positions, up to f32
    rounding: the padded rows sit inside each of the 1+d blocks, so the
    CUDA kernels' 64-wide blocks group the sums differently at the two
    sizes (about 1e-6 relative on the card; a test bounds it,
    tests/test_torch_chol.py::test_cuda_bucketed_fit_matches_full_padding).
    """
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


def refresh_bucket(mb, m: int, d: int):
    """The smallest support-row count >= mb whose system size (1+d)*mb is
    a multiple of 128 (the JAX package's blocked-factorization
    granularity); None when only the full capacity m qualifies, where the
    bucketed refresh has nothing to save."""
    if mb is None:
        return None
    step = 128 // math.gcd(1 + d, 128)      # d=3 -> 32; d=2 -> 128
    mb2 = ((int(mb) + step - 1) // step) * step
    return mb2 if 0 < mb2 < m else None


def _factorize_cells_bucketed(store: ClusterStore, slots: torch.Tensor,
                              scale, mb: int) -> torch.Tensor:
    """L^-1 for slots whose valid support lies in rows [:mb], computed at
    the small size (1+D)*mb and embedded into the full layout [S, M', M']
    by _embed_linv: equal to _factorize_cells up to f32 rounding (the two
    sizes group the reductions differently), at (mb/M)^3 of its
    operations. Entries with slot < 0 get identity factors."""
    d = store.x.shape[-1]
    sc = torch.clamp(slots, 0, store.x.shape[0] - 1).long()
    vl = store.valid[sc][:, :mb] & (slots >= 0)[:, None]
    siggrad = store.siggrad[sc][:, :mb]
    gradflag, sigx = gp.ongpis_prepare(store.grad[sc][:, :mb],
                                       store.sigx[sc][:, :mb], siggrad, vl)
    k = kernels.matern32_deriv_train_cov(store.x[sc][:, :mb], sigx, siggrad,
                                         gradflag, vl, scale)
    return _embed_linv(gp.linv_from_chol(gp._chol(k)), store.alpha.shape[-1],
                       d)


def _cache_rows(uniq: torch.Tensor, slots: torch.Tensor):
    """(rows of slots [B] that are in the cache key uniq, their cache
    positions): the searchsorted hit test of the cache upkeep."""
    sl = torch.where(slots >= 0, slots, _INT32_MAX).to(torch.int32)
    pos = torch.clamp(torch.searchsorted(uniq, sl), 0, uniq.shape[0] - 1)
    hit = torch.nonzero((sl < _INT32_MAX) & (uniq[pos] == sl)).reshape(-1)
    return hit, pos[hit]


def update_factors(store: ClusterStore, linv_buf: torch.Tensor,
                   uniq: torch.Tensor, slots: torch.Tensor, scale,
                   mb=None) -> torch.Tensor:
    """Factor-cache refresh by re-factorizing the given (just-retrained)
    slots: the incremental twin of factorize_slots, for retrains that
    keep no Cholesky factor (a mesh, or the node mirror off).

    slots [B] (-1 padded) are looked up in uniq; the rows that hit are
    factorized and written in place into linv_buf, the misses are dropped
    (the JAX package drops them through an out-of-range scatter). mb (a
    refresh_bucket) factorizes at (1+D)*mb rows when every refreshed
    cell's valid support lies in its first mb rows. Returns linv_buf."""
    hit, pos = _cache_rows(uniq, slots)
    if len(hit):
        keep = slots[hit]
        if mb is not None and mb < store.x.shape[1]:
            new = _factorize_cells_bucketed(store, keep, scale, mb)
        else:
            new = _factorize_cells(store, keep, scale)
        linv_buf.index_copy_(0, pos, new)
    return linv_buf


def _update_factors_from_l_impl(linv_buf: torch.Tensor, uniq: torch.Tensor,
                                slots: torch.Tensor, l: torch.Tensor,
                                d: int) -> torch.Tensor:
    """Body of update_factors_from_l: L^-1 of every row of l, embedded
    into the cache layout and copied in place into the rows of linv_buf
    whose slot is in uniq; rows whose slot misses uniq are dropped."""
    hit, pos = _cache_rows(uniq, slots)
    linv_full = _embed_linv(gp.linv_from_chol(l), linv_buf.shape[-1], d)
    linv_buf.index_copy_(0, pos, linv_full[hit])
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


def _window_offsets(noff: int, d: int, device) -> torch.Tensor:
    """[W, D] offsets of the (2 noff + 1)^D window in ij order."""
    r = torch.arange(-noff, noff + 1, device=device)
    return torch.stack(torch.meshgrid(*([r] * d), indexing='ij'),
                       dim=-1).reshape(-1, d)


def _flat_cell(gidx: torch.Tensor, side: int) -> torch.Tensor:
    """Row-major flat id of grid indices gidx [..., D] (0 <= gidx < side)."""
    flat = gidx[..., 0]
    for a in range(1, gidx.shape[-1]):
        flat = flat * side + gidx[..., a]
    return flat


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
    offs = _window_offsets(noff, d, q.device)                # [K, D]
    kc = k0[:, None, :] + offs[None, :, :]                   # [Q, K, D]
    centers = (kc.to(q.dtype) + 0.5) * cell_size
    inb = torch.all((kc >= -grid_half) & (kc < grid_half), dim=-1)
    flat = torch.where(inb, _flat_cell(kc + grid_half, 2 * grid_half), 0)
    slots = torch.where(inb, grid.reshape(-1)[flat], -1)      # [Q, K]
    diff = centers - q[:, None, :]
    sqd = torch.sum(diff * diff, dim=-1)
    # AABB intersect (non-strict, quadtree.h:100-105): box half =
    # search_half, cell half = cell_size/2
    reach = search_half + cell_size * 0.5
    inter = torch.all(torch.abs(diff) <= reach, dim=-1)
    ok = (slots >= 0) & inter & trained[torch.clamp(slots, min=0)] & inb
    return slots, sqd, ok


class NeighborTable(NamedTuple):
    """Per-grid-cell candidate lists: one row gather per query in place of
    the (2 noff + 1)^D window gather of _grid_candidates.

    Entries of a row keep the window-offset enumeration order, so the
    3-nearest argmin breaks ties as the window path does and the results
    are the same. `trained` is baked in at build time: rebuild after
    every retrain.

    keys: [T] sorted flat grid ids (int32-max padded); for the dense
        variant T is the grid size and keys is arange (row = flat id).
    packed: [T, K] candidate entries, slot * W2 + window rank (-1 empty),
        W2 the next pow2 of the window size (2 noff + 1)^D. A candidate's
        cell coord is the query's cell plus the rank's window offset, the
        integer sum the build keyed on.
    n_overflow: [] int32, candidates dropped because a grid cell had more
        than K trained neighbors (the mapper reports it).
    noff: the window half-width the table was built with; a lookup with
        another raises.
    """

    keys: torch.Tensor
    packed: torch.Tensor
    n_overflow: torch.Tensor
    noff: int


def _rank_to_offset(rank: torch.Tensor, noff: int, d: int) -> torch.Tensor:
    """Window rank (ij enumeration of (-noff..noff)^D) -> offset [..., D]."""
    side = 2 * noff + 1
    return torch.stack([(rank // side ** (d - 1 - a)) % side - noff
                        for a in range(d)], dim=-1)


def build_neighbor_table(coords: torch.Tensor, slots: torch.Tensor,
                         trained: torch.Tensor, grid_half: int, noff: int,
                         k_cap: int, dense: bool) -> NeighborTable:
    """Build the candidate table from the live cell list.

    coords: [C, D] integer cell coords (padded rows have slots == -1);
    slots: [C]; trained: [max_cells] bool. Each live, trained cell is
    registered into every grid cell g of its window, at the rank of the
    offset coords - g in the window enumeration: the candidate order of
    _grid_candidates. dense: one row per grid cell (keys = arange);
    otherwise one row per grid cell that has a candidate, found by a
    search of the sorted keys.
    """
    c, d = coords.shape
    dev = coords.device
    side = 2 * grid_half
    offs = _window_offsets(noff, d, dev)                     # [W, D]
    w = offs.shape[0]
    w2 = 1 << (w - 1).bit_length()
    if trained.shape[0] * w2 >= 2 ** 31:
        raise ValueError(f"slot * {w2} overflows the int32 table entries")
    # cell c lands in g = coords + o at window offset coords - g = -o; the
    # ij enumeration is symmetric under negation with the index reversed
    o_rank = (w - 1 - torch.arange(w, device=dev))[None, :]  # [1, W]
    gidx = coords.long()[:, None, :] + offs[None] + grid_half
    inb = torch.all((gidx >= 0) & (gidx < side), dim=-1)     # [C, W]
    gflat = _flat_cell(gidx, side)
    live = (slots >= 0) & trained[torch.clamp(slots, 0,
                                              trained.shape[0] - 1).long()]
    valid = live[:, None] & inb

    big = _INT32_MAX
    key = torch.where(valid, gflat * w + o_rank, big).reshape(-1)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    sg = torch.where(skey < big, skey // w, big)             # flat ids
    e_packed = (slots.long()[:, None] * w2 + o_rank).reshape(-1)[order]

    n = c * w
    if dense:
        t = side ** d
        keys = torch.arange(t, device=dev)
        row = torch.where(sg < big, sg, t)
    else:
        t = n
        u = torch.unique(sg[sg < big])                       # sorted
        keys = torch.full((t,), big, dtype=torch.int64, device=dev)
        keys[:len(u)] = u
        row = torch.where(sg < big,
                          torch.clamp(torch.searchsorted(keys, sg), 0,
                                      t - 1), t)
    counts = torch.bincount(torch.clamp(row, 0, t), minlength=t + 1)[:t]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[torch.clamp(row, 0, t - 1)]
    keep = (sg < big) & (rank < k_cap)
    n_overflow = torch.sum((sg < big) & ~keep).to(torch.int32)
    # dropped entries go to a dummy trailing entry
    tgt = torch.where(keep, row * k_cap + rank, t * k_cap)
    ptbl = torch.full((t * k_cap + 1,), -1, dtype=torch.int32, device=dev)
    ptbl[tgt] = e_packed.to(torch.int32)
    return NeighborTable(keys=keys.to(torch.int32),
                         packed=ptbl[:-1].reshape(t, k_cap),
                         n_overflow=n_overflow, noff=noff)


def _table_candidates(nbrs: NeighborTable, q: torch.Tensor, cell_size,
                      grid_half: int, noff: int, search_half, dense: bool):
    """_grid_candidates from the candidate table: one row gather per
    query, the same (slots, sqd, ok) for the present candidates in the
    same order (trained is baked into the table). Returns [Q, K] each."""
    if noff != nbrs.noff:
        raise ValueError(f"candidate table built with noff={nbrs.noff}, "
                         f"queried with noff={noff}")
    d = q.shape[-1]
    side = 2 * grid_half
    t = nbrs.packed.shape[0]
    w2 = 1 << ((2 * noff + 1) ** d - 1).bit_length()
    k0 = torch.floor(q / cell_size).to(torch.int64)           # [Q, D]
    gidx = k0 + grid_half
    inb = torch.all((gidx >= 0) & (gidx < side), dim=-1)
    gflat = torch.where(inb, _flat_cell(gidx, side), 0)
    if dense:
        row, hit = gflat, inb
    else:
        row = torch.clamp(torch.searchsorted(nbrs.keys,
                                             gflat.to(torch.int32)), 0, t - 1)
        hit = inb & (nbrs.keys[row] == gflat)
    packed = nbrs.packed[row].long()                          # [Q, K]
    slots = packed >> (w2.bit_length() - 1)
    coords = k0[:, None, :] + _rank_to_offset(packed & (w2 - 1), noff, d)
    centers = (coords.to(q.dtype) + 0.5) * cell_size
    diff = centers - q[:, None, :]
    sqd = torch.sum(diff * diff, dim=-1)
    reach = search_half + cell_size * 0.5
    inter = torch.all(torch.abs(diff) <= reach, dim=-1)
    ok = (slots >= 0) & inter & hit[:, None]
    return slots, sqd, ok


def _top3(slots: torch.Tensor, sqd: torch.Tensor, ok: torch.Tensor):
    """The 3 nearest candidates by center distance (GPisMap.cpp:695-698):
    three masked argmin passes, the first lowest index on ties. Returns
    (top_slot [Q, 3], top_ok [Q, 3], n_cand [Q])."""
    n_cand = torch.sum(ok, dim=-1)
    cur = torch.where(ok, sqd, torch.inf)
    cols = torch.arange(cur.shape[-1], device=cur.device)
    tops = []
    for _ in range(3):
        i = torch.argmin(cur, dim=-1)
        tops.append(i)
        cur = torch.where(cols[None, :] == i[:, None], torch.inf, cur)
    top_idx = torch.stack(tops, dim=-1)                       # [Q, 3]
    top_ok = (torch.gather(ok, 1, top_idx)
              & (torch.arange(3, device=ok.device)[None, :]
                 < n_cand[:, None]))
    return torch.gather(slots, 1, top_idx), top_ok, n_cand


def _candidates_top3(nbrs: NeighborTable, q: torch.Tensor, cell_size,
                     grid_half: int, noff: int, search_half, dense: bool):
    """The table's candidates and their 3-nearest selection: (top_slot,
    top_ok, n_cand), those of the window path."""
    return _top3(*_table_candidates(nbrs, q, cell_size, grid_half, noff,
                                    search_half, dense))


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
                q: torch.Tensor, div: int, scale, val_const, grad_const,
                bf16: bool = False):
    """Evaluate one planned pair set through the tile op (its bf16
    variance variant with bf16), then ONE packed scatter back to pair
    order (pair p belongs to query p // div).
    Returns (f [P], g [P, D], vf [P] (inf where not evaluated),
    vg [P, D])."""
    d = q.shape[-1]
    xt, alpha, gf, vl = _cell_args(store, slot_of)
    qt = q[torch.clamp(plan.pair_ids, min=0).long() // div]   # [NT, T, D]
    f_t, g_t, vf_t, vg_t = tile_ops.tile_eval(
        plan.tile_seg, linv_buf, xt, alpha, gf, vl,
        qt.transpose(-1, -2).contiguous(), d=d, scale=scale,
        val_const=val_const, grad_const=grad_const, bf16=bf16)
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
             max_cells: int, max_active: int = 512, factors=None,
             nbrs: NeighborTable = None, nbr_dense: bool = False,
             two_phase: bool = False, bf16: bool = False):
    """Batched SDF+gradient+variance query (GPisMap.cpp:665-763).

    Per query: collect the trained cluster cells intersecting the search
    box, evaluate the nearest cell's GP, and fall back to the up-to-3
    nearest with variance-weighted blending of the best two when the
    nearest is uncertain.

    nbrs: a candidate table (build_neighbor_table, dense as nbr_dense)
    in place of the grid's window; same candidates, same order.
    two_phase: evaluate like the reference's control flow, the rank-0
    pairs first, then only the uncertain queries' rank-1/2 pairs (the
    `var > thre` gate, GPisMap.cpp:706-722). The selection below never
    reads the rank-1/2 results of a confident query, so the outputs are
    the single phase's; the skipped pairs are not counted as dropped.
    Otherwise all 3Q (query, rank) pairs go through one tile plan.
    bf16: the tile evaluation's bf16 variance variant (tile_eval(bf16=),
    the JAX package's pallas_bf16; forward-only); candidates, plan and
    blend are unchanged.

    factors: optional (linv_buf, uniq) cache from factorize_slots;
    without it, each distinct touched cell (at most max_active; overflow
    pairs are dropped and counted) is factorized once for this call.
    Returns (f [Q], grad [Q, D], varf [Q], vargrad [Q, D], TestInfo).
    """
    nq, d = q.shape
    with spans.span("test.candidates"):
        if nbrs is not None:
            top_slot, top_ok, n_cand = _candidates_top3(
                nbrs, q, cell_size, grid_half, noff, search_half, nbr_dense)
        else:
            top_slot, top_ok, n_cand = _top3(*_grid_candidates(
                grid, q, cell_size, grid_half, noff, search_half,
                store.trained))
        seg3 = torch.where(top_ok, top_slot, -1).to(torch.int32)  # [Q, 3]

    if factors is None:
        with spans.span("test.factors"):
            u = torch.unique(torch.where(seg3 >= 0, seg3, _INT32_MAX))
            uniq = u.new_full((max_active,), _INT32_MAX)
            uniq[:min(len(u), max_active)] = u[:max_active]
            slot_of = torch.where(uniq < _INT32_MAX, uniq, -1)
            linv_buf = _factorize_cells(store, slot_of, scale)
    else:
        linv_buf, uniq = factors
        slot_of = torch.where(uniq < _INT32_MAX, uniq, -1)

    def run(seg, div):
        """Plan and evaluate the pairs seg [P] (raw slots, -1 none; pair
        p belongs to query p // div). Slots absent from uniq are dropped
        and counted. Returns (f, g, vf, vg, n_dropped, n_pairs)."""
        with spans.span("test.plan"):
            plan, n_in = segmented.plan_tiles_for_slots(seg, uniq, max_cells,
                                                        max_active, tile)
        with spans.span("test.eval"):
            out = _eval_pairs(store, linv_buf, slot_of, plan, seg.shape[0],
                              q, div, scale, val_const, grad_const, bf16)
            return out + ((torch.sum(seg >= 0) - n_in).to(torch.int32),
                          n_in)

    if two_phase:
        f0, g0, vf0, vg0, nd1, np1 = run(seg3[:, 0].contiguous(), 1)
        with spans.span("test.blend"):
            # the reference's blend gate (GPisMap.cpp:706): ranks 1-2 are
            # consulted only when the nearest evaluation is uncertain; an
            # unevaluated or dropped rank 0 (vf0 == inf) counts as
            # uncertain
            vf0m = torch.where(top_ok[:, 0], vf0, torch.inf)
            uncertain = (n_cand >= 2) & ~(vf0m <= var_thre)
            n_phase2 = torch.sum(uncertain).to(torch.int32)
            seg12 = torch.where(uncertain[:, None], seg3[:, 1:], -1)
        f12, g12, vf12, vg12, nd2, np2 = run(seg12.reshape(-1), 2)
        with spans.span("test.blend"):
            f3 = torch.cat([f0[:, None], f12.reshape(nq, 2)], dim=1)
            g3 = torch.cat([g0[:, None], g12.reshape(nq, 2, d)], dim=1)
            vf3 = torch.cat([vf0[:, None], vf12.reshape(nq, 2)], dim=1)
            vg3 = torch.cat([vg0[:, None], vg12.reshape(nq, 2, d)], dim=1)
            n_dropped, n_pairs = nd1 + nd2, (np1 + np2).to(torch.int32)
            out = _blend(f3, g3, vf3, vg3, top_ok, n_cand, var_thre,
                         default_var)
    else:
        f_p, g_p, vf_p, vg_p, n_dropped, n_pairs = run(seg3.reshape(-1), 3)
        with spans.span("test.blend"):
            n_phase2 = torch.zeros((), dtype=torch.int32, device=q.device)
            out = _blend(f_p.reshape(nq, 3), g_p.reshape(nq, 3, d),
                         vf_p.reshape(nq, 3), vg_p.reshape(nq, 3, d), top_ok,
                         n_cand, var_thre, default_var)
    return out + (TestInfo(n_dropped=n_dropped, n_pairs=n_pairs,
                           n_phase2=n_phase2),)


def _blend(f3, g3, vf3, vg3, top_ok, n_cand, var_thre, default_var):
    """The selection and variance blend of each query's up-to-3 results
    [Q, 3, ...] (GPisMap.cpp:685-758). Returns (f, grad, varf, vargrad)."""
    vf3 = torch.where(top_ok, vf3, torch.inf)

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
    return f_out, g_out, vf_out, vg_out


def map_test_sharded(store: ClusterStore, grid: torch.Tensor,
                     q: torch.Tensor, mesh, **kw):
    """map_test with the query batch q [Q, D] split over the ranks of a
    mesh (parallel.mesh.Mesh), the store, grid and factors replicated.

    Each rank plans and evaluates its own contiguous shard of Q / size
    queries with its own tile plan (the per-thread chunking of the
    reference's test(), GPisMap.cpp:765-810), then the shards are
    all-gathered in one collective and the three TestInfo counters
    summed in one more. Every rank returns the whole batch's results.
    Q must divide by the mesh size. kw goes to map_test as it is, its
    bf16= (the bf16 variance variant) included."""
    nq, d = q.shape
    if nq % mesh.size:
        raise ValueError(f"{nq} queries do not split over {mesh.size} ranks")
    f, g, vf, vg, info = map_test(store, grid, q[mesh.local_rows(nq)], **kw)
    out = mesh.all_gather(torch.cat([f[:, None], g, vf[:, None], vg], 1))
    iv = mesh.all_reduce_sum(torch.stack(
        [info.n_dropped, info.n_pairs, info.n_phase2]).to(torch.int64))
    iv = iv.to(torch.int32)
    return out[:, 0], out[:, 1:1 + d], out[:, 1 + d], out[:, 2 + d:], \
        TestInfo(n_dropped=iv[0], n_pairs=iv[1], n_phase2=iv[2])


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
