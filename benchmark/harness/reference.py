"""Plain reference of a GPIS map's query (plain torch, float64).

What GPisMap's test() returns for a set of surface nodes, worked out from
the nodes alone (GPisMap.cpp:665-810, OnGPIS.cpp, covFnc.cpp; the same
for the 3D map, GPisMap3.cpp:800-949):

  * the map's cluster cells are the cells of side cell_size that hold at
    least one node, centred at (k + 0.5) cell_size;
  * a cell's GP is fitted to the nodes within radius rt * cell_size / 2
    of its centre (the nearest `cap` of them where more lie there): the
    Matern-3/2 joint value + gradient covariance, where a node gives
    gradient rows unless its gradient noise exceeds 0.1001 or its
    gradient is zero (those get value noise 2.0), with GPisMap's 2D
    quirk kept (the x-gradient diagonal takes sqrt(sigx * siggrad));
  * a query takes the cells whose boxes meet its search box, evaluates
    the three nearest by centre distance, and returns the nearest's
    result when it is confident (variance <= var_thre) or when it is the
    only candidate, else the best of the three if it is confident, else
    the variance-weighted blend of the best two.

It imports nothing of the program. Each decision that float32 rounding
could take either way (a node on a support ball's boundary, two cells
at the same distance, a variance at a threshold or tied with another)
is enumerated: the reference returns every outcome consistent with the
float64 values within a tolerance, and the check takes the one nearest
the program's answer; so is a cell on the search box's edge, taken in
and left out. A query whose outcomes are too many to enumerate is left
out and counted.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np
import torch

F64 = torch.float64
# decision tolerances, as shares of the quantity's own scale
TOL_SUPPORT = 1e-5      # of R^2, a node on a support ball's boundary
TOL_DIST = 1e-4         # of cell_size^2, two candidate cells tied
TOL_EDGE = 1e-5         # of cell_size, a cell on the search box's edge
TOL_VAR = 1e-3          # absolute, a variance at a threshold or a tie
MAX_ALTS = 400          # alternatives enumerated for one query


@dataclass(frozen=True)
class GPSpec:
    """The map's query constants, as the configuration states them."""

    dim: int
    scale: float            # Matern length scale
    cell_size: float        # 2 * cluster_halfleng
    radius_times: float     # support radius = radius_times * cell_size / 2
    support_cap: int
    search_half: float
    val_const: float
    grad_const: float
    var_thre: float
    default_var: float


class Cells:
    """The map's cells and their fitted GPs (one or two variants each)."""

    def __init__(self, spec: GPSpec, pos, grad, val, pos_sig, grad_sig,
                 device):
        self.spec = spec
        self.device = device
        d = spec.dim
        t = lambda a: torch.as_tensor(np.asarray(a), device=device,
                                      dtype=F64)
        self.pos, self.grad = t(pos).reshape(-1, d), t(grad).reshape(-1, d)
        self.val, self.psig, self.gsig = t(val), t(pos_sig), t(grad_sig)
        cs = spec.cell_size
        keys = torch.floor(self.pos / cs).to(torch.int64)
        if len(keys):
            self.keys = torch.unique(keys, dim=0)
        else:
            self.keys = keys
        self.centers = (self.keys.to(F64) + 0.5) * cs
        self.codes, self.order = torch.sort(self._code(self.keys))
        self._find_supports()

    # -- cell lookup ---------------------------------------------------
    _BASE = 1 << 20

    def _code(self, keys):
        """One integer per cell key [..., D]."""
        c = torch.zeros(keys.shape[:-1], dtype=torch.int64,
                        device=keys.device)
        for a in range(keys.shape[-1]):
            c = c * self._BASE + (keys[..., a] + self._BASE // 2)
        return c

    def lookup(self, keys):
        """Cell index of integer cell keys [..., D] (-1 where no cell)."""
        code = self._code(keys)
        if len(self.codes) == 0:
            return torch.full(code.shape, -1, dtype=torch.int64,
                              device=code.device)
        i = torch.searchsorted(self.codes, code.reshape(-1)).reshape(
            code.shape)
        i = torch.clamp(i, max=len(self.codes) - 1)
        hit = self.codes[i] == code
        return torch.where(hit, self.order[i], -1)

    # -- supports and fits ---------------------------------------------
    def _find_supports(self):
        """Every cell's support sets; the fits are made on first use."""
        sp = self.spec
        r2 = (sp.radius_times * sp.cell_size / 2.0) ** 2
        tol = TOL_SUPPORT * r2
        self.supports = []      # per cell: [ids] or [ids, flipped ids]
        self.fits = {}          # (cell, variant) -> fit
        n = len(self.pos)
        for c0 in range(0, len(self.keys), 64):
            ctr = self.centers[c0:c0 + 64]
            d2 = torch.sum((self.pos[None] - ctr[:, None]) ** 2, -1) \
                if n else torch.zeros((len(ctr), 0), dtype=F64,
                                      device=self.device)
            for j in range(len(ctr)):
                self.supports.append(self._support_sets(d2[j], r2, tol))
        self.ambiguous = torch.as_tensor(
            [len(s) > 1 for s in self.supports], dtype=torch.bool,
            device=self.device)

    def fit(self, cell: int, variant: int):
        key = (cell, variant)
        if key not in self.fits:
            self.fits[key] = self._fit(self.supports[cell][variant])
        return self.fits[key]

    def rows(self, cell: int) -> tuple:
        """(value rows, gradient rows) of a cell's GP: its support nodes,
        and those of them that give gradient rows (float64 decision)."""
        ids = self.supports[cell][0]
        g = self.grad[ids]
        no_grad = (self.gsig[ids] > 0.1001) | torch.all(torch.abs(g) < 1e-6,
                                                         dim=-1)
        return len(ids), int((~no_grad).sum())

    def _support_sets(self, d2, r2, tol):
        """The support's node ids by the float64 decision, and, where a
        node lies within tol of the boundary (of the ball, or of the cap's
        cut), the set with those decisions flipped."""
        cap = self.spec.support_cap
        inside = d2 < r2
        near = torch.abs(d2 - r2) <= tol
        cnt = int(inside.sum())
        if cnt > cap:
            # the nearest cap nodes; ties at the cut are the boundary
            dd, idx = torch.sort(torch.where(inside, d2, torch.inf))
            cut = 0.5 * (dd[cap - 1] + dd[cap])
            inside = d2 <= dd[cap - 1]
            near = torch.abs(d2 - cut) <= tol
        base = torch.nonzero(inside).reshape(-1)
        if not bool(near.any()):
            return [base]
        flip = torch.nonzero(inside ^ near).reshape(-1)
        return [base, flip]

    def _fit(self, ids):
        sp = self.spec
        d = sp.dim
        x = self.pos[ids]
        g = self.grad[ids]
        gsig = self.gsig[ids]
        psig = self.psig[ids]
        no_grad = (gsig > 0.1001) | torch.all(torch.abs(g) < 1e-6, dim=-1)
        sigx = torch.where(no_grad, torch.full_like(psig, 2.0), psig)
        gi = torch.nonzero(~no_grad).reshape(-1)
        m, ng = len(ids), len(gi)
        a = math.sqrt(3.0) / sp.scale
        diff = x[:, None, :] - x[None, :, :]
        r = torch.linalg.norm(diff, dim=-1)
        e = torch.exp(-a * r)
        kff = (1.0 + a * r) * e
        kff = kff - torch.diag(torch.diag(kff)) + torch.diag(1.0 + sigx)
        # cov(grad_ax at p, value at q) = -a^2 (x_p - x_q)_ax e
        kgf = -(a * a) * diff[gi] * e[gi][..., None]            # [ng, m, D]
        dg = diff[gi][:, gi]                                    # [ng, ng, D]
        rg = r[gi][:, gi]
        eg = e[gi][:, gi]
        inv_r = torch.where(rg > 0, 1.0 / torch.where(rg > 0, rg, 1.0), 0.0)
        eye_d = torch.eye(d, dtype=F64, device=self.device)
        kgg = (a * a) * (eye_d - a * dg[..., :, None] * dg[..., None, :]
                         * inv_r[..., None, None]) * eg[..., None, None]
        same = torch.eye(ng, dtype=F64, device=self.device)
        kgg = kgg * (1.0 - same)[..., None, None]
        gs, ps = gsig[gi], sigx[gi]
        diag = [(a * a + torch.sqrt(ps * gs)) if (d == 2 and ax == 0)
                else (a * a + gs) for ax in range(d)]
        size = m + ng * d
        k = torch.zeros((size, size), dtype=F64, device=self.device)
        k[:m, :m] = kff
        for ax in range(d):
            rs = slice(m + ax * ng, m + (ax + 1) * ng)
            k[rs, :m] = kgf[..., ax]
            k[:m, rs] = kgf[..., ax].T
            for bx in range(d):
                cs = slice(m + bx * ng, m + (bx + 1) * ng)
                k[rs, cs] = kgg[..., ax, bx]
            k[rs, rs] += torch.diag(diag[ax])
        y = torch.cat([self.val[ids]] + [g[gi, ax] for ax in range(d)])
        chol = torch.linalg.cholesky(k)
        alpha = torch.cholesky_solve(y[:, None], chol)[:, 0]
        return dict(x=x, xg=x[gi], chol=chol, alpha=alpha, m=m, ng=ng)

    def evaluate(self, cell: int, variant: int, q: torch.Tensor):
        """(f [P], g [P, D], vf [P], vg [P, D]) of one cell's GP at q."""
        sp = self.spec
        d = sp.dim
        fit = self.fit(cell, variant)
        a = math.sqrt(3.0) / sp.scale
        m, ng = fit["m"], fit["ng"]
        diff = fit["x"][:, None, :] - q[None, :, :]               # [m, P, D]
        r = torch.linalg.norm(diff, dim=-1)
        e = torch.exp(-a * r)
        kf1 = (a * a) * diff * e[..., None]
        # rows: value rows [m], gradient rows [ng] per axis; columns:
        # f*, then grad* per axis
        cols_f = [(1.0 + a * r) * e] + [kf1[..., j] for j in range(d)]
        if ng:
            dg = fit["xg"][:, None, :] - q[None, :, :]
            rg = torch.linalg.norm(dg, dim=-1)
            eg = torch.exp(-a * rg)
            inv_r = torch.where(rg > 0, 1.0 / torch.where(rg > 0, rg, 1.0),
                                0.0)
            rows_g = []
            for ax in range(d):
                row = [-(a * a) * dg[..., ax] * eg]
                for j in range(d):
                    dl = 1.0 if ax == j else 0.0
                    row.append((a * a) * (dl - a * dg[..., ax] * dg[..., j]
                                          * inv_r) * eg)
                rows_g.append(row)
        blocks = []
        for c in range(1 + d):
            parts = [cols_f[c]] + ([rows_g[ax][c] for ax in range(d)]
                                   if ng else [])
            blocks.append(torch.cat(parts, 0))                  # [n, P]
        ks = torch.stack(blocks, 0)                             # [1+D, n, P]
        mean = torch.einsum("cnp,n->cp", ks, fit["alpha"])
        v = torch.linalg.solve_triangular(
            fit["chol"], ks.permute(1, 0, 2).reshape(ks.shape[1], -1),
            upper=False)
        vs = torch.sum(v * v, 0).reshape(1 + d, -1)
        vf = sp.val_const - vs[0]
        vg = sp.grad_const - vs[1:]
        return mean[0], mean[1:].T, vf, vg.T


def candidates(cells: Cells, q: torch.Tensor):
    """Per query, the cells whose boxes meet its search box, by centre
    distance: (idx [Q, L] (-1 padded), sqd [Q, L], edge [Q, L]: the box
    test within TOL_EDGE of its limit, n_sure [Q], n_max [Q])."""
    sp = cells.spec
    d, cs = sp.dim, sp.cell_size
    reach = sp.search_half + 0.5 * cs
    w = int(math.ceil(reach / cs)) + 1
    r = torch.arange(-w, w + 1, device=q.device)
    offs = torch.stack(torch.meshgrid(*([r] * d), indexing="ij"),
                       -1).reshape(-1, d)
    k0 = torch.floor(q / cs).to(torch.int64)
    out = []
    for s in range(0, len(q), 8192):
        kk = k0[s:s + 8192, None, :] + offs[None]          # [q, W, D]
        idx = cells.lookup(kk)
        diff = torch.abs((kk.to(F64) + 0.5) * cs - q[s:s + 8192, None, :])
        lim = torch.amax(diff, -1)
        tol = TOL_EDGE * cs
        sure = (idx >= 0) & (lim <= reach - tol)
        maybe = (idx >= 0) & (lim <= reach + tol)
        sqd = torch.where(maybe, torch.sum(diff * diff, -1), torch.inf)
        sqd, order = torch.sort(sqd, dim=-1)
        idx = torch.gather(torch.where(maybe, idx, -1), 1, order)
        edge = torch.gather(maybe & ~sure, 1, order)
        out.append((idx[:, :12], sqd[:, :12], edge[:, :12], sure.sum(-1),
                    maybe.sum(-1)))
    return [torch.cat(x) for x in zip(*out)]


def _orderings(sqd_row, n, tol):
    """Ordered triples of positions (of the first n sorted candidates)
    consistent with the distances within tol: permutations within tie
    groups, of the groups that reach the first three places."""
    groups, start = [], 0
    while start < n and start < 3:
        end = start + 1
        while end < n and sqd_row[end] - sqd_row[end - 1] <= tol:
            end += 1
        groups.append(list(range(start, end)))
        start = end
    out = set()
    for perm in itertools.product(*[itertools.permutations(g)
                                    for g in groups]):
        out.add(tuple([i for p in perm for i in p][:3]))
        if len(out) > MAX_ALTS:
            break
    return sorted(out)


def reference_answers(cells: Cells, q_np: np.ndarray):
    """Every outcome the reference admits for each query.

    Returns (rows [R, K, 2 + 2D] float64, valid [R, K], row_query [R],
    excluded [Q] bool): R rows of (cell, variant) triples, K decision
    combinations each, the query each row answers, and the queries left
    out (a cell on the search box's edge among the nearest, more than
    MAX_ALTS outcomes, or a tie that runs past the twelve nearest
    candidates kept)."""
    sp = cells.spec
    d = sp.dim
    dev = cells.device
    q = torch.as_tensor(np.asarray(q_np), device=dev, dtype=F64)
    nq = len(q)
    idx, sqd, edge, n_sure, n_max = (x.cpu().numpy()
                                     for x in candidates(cells, q))
    tol_d = TOL_DIST * sp.cell_size ** 2
    amb = cells.ambiguous.cpu().numpy()
    nmax = np.minimum(n_max, idx.shape[1])
    last = idx.shape[1] - 1
    with np.errstate(invalid="ignore"):
        gaps = np.diff(sqd[:, :4], axis=1)
        # a tie group that could run past the kept columns
        excluded = (nmax > last) & (sqd[:, last] - sqd[:, 2] <= tol_d)
    kk = np.arange(3)[None, :]
    tie = ((gaps <= tol_d) & (kk + 1 < nmax[:, None])).any(1)
    top = np.where(kk < nmax[:, None], idx[:, :3], -1)
    amb_top = (amb[np.clip(top, 0, None)] & (top >= 0)).any(1) \
        if len(amb) else np.zeros(nq, bool)
    edge_top = (n_sure != n_max) & ((n_sure <= 1) | edge[:, :4].any(1))
    fast = ~excluded & ~tie & ~amb_top & ~edge_top

    trip_cell = [top[fast]]
    trip_var = [np.zeros_like(top[fast])]
    row_query = [np.nonzero(fast)[0]]
    row_ncand = [n_max[fast]]
    for i in np.nonzero(~excluded & ~fast)[0]:
        n = int(nmax[i])
        epos = [p for p in range(min(n, 6)) if edge[i, p]]
        got = []
        for keep in itertools.product((True, False), repeat=len(epos)):
            drop = {p for p, k in zip(epos, keep) if not k}
            pos = [p for p in range(n) if p not in drop]
            nc = int(n_sure[i]) + sum(keep)
            for o in _orderings(sqd[i, pos], len(pos), tol_d):
                cl = [int(idx[i, pos[p]]) for p in o]
                vs = [(0, 1) if amb[c] else (0,) for c in cl]
                got.extend((cl, var, nc) for var in itertools.product(*vs))
        if len(got) > MAX_ALTS:
            excluded[i] = True
            continue
        for cl, var, nc in got:
            pad = 3 - len(cl)
            trip_cell.append(np.array([cl + [-1] * pad]))
            trip_var.append(np.array([list(var) + [0] * pad]))
            row_query.append(np.array([i]))
            row_ncand.append(np.array([nc]))
    cell = np.concatenate(trip_cell).reshape(-1, 3)
    var = np.concatenate(trip_var).reshape(-1, 3)
    rq = np.concatenate(row_query).astype(np.int64)
    rn = np.concatenate(row_ncand).astype(np.int64)

    # evaluate every (cell, variant, query) pair once, grouped by fit
    nr = len(rq)
    ok = cell >= 0
    key = np.where(ok, (cell * 2 + var) * nq + rq[:, None], -1)
    uk, inv = np.unique(key[ok], return_inverse=True)
    res = np.full((len(uk), 2 + 2 * d), np.nan)
    fit_of = uk // nq
    for fid in np.unique(fit_of):
        sel = np.nonzero(fit_of == fid)[0]
        qi = torch.as_tensor(uk[sel] % nq, device=dev)
        f, g, vf, vg = cells.evaluate(int(fid // 2), int(fid % 2), q[qi])
        res[sel] = torch.cat([f[:, None], g, vf[:, None], vg],
                             1).cpu().numpy()
    ev = np.full((nr, 3, 2 + 2 * d), np.nan)
    ev[ok] = res[inv]
    rows, valid = blends(ev, rn, sp)
    return rows, valid, rq, excluded


def blends(ev: np.ndarray, n_cand: np.ndarray, sp: GPSpec):
    """Outputs of triples ev [R, 3, 2 + 2D] (rows [f, g, vf, vg] of the
    nearest three by distance, NaN where absent) under each decision the
    variances admit within TOL_VAR: 2 (nearest or not) x 6 (variance
    rankings) x 2 (best confident or not) combinations. Returns (out
    [R, 24, 2 + 2D], valid [R, 24])."""
    d = sp.dim
    thr, tol = sp.var_thre, TOL_VAR
    nr = len(ev)
    default = np.concatenate([[0.0], np.zeros(d), [sp.default_var],
                              np.zeros(d)])
    v = np.where(np.isnan(ev[:, :, 1 + d]), np.inf, ev[:, :, 1 + d])
    present = ~np.isnan(ev[:, :, 0])
    out = np.empty((nr, 24, 2 + 2 * d))
    valid = np.zeros((nr, 24), bool)
    none = (n_cand == 0) | ~present[:, 0]
    combos = [(u, rk, b) for u in (True, False)
              for rk in itertools.permutations(range(3))
              for b in (True, False)]
    for c, (use_near, rk, best_lt) in enumerate(combos):
        if use_near:
            ok = (n_cand == 1) | (v[:, 0] <= thr + tol)
            ok &= (rk == (0, 1, 2)) & best_lt       # one combination
            res = ev[:, 0]
        else:
            ok = (n_cand >= 2) & (v[:, 0] > thr - tol)
            ok &= (v[:, rk[0]] <= v[:, rk[1]] + tol) & \
                (v[:, rk[1]] <= v[:, rk[2]] + tol) & present[:, rk[0]]
            vb = v[:, rk[0]]
            eb = ev[:, rk[0]]
            if best_lt:
                ok &= vb < thr + tol
                res = eb
            else:
                ok &= vb >= thr - tol
                fin = np.isfinite(v[:, rk[1]])
                es = np.where(fin[:, None], ev[:, rk[1]], eb)
                w1 = vb - thr
                w2 = np.where(fin, v[:, rk[1]], vb) - thr
                w12 = np.where(np.abs(w1 + w2) > 0, w1 + w2, 1.0)
                with np.errstate(invalid="ignore", over="ignore"):
                    res = (w2[:, None] * eb + w1[:, None] * es) / w12[:, None]
        ok = ok | (none & (c == 0))
        res = np.where(none[:, None], default, res)
        bad = ~np.isfinite(res[:, 1 + d])
        res = np.where(bad[:, None], default, res)
        out[:, c] = res
        valid[:, c] = ok
    return out, valid


def compare(rows, valid, row_query, excluded, got: np.ndarray,
            sp: GPSpec):
    """The program's answers got [Q, 2 + 2D] against the reference's
    outcomes: per query, the outcome nearest the answer (by the largest of
    its four gaps). Returns the four largest gaps over the compared
    queries (f, grad and var f absolute; var grad over grad_const), the
    excluded share, and the query of the largest gap."""
    d = sp.dim
    g = np.asarray(got, np.float64)[row_query][:, None, :]
    diff = np.abs(rows - g)
    parts = np.stack([diff[..., 0], diff[..., 1:1 + d].max(-1),
                      diff[..., 1 + d],
                      diff[..., 2 + d:].max(-1) / sp.grad_const], -1)
    parts = np.where(np.isnan(parts), np.inf, parts)
    worst = np.where(valid, parts.max(-1), np.inf)          # [R, K]
    k = np.argmin(worst, 1)
    best_row = parts[np.arange(len(k)), k]                  # [R, 4]
    best_val = worst[np.arange(len(k)), k]
    nq = len(got)
    per_q = np.full(nq, np.inf)
    np.minimum.at(per_q, row_query, best_val)
    # the gaps of each query's chosen row
    chosen = np.full((nq, 4), np.inf)
    order = np.argsort(best_val, kind="stable")[::-1]
    chosen[row_query[order]] = best_row[order]
    cmp = ~excluded
    gaps = chosen[cmp].max(0) if cmp.any() else np.zeros(4)
    worst_q = int(np.nonzero(cmp)[0][np.argmax(chosen[cmp].max(1))]) \
        if cmp.any() else -1
    return dict(f=float(gaps[0]), grad=float(gaps[1]), var_f=float(gaps[2]),
                var_grad=float(gaps[3]),
                excluded_share=float(excluded.mean()) if nq else 0.0,
                worst_query=worst_q)
