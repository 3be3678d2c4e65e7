"""Plain reference of a frame's new measurements (plain torch, float64).

What GPisMap's update() makes of one frame before it touches the map,
worked out from the frame alone (GPisMap.cpp:105-149 and 466-572 for a
LiDAR scan, GPisMap3.cpp:125-216 and 580-696 for a depth image;
ObsGP.cpp:85-187 and 193-463 for the observation GPs):

  * the range gate and the sensor-to-world transform of each beam or
    (obs_skip-subsampled) pixel;
  * the observation GP of the frame's inverse depth: overlapping groups
    of beams (1D) or image cells (2D), an OU kernel GP each;
  * each beam or pixel's candidate surface node: inserted where the
    observation GP is confident at its ray and at its probes (+-delx
    along each axis), with the normal from the probes' occupancy
    differences and the noise model of the reference.

and what the frame does to the nodes the map held before it
(GPisMap.cpp:184-455, GPisMap3.cpp:262-569):

  * the cull of the cluster cells in view (range and field of view, by
    each cell's corners), the cells worked out from the nodes' positions
    on the tree's lattice;
  * the re-evaluation of each node of those cells against the frame's
    observation GP: the occupancy gate, the re-localization along the
    node's normal (2D the iterative search, 3D the reference's
    closed-form steps), the probes' normal and noise, the fusion with
    the node's old estimate, and the node's action (keep, double its
    noises, remove, or move it with the fused values).

It imports nothing of the program. The check (compare_frame) sets the
map after the frame beside the map before it: each node the reference
re-evaluates has to show its action and, where it moved, sit at the
fused position with the fused normal and noises; each node the frame
added has to be a candidate's or a moved node's; and a candidate's node
has to carry its normal and noises.
"""
from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
SENTINEL = 1e6
TOL_VAR = 1e-4           # a variance this close to the gate is ambiguous
TOL_GRAD2 = 1e-3         # relative band around the normal's |g|^2 test
TOL_OCC = 2e-3           # an occupancy this close to a gate is ambiguous
TOL_NOISE = 1e-3         # a noise this close to the discard test is too
VIEW_MIN = 0.5           # the tail of the new nodes' gaps is taken over
                         # views at least this square to the surface
RELOC_ITERS = 10         # the re-localization's steps (GPisMap.cpp:273)
OCC_STOP = 0.02          # |occupancy| at which it stops


def _occ(rinv, rinv0, a):
    return 2.0 * (torch.sigmoid(a * (rinv - rinv0)) - 0.5)


def _ou_fit(x, f, valid, scale, noise):
    """Batched OU GPs: x [B, M, D], f [B, M], valid [B, M]. Returns
    (chol, alpha), invalid rows held as identity rows."""
    diff = x[:, :, None, :] - x[:, None, :, :]
    k = torch.exp(-torch.linalg.norm(diff, dim=-1) / scale)
    m = x.shape[1]
    eye = torch.eye(m, dtype=F64, device=x.device)
    k = k * (1 - eye) + (1.0 + noise) * eye
    vm = valid[:, :, None] & valid[:, None, :]
    k = torch.where(vm, k, 0.0)
    k = torch.where((~valid[:, :, None]) & (eye > 0), 1.0, k)
    chol = torch.linalg.cholesky(k)
    alpha = torch.cholesky_solve(torch.where(valid, f, 0.0)[..., None],
                                 chol)[..., 0]
    return chol, alpha


def _ou_test(x, valid, chol, alpha, trained, gidx, q, scale, noise):
    """Posterior (mean, var) at q [Q, D] of group gidx [Q] each."""
    means, vars_ = [], []
    for s in range(0, len(q), 8192):
        g = gidx[s:s + 8192]
        diff = x[g] - q[s:s + 8192, None, :]
        ks = torch.where(valid[g], torch.exp(
            -torch.linalg.norm(diff, dim=-1) / scale), 0.0)
        mean = torch.sum(ks * alpha[g], -1)
        v = torch.linalg.solve_triangular(chol[g], ks[..., None],
                                          upper=False)[..., 0]
        var = 1.0 + noise - torch.sum(v * v, -1)
        tr = trained[g]
        means.append(torch.where(tr, mean, 0.0))
        vars_.append(torch.where(tr, var, SENTINEL))
    if not means:
        z = q.new_zeros(0)
        return z, z
    return torch.cat(means), torch.cat(vars_)


class ObsGP1D:
    """The partitioned GP of a scan's inverse sqrt range over its beam
    angles (ObsGP.cpp:85-187)."""

    def __init__(self, theta, f, valid, op):
        self.op = op
        gs, ov = op["group_size"], op["overlap"]
        th, fv = theta[valid], f[valid]
        n = len(th)
        ng = n // gs + 1
        self.ok = ng >= 2 and n > 0
        rem = n - (ng - 2) * gs
        starts, sizes, bidx = [], [], []
        for g in range(ng):
            if g < ng - 2:
                starts.append(g * gs)
                sizes.append(gs + ov)
                bidx.append(g * gs + gs + ov - ov // 2)
            elif g == ng - 2:
                starts.append(g * gs)
                sizes.append(rem // 2 + ov + 1)
                bidx.append(g * gs + rem // 2 + ov - ov // 2)
            else:
                starts.append((ng - 2) * gs + rem // 2)
                sizes.append(rem - rem // 2)
                bidx.append(n - 1)
        m = gs + ov
        dev = theta.device
        idx = torch.tensor(starts, device=dev)[:, None] + torch.arange(
            m, device=dev)[None]
        ing = torch.arange(m, device=dev)[None] < torch.tensor(
            [min(s, m) for s in sizes], device=dev)[:, None]
        idx = torch.clamp(idx, 0, max(n - 1, 0))
        self.x = th[idx][..., None] if n else theta.new_zeros((ng, m, 1))
        fg = fv[idx] if n else theta.new_zeros((ng, m))
        self.valid = ing if n else torch.zeros_like(ing)
        self.trained = self.valid.any(-1) & self.ok
        self.chol, self.alpha = _ou_fit(self.x, fg, self.valid, op["scale"],
                                        op["noise"])
        clamp = lambda i: th[min(max(i, 0), n - 1)] if n else th.new_zeros(())
        self.bounds = torch.stack([clamp(0)] + [clamp(i) for i in bidx])
        self.liml = clamp(0) + op["margin"]
        self.limr = clamp(n - 1) - op["margin"]
        self.ng = ng

    def test(self, q):
        op = self.op
        gidx = torch.sum(self.bounds[None, 1:] < q[:, None], -1)
        gidx = torch.clamp(gidx, 0, self.ng - 1)
        lo = self.bounds[gidx]
        hi = torch.where(gidx + 1 <= self.ng, self.bounds[torch.clamp(
            gidx + 1, max=self.ng)], torch.inf)
        ok = (q >= self.liml) & (q <= self.limr) & (q > lo) & (q < hi) \
            & self.ok
        mean, var = _ou_test(self.x, self.valid, self.chol, self.alpha,
                             self.trained, gidx, q[:, None], op["scale"],
                             op["noise"])
        return torch.where(ok, mean, 0.0), torch.where(ok, var, SENTINEL)


def _partition(n, gs, ov):
    ng = (n - ov) // gs + 1
    i0 = [g * gs for g in range(ng)]
    i1 = [g * gs + gs + ov - 1 if g < ng - 1 else n - 1 for g in range(ng)]
    bnd = [i1[g] - ov // 2 if g < ng - 1 else n - 1 for g in range(ng)]
    return ng, i0, i1, bnd


class ObsGP2D:
    """The partitioned GP of a depth image's inverse depth over its
    (v, u) ray coordinates (ObsGP.cpp:193-463)."""

    def __init__(self, v, u, zinv, op):
        self.op = op
        gs, ov = op["group_size"], op["overlap"]
        ni, nj = len(v), len(u)
        ng0, i0, i1, bi = _partition(ni, gs, ov)
        ng1, j0, j1, bj = _partition(nj, gs, ov)
        w = gs + ov
        dev = v.device

        def win(s, e, n):
            idx = torch.tensor(s, device=dev)[:, None] + torch.arange(
                w, device=dev)[None]
            return torch.clamp(idx, 0, n - 1), idx <= torch.tensor(
                e, device=dev)[:, None]

        ri, rin = win(i0, i1, ni)
        cj, cin = win(j0, j1, nj)
        fv = zinv[ri[:, None, None, :], cj[None, :, :, None]]
        ok = rin[:, None, None, :] & cin[None, :, :, None] & (fv > 0)
        vs = v[ri][:, None, None, :].expand(fv.shape)
        us = u[cj][None, :, :, None].expand(fv.shape)
        c = ng0 * ng1
        self.x = torch.stack([vs, us], -1).reshape(c, w * w, 2)
        self.valid = ok.reshape(c, w * w)
        self.trained = self.valid.any(-1)
        self.chol, self.alpha = _ou_fit(self.x, fv.reshape(c, w * w),
                                        self.valid, op["scale"], op["noise"])
        self.val_i = torch.cat([v[:1], v[torch.tensor(bi, device=dev)]])
        self.val_j = torch.cat([u[:1], u[torch.tensor(bj, device=dev)]])
        self.ng0, self.ng1 = ng0, ng1

    def test(self, vu):
        op = self.op
        vq, uq = vu[:, 0], vu[:, 1]
        m = op["margin"]
        ok = ((vq >= self.val_i[0] + m) & (vq <= self.val_i[-1] - m)
              & (uq >= self.val_j[0] + m) & (uq <= self.val_j[-1] - m))
        a = torch.clamp(torch.searchsorted(self.val_i[1:].contiguous(),
                                           vq.contiguous(), right=True),
                        0, self.ng0 - 1)
        b = torch.clamp(torch.searchsorted(self.val_j[1:].contiguous(),
                                           uq.contiguous(), right=True),
                        0, self.ng1 - 1)
        mean, var = _ou_test(self.x, self.valid, self.chol, self.alpha,
                             self.trained, a * self.ng1 + b, vu,
                             op["scale"], op["noise"])
        return torch.where(ok, mean, 0.0), torch.where(ok, var, SENTINEL)


def _candidates(loc, glob, rot, occ, gate_var, probe_var, dist_noise, mp):
    """The shared tail of both dimensions: normals from the probes'
    occupancy, the noise model, and the insert decision with its margin."""
    d = loc.shape[-1]
    delx = mp["delx"]
    graw = torch.stack([occ[:, 2 * i] - occ[:, 2 * i + 1]
                        for i in range(d)], -1) / delx
    norm2 = torch.sum(graw * graw, -1)
    hasg = norm2 > 1e-6
    gl = graw / torch.sqrt(torch.clamp(norm2, min=1e-24))[:, None]
    dist = torch.linalg.norm(loc, dim=-1)
    cos = -torch.sum(loc * gl, -1) / torch.clamp(dist, min=1e-12)
    view = torch.clamp(cos, min=0.1)
    mpn = mp["min_position_noise"]
    noise = mpn * dist_noise + mpn * (1.0 - view ** 2) / view ** 2
    gnoise = torch.clamp(torch.abs(occ.mean(-1)), mp["min_grad_noise"], 1.0)
    thre = mp["obs_var_thre"]
    allv = torch.cat([gate_var[:, None], probe_var], -1)
    ok = torch.all(allv <= thre, -1)
    margin = torch.amin(torch.abs(allv - thre), -1)
    return dict(pos=glob, insert_ok=ok, view=torch.where(hasg, cos, 0.0),
                ambiguous=(margin <= TOL_VAR)
                | (torch.abs(norm2 - 1e-6) <= TOL_GRAD2 * 1e-6),
                grad=torch.where(hasg[:, None], gl @ rot.T, graw),
                noise=torch.where(hasg, noise, 100.0),
                grad_noise=torch.where(hasg, gnoise, 1.0))


def scan_candidates(thetas, ranges, pose6, mp, op, device) -> dict:
    """The candidate node of every beam of one LiDAR scan (a beam out of
    the range gate is never inserted)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device,
                                  dtype=F64)
    th, r, p = t(thetas), t(ranges), t(pose6)
    tr, rot = p[:2], p[2:6].reshape(2, 2).T          # column-major
    valid = (r > mp["min_range"]) & (r < mp["max_range"])
    f = 1.0 / torch.sqrt(torch.clamp(r, min=1e-12))
    loc = torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
    glob = (loc + loc.new_tensor(mp["sensor_offset"])) @ rot.T + tr
    obs = ObsGP1D(th, f, valid, op)
    _, var0 = obs.test(th)
    pert = loc.new_tensor([(1., 0.), (-1., 0.), (0., 1.), (0., -1.)]) \
        * mp["delx"]
    pp = loc[:, None, :] + pert[None]
    pr = torch.linalg.norm(pp, dim=-1)
    prinv0, pvar = obs.test(torch.atan2(pp[..., 1], pp[..., 0]).reshape(-1))
    prinv0, pvar = prinv0.reshape(-1, 4), pvar.reshape(-1, 4)
    occ = _occ(1.0 / torch.sqrt(torch.clamp(pr, min=1e-12)), prinv0,
               pr * 30.0)
    c = _candidates(loc, glob, rot, occ, var0, pvar,
                    torch.clamp(r * r, 1.0, 100.0), mp)
    c["insert_ok"] &= valid
    c["ambiguous"] &= valid
    c["frame"] = dict(obs=obs, tr=tr, rot=rot,
                      rmax=float(torch.max(torch.where(valid, r, 0.0))))
    return c


def depth_candidates(depth, pose12, cam, mp, op, device) -> dict:
    """The candidate node of every obs_skip-subsampled pixel of one depth
    image (a pixel out of the range gate is never inserted)."""
    skip = mp["obs_skip"]
    m, n = cam.height // skip, cam.width // skip
    dep = torch.as_tensor(np.asarray(depth, np.float32), device=device,
                          dtype=F64)
    p = torch.as_tensor(np.asarray(pose12, np.float32), device=device,
                        dtype=F64)
    tr, rot = p[:3], p[3:12].reshape(3, 3).T         # column-major
    rows = torch.arange(m, device=device) * skip
    cols = torch.arange(n, device=device) * skip
    z = dep[rows][:, cols]
    valid = (z > mp["min_range"]) & (z < mp["max_range"])
    zinv = torch.where(valid, 1.0 / torch.clamp(z, min=1e-12), -1.0)
    v = (rows.to(F64) - cam.cy) / cam.fy
    u = (cols.to(F64) - cam.cx) / cam.fx
    loc = torch.stack([u[None, :] * z, v[:, None] * z, z], -1)
    obs = ObsGP2D(v, u, zinv, op)
    valid = valid.reshape(-1)
    loc = loc.reshape(-1, 3)
    glob = loc @ rot.T + tr
    vu0 = torch.stack([v[:, None].expand(m, n), u[None, :].expand(m, n)],
                      -1).reshape(-1, 2)
    _, var0 = obs.test(vu0)
    pert = torch.tensor([(1., 0., 0.), (-1., 0., 0.), (0., 1., 0.),
                         (0., -1., 0.), (0., 0., 1.), (0., 0., -1.)],
                        dtype=F64, device=device) * mp["delx"]
    pp = loc[:, None, :] + pert[None]
    pz = torch.where(torch.abs(pp[..., 2]) > 1e-12, pp[..., 2], 1e-12)
    pvu = torch.stack([pp[..., 1] / pz, pp[..., 0] / pz], -1)
    prinv0, pvar = obs.test(pvu.reshape(-1, 2))
    prinv0, pvar = prinv0.reshape(-1, 6), pvar.reshape(-1, 6)
    occ = _occ(1.0 / pz, prinv0, pp[..., 2] * 30.0)
    dist = torch.linalg.norm(loc, dim=-1)
    c = _candidates(loc, glob, rot, occ, var0, pvar,
                    torch.clamp(dist, 1.0, 100.0), mp)
    c["insert_ok"] &= valid
    c["ambiguous"] &= valid
    u_lim = (-cam.cx / cam.fx, ((n - 1) * skip - cam.cx) / cam.fx)
    v_lim = (-cam.cy / cam.fy, ((m - 1) * skip - cam.cy) / cam.fy)
    c["frame"] = dict(obs=obs, tr=tr, rot=rot, u_lim=u_lim, v_lim=v_lim,
                      rmax=float(torch.max(torch.where(valid, z.reshape(-1), 0.0))))
    return c


# ---- the re-evaluation of the map's nodes ---------------------------------
def _near(x, at, tol):
    return torch.abs(x - at) <= tol


def _lattice(pos, cell_size):
    """Each node's cluster cell on the tree's lattice: (integer coords,
    center). The tree's root sits at the origin and halves down to the
    cluster cells, so they tile space in cell_size steps from 0."""
    k = np.floor(np.asarray(pos, np.float64) / cell_size)
    return k.astype(np.int64), (k + 0.5) * cell_size


def cull(pos, fr, mp, tree) -> tuple:
    """(kept, ambiguous) per node: whether its cluster cell passes the
    frame's range cull and field-of-view cull by the cell's corners
    (GPisMap.cpp:196-222, GPisMap3.cpp:276-301; in 3D the last corner in
    front of the camera decides, as the reference overwrites the test),
    and whether the range test is too close to call."""
    cs = 2.0 * tree["cluster_halfleng"]
    h = 0.5 * cs
    _, ctr = _lattice(pos, cs)
    tr = fr["tr"].cpu().numpy()
    rot = fr["rot"].cpu().numpy()
    lim2 = fr["rmax"] ** 2 + 2.0 * h * h
    sqr = np.sum((ctr - tr) ** 2, -1)
    keep = sqr <= lim2
    amb = np.abs(sqr - lim2) <= 1e-5 * lim2
    d = pos.shape[1]
    if d == 2:
        sg = np.array([[-1, 1], [1, 1], [-1, -1], [1, -1]], np.float64)
        loc = (ctr[:, None, :] + h * sg - tr) @ rot \
            - np.asarray(mp["sensor_offset"])
        ang = np.arctan2(loc[..., 1], loc[..., 0])
        lo, hi = mp["angle_obs_limit"]
        keep &= np.any((ang > lo) & (ang < hi), -1)
    else:
        sg = np.array([[-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1],
                       [-1, 1, -1], [1, 1, -1], [-1, -1, -1], [1, -1, -1]],
                      np.float64)
        loc = (ctr[:, None, :] + h * sg - tr) @ rot
        z = loc[..., 2]
        front = z > 0
        zs = np.where(front, z, 1.0)
        xv, yv = loc[..., 0] / zs, loc[..., 1] / zs
        (u0, u1), (v0, v1) = fr["u_lim"], fr["v_lim"]
        vis = (xv > u0) & (xv < u1) & (yv > v0) & (yv < v1)
        within = np.zeros(len(pos), bool)
        for c in range(8):
            within = np.where(front[:, c], vis[:, c], within)
        keep &= within
    return keep, amb


def _fuse(pos, grad, ps, gs, pos_new, grad_new, noise, gnoise, blend, mp):
    """The fusion of a re-evaluated node with its old estimate
    (GPisMap.cpp:391-421, GPisMap3.cpp:497-534): (pos, grad, noise,
    grad noise) as the node leaves the frame."""
    fuse = gs <= 0.5
    psum = ps + noise
    pos_f = (noise[:, None] * pos + ps[:, None] * pos_new) / psum[:, None]
    dist_f = 0.5 * torch.linalg.norm(pos - pos_f, dim=-1)
    grad_f = blend(grad, grad_new, noise / psum)
    mn = mp["map_noise_param"]
    gnoise_f = torch.clamp(gnoise * gs / (gs + gnoise) + dist_f, mn, 1.0)
    noise_f = torch.clamp(noise * ps / psum + dist_f, min=mn)
    return (torch.where(fuse[:, None], pos_f, pos_new),
            torch.where(fuse[:, None], grad_f, grad_new),
            torch.where(fuse, noise_f, noise),
            torch.where(fuse, gnoise_f, gnoise))


def _turn_2d(old, new, frac):
    """The old normal turned toward the new one by frac of the angle
    between them (GPisMap.cpp:398-407)."""
    ang = torch.atan2(old[:, 0] * new[:, 1] - old[:, 1] * new[:, 0],
                      torch.sum(old * new, -1)) * frac
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.stack([c * old[:, 0] - s * old[:, 1],
                        s * old[:, 0] + c * old[:, 1]], -1)


def _turn_3d(old, new, frac):
    """The reference's quaternion blend (GPisMap3.cpp:508-529): the
    rotation by frac of the angle between the normals about new x old,
    an axis it leaves un-normalized, as quat2dcm's matrix times the old
    normal."""
    ax = torch.linalg.cross(new, old, dim=-1)
    half = 0.5 * frac * torch.arccos(torch.clamp(torch.sum(new * old, -1),
                                                 -1.0, 1.0))
    q0 = torch.cos(half)
    q1, q2, q3 = (ax * torch.sin(half)[:, None]).unbind(-1)
    dcm = torch.stack([
        torch.stack([q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3,
                     2 * (q1 * q2 + q0 * q3), 2 * (q1 * q3 - q0 * q2)], -1),
        torch.stack([2 * (q1 * q2 - q0 * q3),
                     q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3,
                     2 * (q2 * q3 + q0 * q1)], -1),
        torch.stack([2 * (q1 * q3 + q0 * q2), 2 * (q2 * q3 - q0 * q1),
                     q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3], -1)], -2)
    return torch.einsum("kij,kj->ki", dcm, old)


def reeval(before: dict, cand: dict, mp: dict, tree: dict,
           strict: bool) -> dict:
    """What the frame does to each node of `before` (the map before it):
    action (0 keep, 1 double its noises, 2 remove, 3 move), the values a
    moved node leaves with, and `ambiguous` where a decision on the way
    is within float32 rounding of its threshold, or (strict: the
    reference's per-cell order, in which a node moved into a later cell
    in view is re-evaluated again) where a moved node lands in another
    cell in view."""
    fr = cand["frame"]
    obs, tr, rot = fr["obs"], fr["tr"], fr["rot"]
    dev = tr.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    pos, grad = t(before["pos"]), t(before["grad"])
    ps, gs = t(before["pos_sig"]), t(before["grad_sig"])
    keep_np, amb_np = cull(before["pos"], fr, mp, tree)
    keep, amb = t(keep_np) > 0, t(amb_np) > 0
    d = pos.shape[1]
    thre, delx = mp["obs_var_thre"], mp["delx"]
    mpn = mp["min_position_noise"]

    if d == 2:
        off = pos.new_tensor(mp["sensor_offset"])

        def obs_at(x):
            m, v = obs.test(torch.atan2(x[..., 1], x[..., 0]).reshape(-1))
            r = torch.linalg.norm(x, dim=-1)
            occ = _occ(1.0 / torch.sqrt(torch.clamp(r, min=1e-12)),
                       m.reshape(r.shape), r * 30.0)
            return m.reshape(r.shape), v.reshape(r.shape), occ, r

        loc = (pos - tr) @ rot - off
        _, var, oc, r = obs_at(loc)
        gate = keep & (var <= thre)
        active = gate & (oc >= -0.1)
        amb |= keep & (_near(var, thre, TOL_VAR)
                       | (gate & _near(oc, -0.1, TOL_OCC)))
        gl = grad @ rot
        x, dx, abs_oc, r_new = loc, torch.full_like(r, delx), oc.abs(), r
        cont = active & (abs_oc > OCC_STOP)
        amb |= active & _near(abs_oc, OCC_STOP, TOL_OCC)
        for _ in range(RELOC_ITERS):       # GPisMap.cpp:273-315
            x = torch.where(cont[:, None], x + torch.where(
                oc < 0, 1.0, -1.0)[:, None] * gl * dx[:, None], x)
            _, var_n, oc_n, r_t = obs_at(x)
            r_new = torch.where(cont, r_t, r_new)
            upd = cont & (var_n <= thre) & (oc_n.abs() >= OCC_STOP) \
                & (oc >= -0.1)
            amb |= cont & (_near(var_n, thre, TOL_VAR)
                           | _near(oc_n.abs(), OCC_STOP, TOL_OCC)
                           | (oc_n.abs() <= TOL_OCC)
                           | _near(oc, -0.1, TOL_OCC))
            dx = torch.where(upd, torch.where(oc * oc_n < 0, 0.5, 1.1) * dx,
                             dx)
            oc = torch.where(upd, oc_n, oc)
            abs_oc = torch.where(upd, oc_n.abs(), abs_oc)
            cont = upd & (oc_n.abs() > OCC_STOP)
        pert = pos.new_tensor([(1., 0.), (-1., 0.), (0., 1.), (0., -1.)])
        pm, pvar, pocc, _ = obs_at(x[:, None, :] + pert[None] * delx)
        r0 = 1.0 / torch.clamp(pm * pm, min=1e-12)
        noise = mpn * torch.clamp(r_new * r_new, 1.0, 100.0)
        to_world = lambda v: (v + off) @ rot.T + tr
        blend = _turn_2d
    else:
        def obs_at(x):
            z = torch.where(x[..., 2].abs() > 1e-12, x[..., 2], 1e-12)
            vu = torch.stack([x[..., 1] / z, x[..., 0] / z], -1)
            m, v = obs.test(vu.reshape(-1, 2))
            m, v = m.reshape(z.shape), v.reshape(z.shape)
            return m, v, _occ(1.0 / z, m, x[..., 2] * 30.0), z

        loc = (pos - tr) @ rot
        _, var, oc, _ = obs_at(loc)
        gate = keep & (loc[:, 2] > 0) & (var <= thre)
        active = gate & (oc >= -0.02)
        amb |= keep & (loc[:, 2] > 0) & (
            _near(var, thre, TOL_VAR) | (gate & _near(oc, -0.02, TOL_OCC)))
        # the reference's loop reads the unmoved ray each step
        # (GPisMap3.cpp:374-410): ten steps of delx growing by 1.1
        move = oc.abs() > OCC_STOP
        amb |= active & _near(oc.abs(), OCC_STOP, TOL_OCC)
        steps = sum(1.1 ** i for i in range(RELOC_ITERS))
        x = loc + torch.where(move, torch.where(oc < 0, 1.0, -1.0) * delx
                              * steps, 0.0)[:, None] * (grad @ rot)
        abs_oc = oc.abs()
        pert = pos.new_tensor([(1., 0., 0.), (-1., 0., 0.), (0., 1., 0.),
                               (0., -1., 0.), (0., 0., 1.), (0., 0., -1.)])
        pm, pvar, pocc, _ = obs_at(x[:, None, :] + pert[None] * delx)
        r0 = 1.0 / torch.where(pm.abs() > 1e-12, pm, 1e-12)
        # the reference's noise reads the last probe's depth
        # (GPisMap3.cpp:429)
        rp = x[:, 2] - delx
        noise = mpn * torch.clamp(rp * rp, 1.0, 100.0)
        to_world = lambda v: v @ rot.T + tr
        blend = _turn_3d

    # the probes' normal and noise (GPisMap.cpp:317-380,
    # GPisMap3.cpp:413-480)
    n_p = pert.shape[0]
    probe_ok = torch.all(pvar <= thre, -1)
    amb |= active & torch.any(_near(pvar, thre, TOL_VAR), -1)
    g = torch.stack([pocc[:, 2 * i] - pocc[:, 2 * i + 1] for i in range(d)],
                    -1) / delx
    norm_g = torch.linalg.norm(g, dim=-1)
    act2 = active & probe_ok
    amb |= act2 & _near(norm_g, 1e-3, 1e-5)
    r_var = (torch.sum(r0 * r0, -1) / (n_p - 1)
             - torch.mean(r0, -1) ** 2 * n_p / (n_p - 1)) / delx
    gn = g / torch.clamp(norm_g, min=1e-12)[:, None]
    gnoise = torch.clamp(torch.abs(torch.mean(pocc, -1)) + r_var,
                         mp["min_grad_noise"], 1.0)
    cos = torch.clamp(-torch.sum(x * gn, -1) / torch.clamp(
        torch.linalg.norm(x, dim=-1), min=1e-12), min=0.1)
    view_noise = mpn * (1.0 - cos ** 2) / cos ** 2
    noise = noise + view_noise + abs_oc
    gnoise = gnoise + 0.1 * view_noise
    p_out, g_out, n_out, gn_out = _fuse(pos, grad, ps, gs, to_world(x),
                                        gn @ rot.T, noise, gnoise, blend, mp)
    act3 = act2 & (norm_g >= 1e-3)
    discard = (n_out > 1.0) & (gn_out > 0.61)     # GPisMap.cpp:425
    amb |= act3 & (_near(n_out, 1.0, TOL_NOISE)
                   | _near(gn_out, 0.61, TOL_NOISE))
    action = torch.where(act2 & (norm_g < 1e-3), 1, torch.where(
        act3 & discard, 2, torch.where(act3, 3, 0)))
    if strict:
        cs = 2.0 * tree["cluster_halfleng"]
        k_old, _ = _lattice(before["pos"], cs)
        k_new, _ = _lattice(p_out.cpu().numpy(), cs)
        kept = set(map(tuple, k_old[keep_np]))
        crossed = np.any(k_new != k_old, -1) & np.array(
            [tuple(k) in kept for k in k_new], bool)
        amb |= (action == 3) & (t(crossed) > 0)
    return dict(action=action, pos=p_out, grad=g_out, noise=n_out,
                grad_noise=gn_out, ambiguous=amb, kept=keep)


def compare_frame(before: dict, after: dict, cand: dict, ref: dict,
                  chk: dict, tree: dict, device) -> dict:
    """The map after a frame against the reference's account of it.

    Re-evaluated nodes: each node whose action the reference decides
    without doubt has to show it: kept, its row unchanged; noises
    doubled; removed; or moved, its old row gone and a node within
    chk["reeval_radius_m"] of the fused position whose normal and
    noises lie within chk["reeval_grad"] (absolute) and
    chk["reeval_noise"] (relative) of the fused ones, unless a node of
    the map lies within the tree's min_halfleng of that position, where
    the tree refuses the move as a duplicate. `reeval_wrong` is the share
    of them that do not (a node kept where the reference acts, or acted
    on where it keeps, is wrong).

    New nodes (a position the map did not hold): each is a candidate's
    (within chk["match_radius_m"]) or a moved node's; `new_unmatched` is
    the share that is neither. A candidate's node has to carry its normal
    and noises: the median gaps (`new_grad`, absolute; `new_noise`,
    relative), the gaps of the nodes viewed at a cosine of at least
    VIEW_MIN (`square`: the rows of `after` and their gaps, which the
    check pools over its frames for the 95th percentiles; a normal from
    the probes' finite differences amplifies the float32 rounding of the
    observation GP, and the view term amplifies it again at grazing
    views, so the largest gap, `_max`, swings from seed to seed, and a
    frame's own percentile, `_p95_frame`, is the largest of a few), and
    the share whose candidate the reference would not insert
    (`new_spurious`)."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    full = lambda nd, ps, gs: _rows(np.concatenate(
        [nd["pos"], nd["grad"], ps[:, None], gs[:, None]], -1))
    a_rows = full(after, after["pos_sig"], after["grad_sig"])
    same = np.isin(full(before, before["pos_sig"], before["grad_sig"]),
                   a_rows)
    dbl = np.isin(full(before, 2 * before["pos_sig"],
                       2 * before["grad_sig"]), a_rows)
    act = ref["action"].cpu().numpy()
    sure = ~ref["ambiguous"].cpu().numpy()
    pa = t(after["pos"])
    wrong = np.zeros(len(act), bool)
    wrong[act == 0] = ~same[act == 0]
    wrong[act == 1] = ~dbl[act == 1]
    wrong[act >= 2] = same[act >= 2] | dbl[act >= 2]
    moved = np.nonzero((act == 3) & sure & ~wrong)[0]
    excused = 0
    if len(moved):
        mv = torch.as_tensor(moved, device=device)
        dist, j = _nearest(ref["pos"][mv], pa)
        hit = (dist <= chk["reeval_radius_m"]).cpu().numpy()
        ggap = (t(after["grad"])[j] - ref["grad"][mv]).abs().amax(-1)
        rel = lambda a, b: (a - b).abs() / b.abs()
        ngap = torch.maximum(rel(t(after["pos_sig"])[j], ref["noise"][mv]),
                             rel(t(after["grad_sig"])[j],
                                 ref["grad_noise"][mv]))
        off = ((ggap > chk["reeval_grad"])
               | (ngap > chk["reeval_noise"])).cpu().numpy()
        dup = (dist < tree["min_halfleng"]).cpu().numpy() & ~hit
        excused = int(dup.sum())
        wrong[moved] = (hit & off) | (~hit & ~dup)
    judged = sure & ((act != 0) | wrong)
    out = dict(reeval_wrong=float(wrong[judged].sum())
               / max(int(judged.sum()), 1),
               reeval_judged=int(judged.sum()),
               reeval_excused=excused / max(len(moved), 1),
               reeval_ambiguous=float(np.mean(~sure[act != 0]))
               if np.any(act != 0) else 0.0)

    newrow = ~np.isin(_rows(after["pos"]), _rows(before["pos"]))
    new = torch.as_tensor(np.nonzero(newrow)[0], device=device)
    dist, j = _nearest(pa[new], cand["pos"])
    is_cand = dist <= chk["match_radius_m"]
    mv = ref["action"] == 3
    dmv, _ = _nearest(pa[new], ref["pos"][mv])
    is_moved = dmv <= chk["reeval_radius_m"]
    out["new_unmatched"] = float((~is_cand & ~is_moved).double().mean()) \
        if len(new) else 0.0
    new, j = new[is_cand], j[is_cand]
    out["new_nodes"] = int(len(new))
    if len(new) == 0:
        out.update(new_grad=0.0, new_noise=0.0, new_grad_p95_frame=0.0,
                   new_noise_p95_frame=0.0, new_spurious=0.0,
                   new_grad_max=0.0, new_noise_max=0.0,
                   square=dict(rows=np.zeros(0, np.int64),
                               grad=np.zeros(0), noise=np.zeros(0)))
        return out
    sure = ~cand["ambiguous"][j]
    g = (t(after["grad"])[new] - cand["grad"][j]).abs().amax(-1)
    rel = lambda a, b: (a - b).abs() / b.abs()
    nz = torch.maximum(rel(t(after["pos_sig"])[new], cand["noise"][j]),
                       rel(t(after["grad_sig"])[new], cand["grad_noise"][j]))
    spur = (~cand["insert_ok"][j]) & sure
    square = (cand["view"][j] >= VIEW_MIN)[sure]
    g, nz = g[sure], nz[sure]
    stat = lambda x, f: float(f(x)) if len(x) else 0.0
    p95 = lambda x: torch.quantile(x, 0.95)
    out.update(new_grad=stat(g, torch.median),
               new_noise=stat(nz, torch.median),
               new_grad_p95_frame=stat(g[square], p95),
               new_noise_p95_frame=stat(nz[square], p95),
               new_grad_max=stat(g, torch.max),
               new_noise_max=stat(nz, torch.max),
               new_spurious=float(spur.double().mean()),
               square=dict(rows=new[sure][square].cpu().numpy(),
                           grad=g[square].cpu().numpy(),
                           noise=nz[square].cpu().numpy()))
    return out


def _rows(a):
    """Each row of a float32 array as one opaque item (exact matching)."""
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1]))).ravel()


def _nearest(p, q):
    """(distance, index) of the nearest q to each p."""
    if len(q) == 0 or len(p) == 0:
        return (torch.full((len(p),), math.inf, dtype=F64, device=p.device),
                torch.zeros(len(p), dtype=torch.long, device=p.device))
    ds, js = [], []
    for s in range(0, len(p), 1024):
        d = torch.cdist(p[s:s + 1024], q,
                        compute_mode="donot_use_mm_for_euclid_dist")
        dv, jv = d.min(1)
        ds.append(dv)
        js.append(jv)
    return torch.cat(ds), torch.cat(js)
