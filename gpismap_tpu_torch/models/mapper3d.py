"""3D online mapper — the per-frame device computations.

Port of gpismap_tpu/models/mapper3d.py (the default path): the reference
GPisMap3 pipeline (GPisMap3.cpp:125-716) as batched tensor stages —
depth-image preprocessing with camera intrinsics, re-evaluation of
existing nodes against the ObsGP2D inverse-depth regression, 6-probe
normals, quaternion normal fusion, and per-pixel new-measurement
evaluation.

Reference quirks kept (see the JAX module's docstring):
  * compat re-localization: the reference recomputes vu from UNCHANGED
    y_loc/z_loc inside the refinement loop (GPisMap3.cpp:390-392), so the
    loop degenerates to 10 fixed-sign steps of geometrically growing size;
    compat=True (the default) is that closed form, compat=False the
    corrected loop that re-projects x_new each step.
  * the normal-fusion quaternion is built from an UN-normalized axis
    (GPisMap3.cpp:509-529), with an acos clamp against NaN.

The probe sweep of newmeas_3d has three forms with the same results:
the dense gather over every pixel, the compacted gather over the
range-gated pixels (nv_cap), and the cell-blocked products
(_blocked_obs_sweep). Not ported: the "fused" scan (reeval_scan_3d,
which "hybrid" replaced) and the one-vector result packing for the TPU
host link (pack_frame_results).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CameraParam, MapperParam, ObsGPParam
from . import obsgp
from .mapper2d import occ_test

_RELOC_ITERS = 10
_OCC_STOP = 0.02
# sum of 10 steps with dx *= 1.1 growth (GPisMap3.cpp:374-410 compat path)
_COMPAT_STEP_SUM = sum(1.1 ** i for i in range(_RELOC_ITERS))
_PROBES = ((1., 0., 0.), (-1., 0., 0.), (0., 1., 0.), (0., -1., 0.),
           (0., 0., 1.), (0., 0., -1.))
# bound on the [K, C, 3] cell comparison of reeval_hybrid_3d's cell_ord
_ORD_ELEMS = 1 << 22


class Preproc3D(NamedTuple):
    valid: torch.Tensor       # [M, N] range-gated pixels (row-major m x n)
    zinv: torch.Tensor        # [M, N] inverse depth (-1 invalid)
    v: torch.Tensor           # [M] row ray coords (row - cy)/fy
    u: torch.Tensor           # [N] col ray coords (col - cx)/fx
    xyz_local: torch.Tensor   # [M, N, 3]
    xyz_global: torch.Tensor  # [M, N, 3]
    z: torch.Tensor           # [M, N] depth
    range_obs_max: torch.Tensor


def preprocess_3d(depth: torch.Tensor, tr: torch.Tensor, rot: torch.Tensor,
                  cam: CameraParam, mp: MapperParam) -> Preproc3D:
    """Depth subsample + back-projection (GPisMap3.cpp:125-216).

    depth: [H, W] meters; rot: [3, 3] world-from-camera; tr: [3].
    """
    skip = mp.obs_skip
    m = cam.height // skip
    n = cam.width // skip
    rows = torch.arange(m, device=depth.device) * skip
    cols = torch.arange(n, device=depth.device) * skip
    z = depth[rows][:, cols]                           # [M, N]
    valid = (z > mp.min_range) & (z < mp.max_range)
    zinv = torch.where(valid, 1.0 / torch.clamp(z, min=1e-12), -1.0)
    # times the reciprocal: the rounding of the JAX package, whose
    # compiler rewrites the division by a constant so
    v = (rows.to(depth.dtype) - cam.cy) * (1.0 / cam.fy)
    u = (cols.to(depth.dtype) - cam.cx) * (1.0 / cam.fx)
    x_l = u[None, :] * z
    y_l = v[:, None] * z
    loc = torch.stack([x_l, y_l, z], -1)
    glob = loc @ rot.T + tr
    rmax = torch.max(torch.where(valid, z, 0.0))
    return Preproc3D(valid=valid, zinv=zinv, v=v, u=u, xyz_local=loc,
                     xyz_global=glob, z=z, range_obs_max=rmax)


class Reeval3D(NamedTuple):
    """Per-node outcome. action: 0 keep, 1 double-noise, 2 remove,
    3 remove+reinsert."""

    action: torch.Tensor
    pos: torch.Tensor
    grad: torch.Tensor
    noise: torch.Tensor
    grad_noise: torch.Tensor
    dbl_pos_sig: torch.Tensor
    dbl_grad_sig: torch.Tensor


def _quat_blend(grad_old, grad_new, frac):
    """Reference normal fusion (GPisMap3.cpp:508-529): rotate the OLD
    normal by frac*angle(new, old) about the un-normalized axis
    new x old, through the aerospace DCM applied transposed."""
    axis = torch.linalg.cross(grad_new, grad_old, dim=-1)
    dot = torch.clamp(torch.sum(grad_new * grad_old, -1), -1.0, 1.0)
    ang = torch.arccos(dot) * frac
    q0 = torch.cos(ang / 2.0)
    s = torch.sin(ang / 2.0)
    q1, q2, q3 = axis[..., 0] * s, axis[..., 1] * s, axis[..., 2] * s
    # dcm column-major of R (quat2dcm, GPisMap3.cpp:48-63); applied as
    # grad = R^T @ grad_old (GPisMap3.cpp:527-529)
    r00 = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3
    r10 = 2.0 * (q1 * q2 + q0 * q3)
    r20 = 2.0 * (q1 * q3 - q0 * q2)
    r01 = 2.0 * (q1 * q2 - q0 * q3)
    r11 = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3
    r21 = 2.0 * (q0 * q1 + q2 * q3)
    r02 = 2.0 * (q1 * q3 + q0 * q2)
    r12 = 2.0 * (q2 * q3 - q0 * q1)
    r22 = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3
    gx, gy, gz = grad_old[..., 0], grad_old[..., 1], grad_old[..., 2]
    return torch.stack([r00 * gx + r10 * gy + r20 * gz,
                        r01 * gx + r11 * gy + r21 * gz,
                        r02 * gx + r12 * gy + r22 * gz], -1)


def _safe_z(z):
    return torch.where(torch.abs(z) > 1e-12, z, 1e-12)


def reeval_3d(obs: obsgp.ObsGP2DState, pos: torch.Tensor,
              grad: torch.Tensor, pos_sig: torch.Tensor,
              grad_sig: torch.Tensor, valid: torch.Tensor, tr: torch.Tensor,
              rot: torch.Tensor, mp: MapperParam, op: ObsGPParam,
              chunk: int = 1024, compat: bool = True) -> Reeval3D:
    """Batched reEvalPoints (GPisMap3.cpp:321-569) of one node batch."""
    k = pos.shape[0]

    def obs_at(x):
        """ObsGP2D posterior at camera-frame points x [..., 3]."""
        z = _safe_z(x[..., 2])
        vu = torch.stack([x[..., 1] / z, x[..., 0] / z], -1)
        mean, var = obsgp.obsgp2d_test(obs, vu.reshape(-1, 2), op, chunk)
        return mean.reshape(z.shape), var.reshape(z.shape), z

    loc = (pos - tr) @ rot                             # R^T (p - t)
    z_l = loc[:, 2]
    front = z_l > 0.0                                  # GPisMap3.cpp:342
    rinv0, var, zs = obs_at(loc)
    gate = valid & front & (var <= mp.obs_var_thre)
    oc0 = occ_test(1.0 / zs, rinv0, z_l * 30.0)
    active = gate & (oc0 >= -0.02)                     # GPisMap3.cpp:355-359
    grad_loc = grad @ rot

    if compat:
        # closed form of the degenerate loop (see the module docstring)
        move = torch.abs(oc0) > _OCC_STOP
        sgn = torch.where(oc0 < 0, 1.0, -1.0)
        disp = sgn * mp.delx * _COMPAT_STEP_SUM
        x_new = loc + torch.where(move[:, None], grad_loc * disp[:, None],
                                  0.0)
        abs_oc = torch.abs(oc0)
    else:
        x_new = loc
        dx = torch.full((k,), mp.delx, dtype=pos.dtype, device=pos.device)
        oc = oc0
        abs_oc = torch.abs(oc0)
        cont = active & (abs_oc > _OCC_STOP)
        for _ in range(_RELOC_ITERS):
            step = torch.where(oc[:, None] < 0, 1.0, -1.0) * grad_loc \
                * dx[:, None]
            x_new = torch.where(cont[:, None], x_new + step, x_new)
            rinv0_n, var_n, _ = obs_at(x_new)
            r_t = x_new[:, 2]
            brk_var = var_n > mp.obs_var_thre
            oc_n = occ_test(1.0 / torch.clamp(r_t, min=1e-12), rinv0_n,
                            r_t * 30.0)
            brk_oc = (torch.abs(oc_n) < _OCC_STOP) | (oc < -0.02)
            upd = cont & ~brk_var & ~brk_oc
            flip = oc * oc_n < 0.0
            dx = torch.where(upd, torch.where(flip, 0.5 * dx, 1.1 * dx), dx)
            oc = torch.where(upd, oc_n, oc)
            abs_oc = torch.where(upd, torch.abs(oc_n), abs_oc)
            cont = upd & (torch.abs(oc_n) > _OCC_STOP)

    # --- 6-probe normal + noise (GPisMap3.cpp:413-480) ---
    w = 1.0 / 6.0
    pert = pos.new_tensor(_PROBES) * mp.delx
    ppos = x_new[:, None, :] + pert[None]              # [K, 6, 3]
    prinv0, pvar, pz = obs_at(ppos)
    probe_ok = torch.all(pvar <= mp.obs_var_thre, -1)
    pocc = occ_test(1.0 / pz, prinv0, ppos[..., 2] * 30.0)
    occ_mean = w * torch.sum(pocc, -1)
    r0 = 1.0 / torch.where(torch.abs(prinv0) > 1e-12, prinv0, 1e-12)
    r0_sqr_sum = torch.sum(r0 * r0, -1)
    r0_mean = w * torch.sum(r0, -1)

    act2 = active & probe_ok
    gnl = torch.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3],
                       pocc[:, 4] - pocc[:, 5]], -1) / mp.delx
    norm_g = torch.sqrt(torch.sum(gnl * gnl, -1))
    dbl = act2 & (norm_g < 1e-3)
    act3 = act2 & (norm_g >= 1e-3)

    r_var = (r0_sqr_sum / 5.0 - r0_mean * r0_mean * 6.0 / 5.0) / mp.delx
    gnl_n = gnl / torch.clamp(norm_g, min=1e-12)[:, None]
    # reference quirk: the probe loop overwrites r_new with each probe's z
    # (GPisMap3.cpp:429), so the noise model sees the LAST probe's depth
    # x_new_z - delx, not the relocated depth
    r_probe = x_new[:, 2] - mp.delx
    noise = mp.min_position_noise * torch.clamp(r_probe * r_probe, 1.0,
                                                100.0)
    grad_noise = torch.clamp(torch.abs(occ_mean) + r_var, mp.min_grad_noise,
                             1.0)
    dist = torch.sqrt(torch.sum(x_new * x_new, -1))
    view_ang = torch.clamp(
        -torch.sum(x_new * gnl_n, -1) / torch.clamp(dist, min=1e-12),
        min=0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise = noise + view_noise + abs_oc
    grad_noise = grad_noise + 0.1 * view_noise

    pos_new = x_new @ rot.T + tr
    grad_new = gnl_n @ rot.T

    # --- fusion (GPisMap3.cpp:497-534) ---
    fuse = grad_sig <= 0.5
    psum = pos_sig + noise
    pos_f = (noise[:, None] * pos + pos_sig[:, None] * pos_new) / psum[:, None]
    dist_f = 0.5 * torch.sqrt(torch.sum((pos - pos_f) ** 2, -1))
    grad_f = _quat_blend(grad, grad_new, noise / psum)
    gsum = grad_sig + grad_noise
    gnoise_f = torch.clamp(
        torch.clamp(grad_noise * grad_sig / gsum + dist_f,
                    min=mp.map_noise_param), max=1.0)
    noise_f = torch.clamp(noise * pos_sig / psum + dist_f,
                          min=mp.map_noise_param)

    pos_out = torch.where(fuse[:, None], pos_f, pos_new)
    grad_out = torch.where(fuse[:, None], grad_f, grad_new)
    noise_out = torch.where(fuse, noise_f, noise)
    gnoise_out = torch.where(fuse, gnoise_f, grad_noise)

    discard = (noise_out > 1.0) & (gnoise_out > 0.61)
    action = torch.where(dbl, 1, torch.where(act3 & discard, 2,
                                             torch.where(act3, 3, 0)))
    return Reeval3D(action=action.to(torch.int32), pos=pos_out,
                    grad=grad_out, noise=noise_out, grad_noise=gnoise_out,
                    dbl_pos_sig=2.0 * pos_sig, dbl_grad_sig=2.0 * grad_sig)


def _apply_actions(rv: Reeval3D, got, p, g, ps, gs):
    """Node state after one processing: (action [K] with 0 where not
    processed, position, normal, position noise, gradient noise)."""
    a = torch.where(got, rv.action, 0)
    relocated = (a == 3)[:, None]
    return (a, torch.where(relocated, rv.pos, p),
            torch.where(relocated, rv.grad, g),
            torch.where(a == 1, rv.dbl_pos_sig,
                        torch.where(a == 3, rv.noise, ps)),
            torch.where(a == 1, rv.dbl_grad_sig,
                        torch.where(a == 3, rv.grad_noise, gs)))


def reeval_hybrid_3d(obs: obsgp.ObsGP2DState, pos: torch.Tensor,
                     grad: torch.Tensor, pos_sig: torch.Tensor,
                     grad_sig: torch.Tensor, valid: torch.Tensor,
                     cell_coords: torch.Tensor, cell_ok: torch.Tensor,
                     tr: torch.Tensor, rot: torch.Tensor, cell_size,
                     mp: MapperParam, op: ObsGPParam, chunk: int = 4096,
                     compat: bool = True, max_movers: int = 128,
                     rounds: int = 4):
    """Strict per-cell re-evaluation (the per-cell sequential order of
    reEvalPoints, GPisMap3.cpp:321-569) as one vectorized pass plus a
    mover fix-up (gpismap_tpu/models/mapper3d.py:335-456).

    In the sequential order every node's FIRST processing reads
    frame-start state (a node lives in one cell, and earlier cells cannot
    have touched it), so pass 1 re-evaluates all kept-cell nodes at once.
    Second processings happen only for nodes relocated across a cell
    boundary into a LATER kept cell; those re-process from their updated
    state in fix-up rounds, at most `max_movers` a round and `rounds`
    rounds (the JAX package's lax.while_loop, here a Python loop);
    leftovers and mover overflow are counted in n_dropped.

    pos/grad [K, 3], pos_sig/grad_sig/valid [K]; cell_coords [C, 3] int32
    integer cell coords of the kept cells in processing order, cell_ok [C]
    marking real ones. Returns (Reeval3D with the FINAL per-node composite
    actions and values, n_dropped): removed anywhere -> 2; relocated -> 3
    with the final values; noise doubled only -> 1; untouched -> 0.
    """
    k = pos.shape[0]
    c = cell_coords.shape[0]
    cols = torch.arange(c, device=pos.device)

    def cell_ord(p, alv):
        """Processing-order index of each node's current cell (c = not a
        kept cell): the first kept cell with the node's integer coords."""
        kcell = torch.floor(p / cell_size).to(torch.int32)
        out = []
        step = max(1, _ORD_ELEMS // max(c, 1))
        for s in range(0, p.shape[0], step):
            eq = (torch.all(kcell[s:s + step, None, :] == cell_coords[None],
                            -1) & cell_ok[None])
            out.append(torch.min(torch.where(eq, cols, c), -1).values)
        o = torch.cat(out) if out else cols.new_zeros(0)
        return torch.where(alv, o, c)

    ord0 = cell_ord(pos, valid)
    member0 = ord0 < c

    # ---- pass 1: every node's first processing, one batch ----
    rv = reeval_3d(obs, pos, grad, pos_sig, grad_sig, member0, tr, rot, mp,
                   op, chunk, compat)
    a, p, g, ps, gs = _apply_actions(rv, member0, pos, grad, pos_sig,
                                     grad_sig)
    alv = valid & (a != 2)
    moved = a == 3
    dbl = a == 1
    ord1 = cell_ord(p, alv)
    pending = moved & alv & (ord1 < c) & (ord1 > ord0)
    drop = 0

    # ---- fix-up rounds: re-process forward-movers from updated state ----
    for _ in range(rounds):
        idx = torch.nonzero(pending).reshape(-1)
        if len(idx) == 0:
            break
        drop += max(len(idx) - max_movers, 0)
        idx = idx[:max_movers]
        my_ord = cell_ord(p[idx], alv[idx])          # cell processed now
        got = torch.ones_like(idx, dtype=torch.bool)
        rv = reeval_3d(obs, p[idx], g[idx], ps[idx], gs[idx], got, tr, rot,
                       mp, op, chunk, compat)
        a, new_p, new_g, new_ps, new_gs = _apply_actions(
            rv, got, p[idx], g[idx], ps[idx], gs[idx])
        new_alv = alv[idx] & (a != 2)
        # moved again across a boundary into a cell later than the one
        # just processed -> pending again (a chain)
        crossed = torch.any(torch.floor(p[idx] / cell_size).to(torch.int32)
                            != torch.floor(new_p / cell_size).to(torch.int32),
                            -1)
        tgt_ord = cell_ord(new_p, new_alv)
        again = ((a == 3) & new_alv & crossed & (tgt_ord < c)
                 & (tgt_ord > my_ord))
        # the state tensors are this function's own: updated in place
        p[idx], g[idx], ps[idx], gs[idx] = new_p, new_g, new_ps, new_gs
        moved[idx] = moved[idx] | (a == 3)
        dbl[idx] = dbl[idx] | (a == 1)
        alv[idx] = new_alv
        pending[idx] = again
    drop += int(torch.sum(pending))                  # undrained chain
    removed = valid & ~alv
    action = torch.where(removed, 2,
                         torch.where(moved, 3, torch.where(dbl, 1, 0)))
    return Reeval3D(action=action.to(torch.int32), pos=p, grad=g, noise=ps,
                    grad_noise=gs, dbl_pos_sig=ps, dbl_grad_sig=gs), drop


class NewMeas3D(NamedTuple):
    insert_ok: torch.Tensor   # [P] flattened column-major over (n, m)
    pos: torch.Tensor         # [P, 3]
    grad: torch.Tensor        # [P, 3]
    noise: torch.Tensor       # [P]
    grad_noise: torch.Tensor  # [P]


def _grid_ownership(cam: CameraParam, mp: MapperParam, op: ObsGPParam):
    """Static pixel -> cell ownership tables of the (v, u) ray grid: the
    obs partition's boundaries are camera geometry (GPisMap3.cpp:144-173,
    ObsGP.cpp:204-265), so each pixel's owning cell is known before any
    frame. Returns (row_idx [nG0, W0], col_idx [nG1, W1]), -1 padded."""
    skip = mp.obs_skip
    m = cam.height // skip
    n = cam.width // skip
    v_np = ((np.arange(m) * skip).astype(np.float32)
            - np.float32(cam.cy)) / np.float32(cam.fy)
    u_np = ((np.arange(n) * skip).astype(np.float32)
            - np.float32(cam.cx)) / np.float32(cam.fx)
    _, _, _, bnd_i = obsgp.partition_1axis(m, op.group_size, op.overlap)
    _, _, _, bnd_j = obsgp.partition_1axis(n, op.group_size, op.overlap)
    row_idx = obsgp.ownership_1axis(v_np, v_np[np.asarray(bnd_i)])
    col_idx = obsgp.ownership_1axis(u_np, u_np[np.asarray(bnd_j)])
    return row_idx, col_idx


def _blocked_obs_sweep(obs: obsgp.ObsGP2DState, vu0: torch.Tensor,
                       pvu: torch.Tensor, cam: CameraParam,
                       mp: MapperParam, op: ObsGPParam):
    """The gate and probe posteriors through the cell-blocked evaluator:
    the [M, N] pixel grid grouped by static owning cell. A gate query
    lies in its pixel's cell (roff=0); a probe moves vu by at most about
    delx/min_range (1 + |vu|), well under one cell span at the
    production geometry, so roff=1 covers every valid pixel's probes.
    Returns (var0 [M, N], prinv0 [M, N, 6], pvar [M, N, 6])."""
    m, n = vu0.shape[:2]
    dev = vu0.device
    row_idx, col_idx = _grid_ownership(cam, mp, op)
    ng0, w0 = row_idx.shape
    ng1, w1 = col_idx.shape
    rc = torch.as_tensor(np.clip(row_idx, 0, m - 1), device=dev).long()
    cc = torch.as_tensor(np.clip(col_idx, 0, n - 1), device=dev).long()

    def group(arr):
        """[M, N, ...] -> [nG0, nG1, W0*W1, ...] by ownership."""
        g = arr[rc][:, :, cc]               # [g0, W0, g1, W1, ...]
        return g.transpose(1, 2).reshape((ng0, ng1, w0 * w1)
                                         + arr.shape[2:])

    # scatter-back pixel ids; the padding goes to a dummy trailing row
    own = (row_idx >= 0)[:, None, :, None] & (col_idx >= 0)[None, :, None, :]
    pid_np = np.where(own, np.clip(row_idx, 0, m - 1)[:, None, :, None] * n
                      + np.clip(col_idx, 0, n - 1)[None, :, None, :], m * n)
    pid = torch.as_tensor(pid_np.reshape(-1), device=dev).long()

    def scatter(vals, fill):
        """[g0, g1, T, ...] -> [M*N, ...] by pixel id."""
        rest = vals.shape[3:]
        out = vals.new_full((m * n + 1,) + rest, fill)
        out[pid] = vals.reshape((-1,) + rest)
        return out[:-1]

    _, varg = obsgp.obsgp2d_test_blocked(obs, group(vu0), op, roff=0)
    var0 = scatter(varg, obsgp._PAD_INVALID).reshape(m, n)
    qp = group(pvu).reshape(ng0, ng1, w0 * w1 * 6, 2)   # 6 probes a pixel
    mnp, varp = obsgp.obsgp2d_test_blocked(obs, qp, op, roff=1)
    prinv0 = scatter(mnp.reshape(ng0, ng1, w0 * w1, 6), 0.0)
    pvar = scatter(varp.reshape(ng0, ng1, w0 * w1, 6), obsgp._PAD_INVALID)
    return var0, prinv0.reshape(m, n, 6), pvar.reshape(m, n, 6)


def probe_queries(prep: Preproc3D, mp: MapperParam):
    """The obs-GP queries of every pixel: (vu0 [M, N, 2] the pixel's own
    ray coords, ppos [M, N, 6, 3] its 6 probes (+-delx along each camera
    axis), pz [M, N, 6] their safe depths, pvu [M, N, 6, 2] their ray
    coords)."""
    m, n = prep.valid.shape
    vu0 = torch.stack([prep.v[:, None].expand(m, n),
                       prep.u[None, :].expand(m, n)], -1)
    pert = prep.z.new_tensor(_PROBES) * mp.delx
    ppos = prep.xyz_local[:, :, None, :] + pert[None, None]   # [M,N,6,3]
    pz = _safe_z(ppos[..., 2])
    pvu = torch.stack([ppos[..., 1] / pz, ppos[..., 0] / pz], -1)
    return vu0, ppos, pz, pvu


def newmeas_3d(obs: obsgp.ObsGP2DState, prep: Preproc3D, rot: torch.Tensor,
               mp: MapperParam, op: ObsGPParam, chunk: int = 4096,
               cam: CameraParam = None, blocked: bool = False,
               nv_cap: int = None) -> NewMeas3D:
    """Batched evalPoints (GPisMap3.cpp:580-696): the gate and 6 probe
    posteriors of every pixel. Outputs are flattened in the reference's
    pixel iteration order (column-major: outer col, inner row;
    GPisMap3.cpp:586-589) so the host insertion replay keeps its dedup
    order.

    The posteriors come from one of three sweeps, with the same results:
      * nv_cap (wins over blocked): the range-gated pixels first, by a
        stable sort, and the gather evaluator on the [nv_cap, 7] gate and
        probe queries of the first nv_cap pixels only; the others get the
        1e6 sentinel, which insert_ok's range gate implies anyway.
        Callers pass the pow2 bucket of the host-known valid count
        (api3d._obs_nv_cap); a bucket above the pixel count is clamped
        to it, so every pixel is then evaluated.
      * blocked=True (needs cam): the cell-blocked evaluator
        (_blocked_obs_sweep), equal to the gather up to the products'
        summation order.
      * otherwise the gather evaluator over every pixel.
    """
    m, n = prep.valid.shape
    w = 1.0 / 6.0
    vu0, ppos, pz, pvu = probe_queries(prep, mp)

    if nv_cap is not None:
        mn_ = m * n
        nv_cap = min(nv_cap, mn_)
        vflat = prep.valid.reshape(-1)
        sel = torch.argsort((~vflat).to(torch.int8), stable=True)[:nv_cap]
        q = torch.cat([vu0.reshape(mn_, 1, 2)[sel],
                       pvu.reshape(mn_, 6, 2)[sel]], dim=1)    # [NV, 7, 2]
        mean_c, var_c = obsgp.obsgp2d_test(obs, q.reshape(-1, 2), op, chunk)
        mean_c = mean_c.reshape(nv_cap, 7)
        var_c = var_c.reshape(nv_cap, 7)
        # gated-out pixels among the selected drop onto a dummy row
        tgt = torch.where(vflat[sel], sel, mn_)

        def scat(vals, fill):
            out = vals.new_full((mn_ + 1,) + vals.shape[1:], fill)
            out[tgt] = vals
            return out[:-1]

        var0 = scat(var_c[:, 0], obsgp._PAD_INVALID).reshape(m, n)
        prinv0 = scat(mean_c[:, 1:], 0.0).reshape(m, n, 6)
        pvar = scat(var_c[:, 1:], obsgp._PAD_INVALID).reshape(m, n, 6)
    elif blocked:
        var0, prinv0, pvar = _blocked_obs_sweep(obs, vu0, pvu, cam, mp, op)
    else:
        _, var0 = obsgp.obsgp2d_test(obs, vu0.reshape(-1, 2), op, chunk)
        var0 = var0.reshape(m, n)
        prinv0, pvar = obsgp.obsgp2d_test(obs, pvu.reshape(-1, 2), op,
                                          chunk)
        prinv0 = prinv0.reshape(m, n, 6)
        pvar = pvar.reshape(m, n, 6)
    gate = prep.valid & (var0 <= mp.obs_var_thre)
    probe_ok = torch.all(pvar <= mp.obs_var_thre, -1)
    pocc = occ_test(1.0 / pz, prinv0, ppos[..., 2] * 30.0)
    occ_mean = w * torch.sum(pocc, -1)

    graw = torch.stack([pocc[..., 0] - pocc[..., 1],
                        pocc[..., 2] - pocc[..., 3],
                        pocc[..., 4] - pocc[..., 5]], -1) / mp.delx
    norm2 = torch.sum(graw * graw, -1)
    hasg = norm2 > 1e-6
    norm = torch.sqrt(torch.clamp(norm2, min=1e-24))
    gl = graw / norm[..., None]
    gglob = gl @ rot.T

    dist = torch.sqrt(torch.sum(prep.xyz_local ** 2, -1))
    # 3D quirk: position noise saturates the LOCAL DISTANCE, not range^2
    # (GPisMap3.cpp:676)
    noise_g = mp.min_position_noise * torch.clamp(dist, 1.0, 100.0)
    gnoise_g = torch.clamp(torch.abs(occ_mean), mp.min_grad_noise, 1.0)
    view_ang = torch.clamp(
        -torch.sum(prep.xyz_local * gl, -1) / torch.clamp(dist, min=1e-12),
        min=0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise_g = noise_g + view_noise

    grad_out = torch.where(hasg[..., None], gglob, graw)
    noise = torch.where(hasg, noise_g, 100.0)
    gnoise = torch.where(hasg, gnoise_g, 1.0)

    def colmajor(a):
        return a.transpose(0, 1).reshape((m * n,) + a.shape[2:])

    return NewMeas3D(insert_ok=colmajor(gate & probe_ok),
                     pos=colmajor(prep.xyz_global),
                     grad=colmajor(grad_out), noise=colmajor(noise),
                     grad_noise=colmajor(gnoise))


def frame_compute_3d(depth: torch.Tensor, tr: torch.Tensor, rot: torch.Tensor,
                     cam: CameraParam, mp: MapperParam, op: ObsGPParam,
                     chunk: int = 4096, blocked: bool = False,
                     nv_cap: int = None, obs_c_cap: int = None):
    """The tree-independent frame stages: preprocess, the ObsGP2D fit
    (over the obs_c_cap nonempty cells when given, fit_obsgp2d's c_cap)
    and the new-measurement evaluation (newmeas_3d's nv_cap and blocked).
    Returns (Preproc3D, ObsGP2DState, NewMeas3D)."""
    prep = preprocess_3d(depth, tr, rot, cam, mp)
    obs = obsgp.fit_obsgp2d(prep.v, prep.u, prep.zinv, op, c_cap=obs_c_cap)
    nm = newmeas_3d(obs, prep, rot, mp, op, chunk, cam=cam, blocked=blocked,
                    nv_cap=nv_cap)
    return prep, obs, nm
