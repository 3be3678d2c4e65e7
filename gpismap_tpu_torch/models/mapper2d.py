"""2D online mapper — the per-frame device computations.

Port of gpismap_tpu/models/mapper2d.py. The reference's per-node
sequential pipeline (GPisMap.cpp:151-572) as batched tensor stages:

  preprocess_2d  — range gating + polar->cartesian + rigid transform
                   (GPisMap.cpp:105-149)
  reeval_2d      — re-evaluate existing map nodes against the new scan:
                   occupancy test, iterative surface re-localization,
                   finite-difference normal, noise model, fusion
                   (GPisMap.cpp:235-455)
  newmeas_2d     — evaluate new surface candidates per beam
                   (GPisMap.cpp:466-572)

Loops over nodes/beams are tensor axes; the 10-step re-localization runs
in lockstep with per-node break masks (the reference's break conditions).
The host runtime applies the implied tree mutations in reference order.

reeval_2d and newmeas_2d run their plain versions (reeval_2d_reference,
newmeas_2d_reference) for CPU tensors and one CUDA kernel for CUDA
tensors (ops/obsgp1d_frame.py, csrc/obsgp1d_frame.cu), with no fallback
from one to the other; frame_update_2d issues both stages as that one
launch. The kernel writes a frame's outputs into one packed buffer
(NODE_WORDS a node, then BEAM_WORDS a beam), which pack_frame_2d builds
from the plain versions' outputs and unpack_frame_2d splits, on the
device or on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import MapperParam, ObsGPParam
from ..ops import obsgp1d_frame
from . import obsgp

# refinement-loop iteration cap and occupancy gates
# (GPisMap.cpp:264,279,304 — hard-coded in the reference)
_RELOC_ITERS = 10
_OCC_STOP = 0.02
_PROBES = ((1., 0.), (-1., 0.), (0., 1.), (0., -1.))


def occ_test(rinv, rinv0, a):
    """Logistic occupancy proxy 2*(sigmoid(a*(rinv-rinv0)) - 0.5)
    (GPisMap.cpp:39-42)."""
    return 2.0 * (torch.sigmoid(a * (rinv - rinv0)) - 0.5)


def _occ_at(r, rinv0):
    return occ_test(1.0 / torch.sqrt(torch.clamp(r, min=1e-12)), rinv0,
                    r * 30.0)


class Preproc2D(NamedTuple):
    valid: torch.Tensor       # [N] range-gated beams
    theta: torch.Tensor       # [N]
    rng: torch.Tensor         # [N] raw ranges
    f: torch.Tensor           # [N] 1/sqrt(range)
    xy_local: torch.Tensor    # [N, 2] sensor-frame hit (no offset)
    xy_global: torch.Tensor   # [N, 2] world-frame hit
    range_obs_max: torch.Tensor  # scalar


def preprocess_2d(theta: torch.Tensor, rng: torch.Tensor, tr: torch.Tensor,
                  rot: torch.Tensor, mp: MapperParam) -> Preproc2D:
    """Range gate + transforms (GPisMap.cpp:105-149).
    rot: [2, 2] world-from-sensor rotation; tr: [2]."""
    valid = (rng > mp.min_range) & (rng < mp.max_range)
    f = 1.0 / torch.sqrt(torch.clamp(rng, min=1e-12))
    loc = torch.stack([rng * torch.cos(theta), rng * torch.sin(theta)], -1)
    off = loc.new_tensor(mp.sensor_offset)
    glob = (loc + off) @ rot.T + tr
    rmax = torch.max(torch.where(valid, rng, 0.0))
    return Preproc2D(valid=valid, theta=theta, rng=rng, f=f, xy_local=loc,
                     xy_global=glob, range_obs_max=rmax)


class Reeval2D(NamedTuple):
    """Per-node outcome. action: 0 keep, 1 double-noise, 2 remove,
    3 remove+reinsert."""

    action: torch.Tensor      # [K] int32
    pos: torch.Tensor         # [K, 2] new world position (action 3)
    grad: torch.Tensor        # [K, 2] new world normal (action 3)
    noise: torch.Tensor       # [K] new position noise (action 3)
    grad_noise: torch.Tensor  # [K]
    dbl_pos_sig: torch.Tensor   # [K] doubled noises (action 1)
    dbl_grad_sig: torch.Tensor  # [K]
    steps: torch.Tensor       # [K] int32 re-localization steps taken


def reeval_2d(obs: obsgp.ObsGP1DState, pos: torch.Tensor, grad: torch.Tensor,
              pos_sig: torch.Tensor, grad_sig: torch.Tensor,
              valid: torch.Tensor, tr: torch.Tensor, rot: torch.Tensor,
              mp: MapperParam, op: ObsGPParam,
              chunk: int = 1024) -> Reeval2D:
    """Batched reEvalPoints (GPisMap.cpp:235-455): reeval_2d_reference for
    CPU tensors, the kernel for CUDA tensors (views of its packed
    buffer)."""
    if pos.device.type == "cpu":
        return reeval_2d_reference(obs, pos, grad, pos_sig, grad_sig, valid,
                                   tr, rot, mp, op, chunk)
    nodes = (pos, grad, pos_sig, grad_sig, valid)
    return unpack_frame_2d(_frame_kernel(obs, nodes, None, tr, rot, mp, op),
                           pos.shape[0], 0)[0]


def reeval_2d_reference(obs: obsgp.ObsGP1DState, pos: torch.Tensor,
                        grad: torch.Tensor, pos_sig: torch.Tensor,
                        grad_sig: torch.Tensor, valid: torch.Tensor,
                        tr: torch.Tensor, rot: torch.Tensor, mp: MapperParam,
                        op: ObsGPParam, chunk: int = 1024) -> Reeval2D:
    """Plain version of reeval_2d, on any device."""
    k = pos.shape[0]
    off = pos.new_tensor(mp.sensor_offset)

    def obs_at(xy):
        ang = torch.atan2(xy[..., 1], xy[..., 0])
        r = torch.sqrt(torch.sum(xy * xy, -1))
        m, v = obsgp.obsgp1d_test(obs, ang.reshape(-1), op, chunk)
        return m.reshape(ang.shape), v.reshape(ang.shape), r

    loc = (pos - tr) @ rot - off                   # world -> sensor frame
    rinv0, var, r = obs_at(loc)
    gate = valid & (var <= mp.obs_var_thre)
    oc = _occ_at(r, rinv0)
    active = gate & (oc >= -0.1)                   # GPisMap.cpp:258-265
    grad_loc = grad @ rot

    # --- iterative re-localization (GPisMap.cpp:273-315) ---
    x_new = loc
    dx = torch.full((k,), mp.delx, dtype=pos.dtype, device=pos.device)
    abs_oc = torch.abs(oc)
    r_new = r
    cont = active & (abs_oc > _OCC_STOP)
    steps = torch.zeros(k, dtype=torch.int32, device=pos.device)
    for _ in range(_RELOC_ITERS):
        steps = steps + cont
        step = torch.where(oc[:, None] < 0, 1.0, -1.0) * grad_loc * dx[:, None]
        x_new = torch.where(cont[:, None], x_new + step, x_new)
        rinv0_n, var_n, r_t = obs_at(x_new)
        r_new = torch.where(cont, r_t, r_new)
        brk_var = var_n > mp.obs_var_thre
        oc_n = _occ_at(r_t, rinv0_n)
        brk_oc = (torch.abs(oc_n) < _OCC_STOP) | (oc < -0.1)
        upd = cont & ~brk_var & ~brk_oc
        flip = oc * oc_n < 0.0
        dx = torch.where(upd, torch.where(flip, 0.5 * dx, 1.1 * dx), dx)
        oc = torch.where(upd, oc_n, oc)
        abs_oc = torch.where(upd, torch.abs(oc_n), abs_oc)
        cont = upd & (torch.abs(oc_n) > _OCC_STOP)

    # --- 4-probe normal + noise model (GPisMap.cpp:317-380) ---
    pert = pos.new_tensor(_PROBES) * mp.delx
    prinv0, pvar, pr = obs_at(x_new[:, None, :] + pert[None])   # [K, 4]
    probe_ok = torch.all(pvar <= mp.obs_var_thre, dim=-1)
    pocc = _occ_at(pr, prinv0)
    occ_mean = 0.25 * torch.sum(pocc, -1)
    r0 = 1.0 / torch.clamp(prinv0 * prinv0, min=1e-12)
    r0_sqr_sum = torch.sum(r0 * r0, -1)
    r0_mean = 0.25 * torch.sum(r0, -1)

    act2 = active & probe_ok
    gnl = torch.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3]],
                      -1) / mp.delx
    norm_g = torch.sqrt(torch.sum(gnl * gnl, -1))
    dbl = act2 & (norm_g < 1e-3)                   # GPisMap.cpp:354-357
    act3 = act2 & (norm_g >= 1e-3)

    r_var = (r0_sqr_sum / 3.0 - r0_mean * r0_mean * 4.0 / 3.0) / mp.delx
    gnl_n = gnl / torch.clamp(norm_g, min=1e-12)[:, None]
    noise = mp.min_position_noise * torch.clamp(r_new * r_new, 1.0, 100.0)
    grad_noise = torch.clamp(torch.abs(occ_mean) + r_var, mp.min_grad_noise,
                             1.0)
    dist = torch.sqrt(torch.sum(x_new * x_new, -1))
    view_ang = torch.clamp(
        -torch.sum(x_new * gnl_n, -1) / torch.clamp(dist, min=1e-12),
        min=0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise = noise + view_noise + abs_oc
    grad_noise = grad_noise + 0.1 * view_noise

    pos_new = (x_new + off) @ rot.T + tr
    grad_new = gnl_n @ rot.T

    # --- fusion with the old estimate (GPisMap.cpp:391-421) ---
    fuse = grad_sig <= 0.5
    psum = pos_sig + noise
    pos_f = (noise[:, None] * pos + pos_sig[:, None] * pos_new) / psum[:, None]
    dist_f = 0.5 * torch.sqrt(torch.sum((pos - pos_f) ** 2, -1))
    tv_x = grad[:, 0] * grad_new[:, 0] + grad[:, 1] * grad_new[:, 1]
    tv_y = -grad[:, 1] * grad_new[:, 0] + grad[:, 0] * grad_new[:, 1]
    angd = torch.atan2(tv_y, tv_x) * noise / psum
    ca, sa = torch.cos(angd), torch.sin(angd)
    grad_f = torch.stack([ca * grad[:, 0] - sa * grad[:, 1],
                          sa * grad[:, 0] + ca * grad[:, 1]], -1)
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

    discard = (noise_out > 1.0) & (gnoise_out > 0.61)  # GPisMap.cpp:425
    action = torch.where(dbl, 1, torch.where(act3 & discard, 2,
                                             torch.where(act3, 3, 0)))
    # action-1 outcomes carry the doubled noises as floats (the
    # reference's updateNoise(2*psig, 2*gsig), GPisMap.cpp:354-357)
    return Reeval2D(action=action.to(torch.int32), pos=pos_out,
                    grad=grad_out, noise=noise_out, grad_noise=gnoise_out,
                    dbl_pos_sig=2.0 * pos_sig, dbl_grad_sig=2.0 * grad_sig,
                    steps=steps)


class NewMeas2D(NamedTuple):
    insert_ok: torch.Tensor   # [N] beam produces a new surface node
    pos: torch.Tensor         # [N, 2] world position
    grad: torch.Tensor        # [N, 2] world normal (or raw local, see quirk)
    noise: torch.Tensor       # [N]
    grad_noise: torch.Tensor  # [N]


def newmeas_2d(obs: obsgp.ObsGP1DState, prep: Preproc2D, rot: torch.Tensor,
               mp: MapperParam, op: ObsGPParam,
               chunk: int = 1024) -> NewMeas2D:
    """Batched evalPoints (GPisMap.cpp:466-572): newmeas_2d_reference for
    CPU tensors, the kernel for CUDA tensors (views of its packed
    buffer)."""
    if prep.theta.device.type == "cpu":
        return newmeas_2d_reference(obs, prep, rot, mp, op, chunk)
    buf = _frame_kernel(obs, None, _beams(prep), None, rot, mp, op)
    return unpack_frame_2d(buf, 0, prep.theta.shape[0])[1]


def newmeas_2d_reference(obs: obsgp.ObsGP1DState, prep: Preproc2D,
                         rot: torch.Tensor, mp: MapperParam, op: ObsGPParam,
                         chunk: int = 1024) -> NewMeas2D:
    """Plain version of newmeas_2d (evalPoints, GPisMap.cpp:466-572), on
    any device.

    The reference inserts each candidate before probing and removes it
    if a probe fails (GPisMap.cpp:490-534); probe outcomes do not depend
    on the tree, so insert_ok pre-filters and the host inserts winners.
    """
    n = prep.theta.shape[0]
    _, var0 = obsgp.obsgp1d_test(obs, prep.theta, op, chunk)
    gate = prep.valid & (var0 <= mp.obs_var_thre)

    pert = prep.xy_local.new_tensor(_PROBES) * mp.delx
    ppos = prep.xy_local[:, None, :] + pert[None]
    ang = torch.atan2(ppos[..., 1], ppos[..., 0])
    pr = torch.sqrt(torch.sum(ppos * ppos, -1))
    prinv0, pvar = obsgp.obsgp1d_test(obs, ang.reshape(-1), op, chunk)
    prinv0 = prinv0.reshape(n, 4)
    pvar = pvar.reshape(n, 4)
    probe_ok = torch.all(pvar <= mp.obs_var_thre, dim=-1)
    pocc = _occ_at(pr, prinv0)
    occ_mean = 0.25 * torch.sum(pocc, -1)

    graw = torch.stack([pocc[:, 0] - pocc[:, 1], pocc[:, 2] - pocc[:, 3]],
                       -1) / mp.delx
    norm2 = torch.sum(graw * graw, -1)
    hasg = norm2 > 1e-6                            # GPisMap.cpp:544-545
    norm = torch.sqrt(torch.clamp(norm2, min=1e-24))
    gl = graw / norm[:, None]
    gglob = gl @ rot.T

    noise_g = mp.min_position_noise * torch.clamp(prep.rng * prep.rng, 1.0,
                                                  100.0)
    gnoise_g = torch.clamp(torch.abs(occ_mean), mp.min_grad_noise, 1.0)
    dist = torch.sqrt(torch.sum(prep.xy_local ** 2, -1))
    view_ang = torch.clamp(
        -torch.sum(prep.xy_local * gl, -1) / torch.clamp(dist, min=1e-12),
        min=0.1)
    view_noise = mp.min_position_noise * (1.0 - view_ang ** 2) / view_ang ** 2
    noise_g = noise_g + view_noise

    # reference quirk kept: gradient-free candidates store the raw local
    # occupancy difference un-normalized/un-rotated with noise 100/1.0
    # (GPisMap.cpp:538-560)
    return NewMeas2D(insert_ok=gate & probe_ok, pos=prep.xy_global,
                     grad=torch.where(hasg[:, None], gglob, graw),
                     noise=torch.where(hasg, noise_g, 100.0),
                     grad_noise=torch.where(hasg, gnoise_g, 1.0))


# the packed frame (the kernel's output layout, ops/obsgp1d_frame.py): per
# node [action, pos (2), grad (2), noise, grad_noise, dbl_pos_sig,
# dbl_grad_sig, steps], then per beam [insert_ok, pos (2), grad (2),
# noise, grad_noise], float32 words; action, steps and insert_ok (0/1) are
# int32 bits, so insert_ok's first byte is its bool (little-endian)
NODE_WORDS = obsgp1d_frame.NODE_WORDS
BEAM_WORDS = obsgp1d_frame.BEAM_WORDS


def pack_frame_2d(rv: Reeval2D, nm: NewMeas2D) -> torch.Tensor:
    """The packed frame of the plain versions' outputs (the kernel's
    layout, bit for bit), on their device."""
    i32 = torch.int32

    def words(cols):
        return torch.cat([(c if c.dim() == 2 else c[:, None]).view(i32)
                          for c in cols], 1).reshape(-1)

    return torch.cat([
        words((rv.action, rv.pos, rv.grad, rv.noise, rv.grad_noise,
               rv.dbl_pos_sig, rv.dbl_grad_sig, rv.steps)),
        words((nm.insert_ok.to(i32), nm.pos, nm.grad, nm.noise,
               nm.grad_noise))]).view(torch.float32)


def unpack_frame_2d(buf, k: int, n: int):
    """Split a packed frame of k nodes and n beams (a torch tensor on any
    device, or a numpy array) into (Reeval2D, NewMeas2D) views of it."""
    if isinstance(buf, torch.Tensor):
        i32, u8, b8 = torch.int32, torch.uint8, torch.bool
    else:
        i32, u8, b8 = np.int32, np.uint8, np.bool_
    nodes = buf[:k * NODE_WORDS].reshape(k, NODE_WORDS)
    beams = buf[k * NODE_WORDS:k * NODE_WORDS + n * BEAM_WORDS].reshape(
        n, BEAM_WORDS)
    rv = Reeval2D(action=nodes[:, 0].view(i32), pos=nodes[:, 1:3],
                  grad=nodes[:, 3:5], noise=nodes[:, 5],
                  grad_noise=nodes[:, 6], dbl_pos_sig=nodes[:, 7],
                  dbl_grad_sig=nodes[:, 8], steps=nodes[:, 9].view(i32))
    nm = NewMeas2D(insert_ok=beams.view(u8)[:, 0].view(b8),
                   pos=beams[:, 1:3], grad=beams[:, 3:5], noise=beams[:, 5],
                   grad_noise=beams[:, 6])
    return rv, nm


def _frame_kernel(obs, nodes, beams, tr, rot, mp, op) -> torch.Tensor:
    """The packed frame of the nodes and beams, from the kernel."""
    return obsgp1d_frame.frame_2d(obs, nodes, beams, tr, rot, mp, op,
                                  _RELOC_ITERS, _OCC_STOP)


def _beams(prep: Preproc2D):
    """The kernel's beam tensors of the preprocessed beams."""
    return (prep.valid, prep.theta, prep.rng, prep.xy_local, prep.xy_global)


def _rows(prep: Preproc2D, rows: slice | None) -> Preproc2D:
    """The beams in rows (all of them for None)."""
    return prep if rows is None else Preproc2D(
        *(x[rows] if x.dim() else x for x in prep))


def frame_compute_2d(theta: torch.Tensor, rng: torch.Tensor,
                     tr: torch.Tensor, rot: torch.Tensor, mp: MapperParam,
                     op: ObsGPParam, g_max: int, chunk: int = 1024,
                     rows: slice | None = None):
    """The tree-independent frame stages: preprocess, the obs-GP fit and
    the new-measurement evaluation (the strict mode re-evaluates the
    nodes cell by cell after it). rows: the beams whose new measurements
    to evaluate (None: all of them; a mesh rank passes its share).
    Returns (Preproc2D, ObsGP1DState, NewMeas2D)."""
    prep = preprocess_2d(theta, rng, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=g_max)
    nm = newmeas_2d(obs, _rows(prep, rows), rot, mp, op, chunk)
    return prep, obs, nm


def frame_update_2d(theta: torch.Tensor, rng: torch.Tensor, tr: torch.Tensor,
                    rot: torch.Tensor, node_pos: torch.Tensor,
                    node_grad: torch.Tensor, node_ps: torch.Tensor,
                    node_gs: torch.Tensor, node_valid: torch.Tensor,
                    mp: MapperParam, op: ObsGPParam, g_max: int,
                    chunk: int = 1024, rows: slice | None = None,
                    packed: bool = False):
    """The whole per-frame device compute: preprocess, obs-GP fit,
    re-evaluation of the host-gathered in-view nodes, and
    new-measurement evaluation of the beams in rows (None: all of them).
    On CUDA tensors both stages are one kernel launch. Returns
    (Reeval2D, NewMeas2D), or with packed=True their packed frame
    (pack_frame_2d's layout)."""
    prep = preprocess_2d(theta, rng, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=g_max)
    beams = _rows(prep, rows)
    nodes = (node_pos, node_grad, node_ps, node_gs, node_valid)
    if theta.device.type == "cpu":
        nm = newmeas_2d_reference(obs, beams, rot, mp, op, chunk)
        rv = reeval_2d_reference(obs, *nodes, tr, rot, mp, op, chunk)
        return pack_frame_2d(rv, nm) if packed else (rv, nm)
    buf = _frame_kernel(obs, nodes, _beams(beams), tr, rot, mp, op)
    return buf if packed else unpack_frame_2d(buf, node_pos.shape[0],
                                              beams.theta.shape[0])
