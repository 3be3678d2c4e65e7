"""Checks of the 2D frame kernel (csrc/obsgp1d_frame.cu) against the
plain versions, shared by tests/test_torch_obsgp1d_frame.py and
chip_smoke.py (not a test file): a synthetic frame that reaches every
branch, the plain versions of a frame, and the kernel-vs-plain numbers
with their limits.
"""
import numpy as np
import torch

import torch_scenes
from gpismap_tpu_torch import MAPPER_2D, OBSGP_1D
from gpismap_tpu_torch.models import mapper2d as m2
from gpismap_tpu_torch.models import obsgp

# share of the valid rows whose action (nodes) or insert decision (beams)
# must agree between the kernel and the plain version on the card: the
# sums run in other orders, so a decision within rounding of its
# threshold may go the other way
AGREE = 0.995
# on the nodes that both re-insert (action 3, the rows whose fields the
# map takes) and on the beams both insert: positions and normals absolute
# (m; unit vectors), noises relative
POS_TOL = 1e-4
GRAD_TOL = 1e-4
NOISE_RTOL = 1e-3
G_MAX = 2048 // OBSGP_1D.group_size + 2     # 1081 beams padded to 2048


def branch_case(seed: int = 0):
    """A synthetic frame that reaches every branch: a wall in front and
    far walls behind with gaps (untrained groups and sentinel variances,
    the margins at the ends of the field of view), and 1,024 nodes near
    the scanned surface with random normals and noises (actions 0-3, fused
    and unfused, padding rows, 16 nodes behind the scanner). Returns the
    update's arguments as numpy arrays, padded as the mapper pads."""
    rng = np.random.default_rng(seed)
    nb = torch_scenes.N_BEAMS
    th = np.linspace(-torch_scenes.HALF_FOV, torch_scenes.HALF_FOV,
                     nb).astype(np.float32)
    r = np.where(np.abs(np.cos(th)) > 0.2, 6.0 / np.abs(np.cos(th)), 25.0)
    r = np.where(np.arange(nb) % 53 < 6, 0.0, np.minimum(r, 29.0))
    r = (r + rng.normal(0, 0.005, nb) * (r > 0)).astype(np.float32)
    th_p = np.zeros(2048, np.float32)
    rg_p = np.zeros(2048, np.float32)
    th_p[:nb], rg_p[:nb] = th, r
    tr = np.array([0.3, -0.2], np.float32)
    a = 0.3
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                   np.float32)
    k = 1024
    i = rng.integers(0, nb, k)
    loc = (np.stack([r[i] * np.cos(th[i]), r[i] * np.sin(th[i])], -1)
           + np.asarray(MAPPER_2D.sensor_offset))
    pos = (loc @ rot.T + tr + rng.normal(0, 0.05, (k, 2))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, k)
    grad = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    to_sensor = (tr - pos) / np.linalg.norm(tr - pos, axis=1, keepdims=True)
    face = rng.random(k) < 0.5
    grad[face] = to_sensor[face]
    ps = rng.uniform(0.005, 0.3, k).astype(np.float32)
    gs = np.where(rng.random(k) < 0.4, rng.uniform(0.6, 1.0, k),
                  rng.uniform(0.01, 0.3, k)).astype(np.float32)
    valid = rng.random(k) < 0.9
    pos[:16] = (tr - np.array([10.0, 0.0], np.float32)
                + rng.normal(0, 1, (16, 2)).astype(np.float32))
    return th_p, rg_p, tr, rot, pos, grad, ps, gs, valid


def case_args(case, dev):
    """frame_update_2d's positional arguments of a branch_case on dev."""
    return (tuple(torch.as_tensor(x, device=dev) for x in case)
            + (MAPPER_2D, OBSGP_1D))


def plain_frame(args, g_max=G_MAX):
    """(Reeval2D, NewMeas2D) of frame_update_2d's arguments by the plain
    versions, on the arguments' device."""
    th, rg, tr, rot, pos, grad, ps, gs, valid, mp, op = args
    prep = m2.preprocess_2d(th, rg, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op, g_max=g_max)
    return (m2.reeval_2d_reference(obs, pos, grad, ps, gs, valid, tr, rot,
                                   mp, op),
            m2.newmeas_2d_reference(obs, prep, rot, mp, op))


def _host(nt):
    return type(nt)(*(x.cpu().numpy() for x in nt))


def compare_frame(got, want, node_valid):
    """How far the kernel's (Reeval2D, NewMeas2D) lies from the plain
    versions': agreement shares over the valid nodes and every beam, and
    the largest differences of the fields on the rows where both
    re-insert a node (action 3), double its noises (action 1) or insert a
    beam."""
    rg, ng = _host(got[0]), _host(got[1])
    rw, nw = _host(want[0]), _host(want[1])
    v = np.asarray(node_valid)
    same = rg.action == rw.action
    three = same & v & (rw.action == 3)
    one = same & v & (rw.action == 1)
    ins = ng.insert_ok & nw.insert_ok

    def most(a, b, sel, rel=False):
        if not sel.any():
            return 0.0
        d = np.abs(a[sel] - b[sel]).reshape(sel.sum(), -1).max(1)
        if rel:
            d = d / np.abs(b[sel])
        return float(d.max())

    def share(agree, rows):
        return float((agree & rows).sum() / rows.sum()) if rows.any() \
            else 1.0

    return {
        "nodes": int(v.sum()), "beams": len(nw.insert_ok),
        "action_agree": share(same, v),
        "steps_agree": share(same & (rg.steps == rw.steps), v),
        "insert_agree": share(ng.insert_ok == nw.insert_ok,
                              np.ones(len(nw.insert_ok), bool)),
        "actions": np.bincount(rw.action[v], minlength=4).tolist(),
        "pos": most(rg.pos, rw.pos, three),
        "grad": most(rg.grad, rw.grad, three),
        "noise": most(rg.noise, rw.noise, three, rel=True),
        "grad_noise": most(rg.grad_noise, rw.grad_noise, three, rel=True),
        "dbl": max(most(rg.dbl_pos_sig, rw.dbl_pos_sig, one),
                   most(rg.dbl_grad_sig, rw.dbl_grad_sig, one)),
        "new_pos": most(ng.pos, nw.pos, ins),
        "new_grad": most(ng.grad, nw.grad, ins),
        "new_noise": most(ng.noise, nw.noise, ins, rel=True),
        "new_grad_noise": most(ng.grad_noise, nw.grad_noise, ins, rel=True),
        "steps": int(rg.steps[v].sum()), "steps_plain": int(rw.steps[v].sum()),
    }


def check_frame(c):
    """The kernel-vs-plain limits on compare_frame's numbers (raises
    AssertionError)."""
    assert c["action_agree"] >= AGREE, c
    assert c["insert_agree"] >= AGREE, c
    assert c["pos"] <= POS_TOL and c["new_pos"] <= POS_TOL, c
    assert c["grad"] <= GRAD_TOL and c["new_grad"] <= GRAD_TOL, c
    for key in ("noise", "grad_noise", "new_noise", "new_grad_noise"):
        assert c[key] <= NOISE_RTOL, c
    assert c["dbl"] == 0.0, c
