"""PyTorch port vs the JAX package: the 2D observation GP and the 3D
mapper's per-frame stages (preprocessing, re-evaluation, the hybrid
strict-order re-evaluation, new measurements) and the cluster-GP fit at
d = 3.

Depth frames come from tests/torch_scenes.py (a box and a cylinder seen
by a 64x48 camera, fx = fy = 120); both packages run on the CPU in
float32. Actions and gates must match exactly, floats to rounding-order
tolerance:
  * 1e-4 for positions, noises, observation-GP means and variances;
  * GRAD_TOL = 1e-3 for the normals and the gradient noises. The
    normals are finite differences over delx = 1e-3 m of the occupancy
    proxy (GPisMap3.cpp:413-480, :644-646), ten times finer than in 2D:
    the two packages' batched Cholesky of the observation GPs differ by
    ~1e-5 (other LAPACK paths), the occupancy by ~1e-7, and the normals
    by that over delx, measured at most 3e-4 on these scenes. The
    gradient noise holds the probe depths' variance, a cancellation
    divided by delx as well (measured at most 1.2e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import torch_scenes  # noqa: E402
from gpismap_tpu import config as jcfg  # noqa: E402
from gpismap_tpu.api3d import GPisMap3D as JaxMapper  # noqa: E402
from gpismap_tpu.models import mapper3d as jm  # noqa: E402
from gpismap_tpu.models import obsgp as jo  # noqa: E402
from gpismap_tpu.ops import gp as jgp  # noqa: E402
from gpismap_tpu_torch import config as tcfg  # noqa: E402
from gpismap_tpu_torch.models import mapper3d as tm  # noqa: E402
from gpismap_tpu_torch.models import obsgp as to  # noqa: E402
from gpismap_tpu_torch.ops import gp as tgp  # noqa: E402

CAM = dict(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64, height=48)
GRAD_TOL = 1e-3
FD_FIELDS = ("grad", "grad_noise", "dbl_grad_sig")   # GRAD_TOL fields
NODE_FIELDS = ("pos", "grad", "pos_sig", "grad_sig")


def _close(a, b, tol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=tol, atol=tol,
                               err_msg=msg)


def _pose_args(pose):
    tr = pose[:3].astype(np.float32)
    rot = pose[3:12].reshape(3, 3, order="F").astype(np.float32)
    return tr, rot


def _frame_both(depth, pose):
    """frame_compute_3d of both packages on one frame:
    ((prep, obs, nm) JAX, (prep, obs, nm) port, (tr, rot))."""
    tr, rot = _pose_args(pose)
    j = jm.frame_compute_3d(jnp.asarray(depth), jnp.asarray(tr),
                            jnp.asarray(rot), jcfg.CameraParam(**CAM),
                            jcfg.MAPPER_3D, jcfg.OBSGP_2D, blocked=False)
    t = tm.frame_compute_3d(torch.as_tensor(depth), torch.as_tensor(tr),
                            torch.as_tensor(rot), tcfg.CameraParam(**CAM),
                            tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    return j, t, (tr, rot)


@pytest.fixture(scope="module")
def scene():
    """Three frames, both packages' frame stages on frame 1, and the map
    of the JAX mapper after frame 0 (its nodes, padded to a pow2 as the
    mapper pads them, and its cells' integer coords in index order)."""
    frames = torch_scenes.object_frames(3, tcfg.CameraParam(**CAM))
    m = JaxMapper(camera=jcfg.CameraParam(**CAM))
    m.update(*frames[0])
    d = m.index.dump_nodes()
    ids = np.nonzero(d["alive"])[0]
    k = 1 << max(0, (len(ids) - 1).bit_length())
    nodes = {}
    for name in NODE_FIELDS:
        a = np.zeros((k,) + d[name].shape[1:], np.float32)
        a[:len(ids)] = d[name][ids]
        nodes[name] = a
    nodes["valid"] = np.arange(k) < len(ids)
    centers, _, _ = m.index.cell_info(m.index.all_cluster_cells())
    coords = np.floor(centers / m.cell_size).astype(np.int32)
    return dict(frames=frames, both=_frame_both(*frames[1]), nodes=nodes,
                coords=coords, cell_size=m.cell_size)


@pytest.mark.parametrize("n,gs,ov", [(24, 5, 3), (32, 5, 3), (240, 5, 3),
                                     (320, 5, 3), (17, 4, 2)])
def test_partition_1axis_matches_jax(n, gs, ov):
    assert to.partition_1axis(n, gs, ov) == jo.partition_1axis(n, gs, ov)


def test_preprocess_3d_matches_jax(scene):
    (pj, _, _), (pt, _, _), _ = scene["both"]
    for name in pj._fields:
        np.testing.assert_allclose(
            pt._asdict()[name].numpy().astype(np.float64),
            np.asarray(getattr(pj, name)).astype(np.float64), rtol=0,
            atol=1e-6, err_msg=name)


def test_fit_obsgp2d_and_test_match_jax(scene):
    (pj, oj, _), (pt, ot, _), _ = scene["both"]
    for name in ("valid", "trained"):
        np.testing.assert_array_equal(np.asarray(getattr(oj, name)),
                                      getattr(ot, name).numpy(), name)
    for name in ("x", "val_i", "val_j"):
        _close(getattr(oj, name), getattr(ot, name), 1e-7, name)
    _close(oj.alpha, ot.alpha, msg="alpha")
    _close(oj.linv, ot.linv, msg="linv")
    # queries: on the rays, between them, on the cell boundaries and
    # outside the image
    v, u = pt.v.numpy(), pt.u.numpy()
    vv = np.concatenate([v, v[:-1] + 0.5 * np.diff(v), ot.val_i.numpy(),
                         [-2.0, 2.0]])
    uu = np.concatenate([u, u[:-1] + 0.5 * np.diff(u), ot.val_j.numpy(),
                         [-2.0, 2.0]])
    rng = np.random.default_rng(0)
    q = np.stack([rng.choice(vv, 3000), rng.choice(uu, 3000)],
                 -1).astype(np.float32)
    mj, vj = jo.obsgp2d_test(oj, jnp.asarray(q), jcfg.OBSGP_2D)
    mt, vt = to.obsgp2d_test(ot, torch.as_tensor(q), tcfg.OBSGP_2D)
    np.testing.assert_array_equal(np.asarray(vj) == 1e6, vt.numpy() == 1e6)
    _close(mj, mt, msg="mean")
    _close(vj, vt, msg="var")


def test_quat_blend_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(200, 3)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=(200, 3))).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    b[:5] = a[:5]                          # coincident normals
    b[5:8] = -a[5:8]                       # opposite normals (acos clamp)
    frac = rng.uniform(0, 1, 200).astype(np.float32)
    gj = jm._quat_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(frac))
    gt = tm._quat_blend(torch.as_tensor(a), torch.as_tensor(b),
                        torch.as_tensor(frac))
    assert torch.isfinite(gt).all()
    _close(gj, gt, 1e-5)


def _nodes_j_t(nodes):
    names = NODE_FIELDS + ("valid",)
    return ([jnp.asarray(nodes[k]) for k in names],
            [torch.as_tensor(nodes[k]) for k in names])


def _check_reeval(rj, rt, valid, msg=""):
    act = np.asarray(rj.action)
    np.testing.assert_array_equal(act, rt.action.numpy(), msg)
    assert rt.action.dtype == torch.int32
    sel = valid & (act != 0)
    for f in ("pos", "grad", "noise", "grad_noise", "dbl_pos_sig",
              "dbl_grad_sig"):
        tol = GRAD_TOL if f in FD_FIELDS else 1e-4
        _close(np.asarray(getattr(rj, f))[sel], getattr(rt, f)[sel], tol,
               f"{msg} {f}")
    return act


@pytest.mark.parametrize("compat", [True, False])
def test_reeval_3d_matches_jax(scene, compat):
    """Nodes of frame 0 re-evaluated against frame 1's observation GP,
    with the closed-form (compat) and the corrected relocation loop."""
    (_, oj, _), (_, ot, _), (tr, rot) = scene["both"]
    nj, nt = _nodes_j_t(scene["nodes"])
    rj = jm.reeval_3d(oj, *nj, jnp.asarray(tr), jnp.asarray(rot),
                      jcfg.MAPPER_3D, jcfg.OBSGP_2D, compat=compat)
    rt = tm.reeval_3d(ot, *nt, torch.as_tensor(tr), torch.as_tensor(rot),
                      tcfg.MAPPER_3D, tcfg.OBSGP_2D, compat=compat)
    act = _check_reeval(rj, rt, scene["nodes"]["valid"], f"compat={compat}")
    assert (act == 3).sum() >= 10, np.bincount(act)


def _forward_mover_order(scene):
    """The cells in an order that makes nodes relocated across a cell
    boundary land in a LATER kept cell: every cell some node moves into
    goes last (the hybrid's fix-up rounds then re-process them)."""
    (_, _, _), (_, ot, _), (tr, rot) = scene["both"]
    _, nt = _nodes_j_t(scene["nodes"])
    rv = tm.reeval_3d(ot, *nt, torch.as_tensor(tr), torch.as_tensor(rot),
                      tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    cs = scene["cell_size"]
    old = np.floor(scene["nodes"]["pos"] / np.float32(cs)).astype(np.int32)
    new = np.floor(rv.pos.numpy() / np.float32(cs)).astype(np.int32)
    moved = (rv.action.numpy() == 3) & np.any(old != new, -1)
    dest = {tuple(c) for c in new[moved]}
    coords = scene["coords"]
    late = np.array([tuple(c) in dest for c in coords])
    assert late.any() and (~late).any()
    return np.concatenate([coords[~late], coords[late]])


@pytest.mark.parametrize("max_movers,rounds", [(128, 4), (2, 1)])
def test_reeval_hybrid_3d_matches_jax(scene, max_movers, rounds):
    """The hybrid strict-order re-evaluation on a cell order with forward
    movers: the final composite actions, values and the dropped count
    (a small mover bound drops some) equal JAX's, and the fix-up rounds
    changed the outcome of at least one node against a single pass."""
    (_, oj, _), (_, ot, _), (tr, rot) = scene["both"]
    coords = _forward_mover_order(scene)
    cpad = 1 << max(3, (len(coords) - 1).bit_length())
    cc = np.zeros((cpad, 3), np.int32)
    cc[:len(coords)] = coords
    cok = np.arange(cpad) < len(coords)
    nj, nt = _nodes_j_t(scene["nodes"])
    kw = dict(compat=True, max_movers=max_movers, rounds=rounds)
    rj, dj = jm.reeval_hybrid_3d(
        oj, *nj, jnp.asarray(cc), jnp.asarray(cok), jnp.asarray(tr),
        jnp.asarray(rot), jnp.float32(scene["cell_size"]), jcfg.MAPPER_3D,
        jcfg.OBSGP_2D, **kw)
    rt, dt = tm.reeval_hybrid_3d(
        ot, *nt, torch.as_tensor(cc), torch.as_tensor(cok),
        torch.as_tensor(tr), torch.as_tensor(rot),
        np.float32(scene["cell_size"]), tcfg.MAPPER_3D, tcfg.OBSGP_2D, **kw)
    valid = scene["nodes"]["valid"]
    _check_reeval(rj, rt, valid, "hybrid")
    assert dt == int(dj)
    assert (dt > 0) == (max_movers == 2)
    one = tm.reeval_3d(ot, *nt, torch.as_tensor(tr), torch.as_tensor(rot),
                       tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    # a re-processed mover ends with other values than its first pass
    moved = valid & (one.action.numpy() == 3)
    differs = moved & ((np.abs(rt.noise.numpy() - one.noise.numpy()) > 0)
                       | np.any(rt.pos.numpy() != one.pos.numpy(), -1)
                       | (rt.action.numpy() != 3))
    assert differs.any()


@pytest.mark.parametrize("kc", [512, 8])
def test_reeval_scan_3d_matches_jax(scene, kc):
    """The per-cell scan ("fused") on the same cell order with forward
    movers: the final composite actions, values and the dropped count
    equal JAX's, with kc = 512 (no cell overflows) and kc = 8 (the larger
    cells do: the members past kc are dropped and counted)."""
    (_, oj, _), (_, ot, _), (tr, rot) = scene["both"]
    coords = _forward_mover_order(scene)
    cpad = 1 << max(3, (len(coords) - 1).bit_length())
    cc = np.zeros((cpad, 3), np.int32)
    cc[:len(coords)] = coords
    cok = np.arange(cpad) < len(coords)
    nj, nt = _nodes_j_t(scene["nodes"])
    rj, dj = jm.reeval_scan_3d(
        oj, *nj, jnp.asarray(cc), jnp.asarray(cok), jnp.asarray(tr),
        jnp.asarray(rot), jnp.float32(scene["cell_size"]), jcfg.MAPPER_3D,
        jcfg.OBSGP_2D, compat=True, kc=kc)
    rt, dt = tm.reeval_scan_3d(
        ot, *nt, torch.as_tensor(cc), torch.as_tensor(cok),
        torch.as_tensor(tr), torch.as_tensor(rot),
        np.float32(scene["cell_size"]), tcfg.MAPPER_3D, tcfg.OBSGP_2D,
        compat=True, kc=kc)
    valid = scene["nodes"]["valid"]
    act = _check_reeval(rj, rt, valid, f"scan kc={kc}")
    assert dt == int(dj)
    assert (dt > 0) == (kc == 8)
    assert (act == 3).sum() >= 10, np.bincount(act)


def test_newmeas_3d_matches_jax(scene):
    (_, _, nj), (_, _, nt), _ = scene["both"]
    ok = np.asarray(nj.insert_ok)
    np.testing.assert_array_equal(ok, nt.insert_ok.numpy())
    assert ok.sum() > 50
    for f in ("pos", "grad", "noise", "grad_noise"):
        tol = GRAD_TOL if f in FD_FIELDS else 1e-4
        _close(np.asarray(getattr(nj, f))[ok], getattr(nt, f)[ok], tol, f)


def test_newmeas_3d_does_not_depend_on_chunk(scene):
    """The chunk of the posterior gather (4096 here, larger on the card)
    only bounds memory."""
    depth, pose = scene["frames"][1]
    tr, rot = (torch.as_tensor(a) for a in _pose_args(pose))
    args = (torch.as_tensor(depth), tr, rot, tcfg.CameraParam(**CAM),
            tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    a = tm.frame_compute_3d(*args, chunk=4096)[2]
    b = tm.frame_compute_3d(*args, chunk=100)[2]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("m", [8, 16])
def test_fit_ongpis_3d_matches_jax(m):
    """The cluster-GP fit and its L^-1 at d = 3 (MP = 4M)."""
    rng = np.random.default_rng(40 + m)
    b, d = 4, 3
    x = rng.uniform(-0.05, 0.05, (b, m, d)).astype(np.float32)
    grad = rng.normal(size=(b, m, d)).astype(np.float32)
    grad /= np.linalg.norm(grad, axis=-1, keepdims=True)
    grad[rng.uniform(size=(b, m)) < 0.1] = 0.0
    siggrad = np.where(rng.uniform(size=(b, m)) < 0.3, 0.3,
                       rng.uniform(0.02, 0.09, (b, m))).astype(np.float32)
    sigx = rng.uniform(0.01, 0.1, (b, m)).astype(np.float32)
    val = np.full((b, m), -0.2, np.float32)
    valid = rng.uniform(size=(b, m)) > 0.2
    args = (x, grad, val, sigx, siggrad, valid)
    scale = tcfg.MAPPER_3D.map_scale_param
    sj = jgp.fit_ongpis(*(jnp.asarray(a) for a in args), scale)
    st = tgp.fit_ongpis(*(torch.as_tensor(a) for a in args), scale)
    assert st.l.shape == (b, m * (1 + d), m * (1 + d))
    np.testing.assert_array_equal(np.asarray(sj.gradflag),
                                  st.gradflag.numpy())
    _close(sj.l, st.l, 1e-4)
    _close(sj.alpha, st.alpha, 1e-3)
    lt = tgp.linv_from_chol(st.l)
    _close(jgp.linv_from_chol(sj.l), lt, 1e-3)
    assert torch.all(torch.triu(lt, diagonal=1) == 0)
