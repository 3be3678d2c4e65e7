"""The 3D observation-GP branches the JAX package takes on its accelerator,
in the PyTorch port: the compacted fit (fit_obsgp2d c_cap), the compacted
probe sweep (newmeas_3d nv_cap), the cell-blocked sweep
(obsgp2d_test_blocked, newmeas_3d blocked=True) and the host caps that
size them (api3d._obs_nv_cap, _obs_cell_cap), on the CPU.

The frames are tests/torch_scenes.py's box and cylinder through a
200x160 camera (fx = fy = 375): 100x80 pixels after obs_skip 2, 320 obs
cells, so a cap of 256 cells engages the compacted fit. Tolerances:
  * the compacted fit and sweep against the port's own dense path: equal
    to the last bit (each cell's system and each query's posterior is
    independent of the others);
  * against the JAX package's same branch: 1e-4, GRAD_TOL = 1e-3 on the
    normals and gradient noises (tests/test_torch_mapper3d.py);
  * the blocked sweep against the gather: the JAX package's own bounds
    (tests/test_obsgp.py): insert_ok equal, pos 1e-6, grad, noise and
    grad_noise 2e-3 with a median below 1e-4 (finite differences over
    delx = 1e-3 m of products summed in another order); in float64 the
    two sweeps agree to F64_TOL = 1e-9, and in float32 the blocked
    sweep's largest difference from the gather stays below the gather's
    own largest float32 error against float64 (the gate chip_smoke.py
    holds the blocked sweep to at 640x480).
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
from gpismap_tpu_torch import config as tcfg  # noqa: E402
from gpismap_tpu_torch.api3d import GPisMap3D  # noqa: E402
from gpismap_tpu_torch.models import mapper3d as tm  # noqa: E402
from gpismap_tpu_torch.models import obsgp as to  # noqa: E402

CAM = dict(fx=375.0, fy=375.0, cx=100.0, cy=80.0, width=200, height=160)
SMALL_CAM = dict(fx=120.0, fy=120.0, cx=32.0, cy=24.0, width=64, height=48)
GRAD_TOL = 1e-3
F64_TOL = 1e-9
NM_FIELDS = ("pos", "grad", "noise", "grad_noise")


def _args(frame, cam=CAM):
    depth, pose = frame
    tr = pose[:3].astype(np.float32)
    rot = pose[3:12].reshape(3, 3, order="F").astype(np.float32)
    return (depth, tr, rot, cam)


def _port(frame, cam=CAM, **kw):
    depth, tr, rot, cam = _args(frame, cam)
    return tm.frame_compute_3d(
        torch.as_tensor(depth), torch.as_tensor(tr), torch.as_tensor(rot),
        tcfg.CameraParam(**cam), tcfg.MAPPER_3D, tcfg.OBSGP_2D, **kw)


def _jax(frame, cam=CAM, **kw):
    depth, tr, rot, cam = _args(frame, cam)
    return jm.frame_compute_3d(
        jnp.asarray(depth), jnp.asarray(tr), jnp.asarray(rot),
        jcfg.CameraParam(**cam), jcfg.MAPPER_3D, jcfg.OBSGP_2D, **kw)


def _caps(frame, monkeypatch):
    """(nv, nv_cap, c_cap) of the port's mapper and the JAX package's on
    this frame, with GPISMAP_OBS_COMPACT=1; they must agree."""
    monkeypatch.setenv("GPISMAP_OBS_COMPACT", "1")
    out = []
    for m in (GPisMap3D(camera=tcfg.CameraParam(**CAM), device="cpu"),
              JaxMapper(camera=jcfg.CameraParam(**CAM))):
        nv, _ = m._host_gate(frame[0])
        out.append((nv, m._obs_nv_cap(nv),
                    m._obs_cell_cap(m._last_valid_mask)))
    assert out[0] == out[1]
    return out[0]


@pytest.fixture(scope="module")
def frame():
    return torch_scenes.object_frames(2, tcfg.CameraParam(**CAM))[1]


@pytest.fixture(scope="module")
def dense(frame):
    """The port's dense fit and gather sweep on the frame."""
    return _port(frame, blocked=False)


def test_obs_caps_match_jax(frame, dense, monkeypatch):
    """Both packages' host caps on the same frame, the cell count at or
    above the trained cells; 0 and the CPU's "auto" turn them off."""
    nv, nv_cap, c_cap = _caps(frame, monkeypatch)
    prep, obs, _ = dense
    assert nv == int(prep.valid.sum()) > 100
    assert nv_cap >= nv and c_cap >= int(obs.trained.sum())
    assert c_cap < obs.trained.shape[0] == 320          # engages
    m = GPisMap3D(camera=tcfg.CameraParam(**CAM), device="cpu")
    m._host_gate(frame[0])
    for v in ("0", None):
        if v is None:
            monkeypatch.delenv("GPISMAP_OBS_COMPACT")
        else:
            monkeypatch.setenv("GPISMAP_OBS_COMPACT", v)
        assert m._obs_nv_cap(nv) is None
        assert m._obs_cell_cap(m._last_valid_mask) is None


def test_fit_obsgp2d_compacted_matches_full(frame, dense, monkeypatch):
    """fit_obsgp2d(c_cap): the full fit's alpha and L^-1 to the last bit
    on every trained cell, the same trained mask, and the JAX package's
    compacted fit at 1e-4."""
    _, _, c_cap = _caps(frame, monkeypatch)
    prep, full, _ = dense
    comp = to.fit_obsgp2d(prep.v, prep.u, prep.zinv, tcfg.OBSGP_2D,
                          c_cap=c_cap)
    tr = full.trained
    assert torch.equal(comp.trained, tr)
    assert torch.equal(comp.alpha[tr], full.alpha[tr])
    assert torch.equal(comp.linv[tr], full.linv[tr])
    pj = _jax(frame, blocked=False)[0]
    jc = jo.fit_obsgp2d(pj.v, pj.u, pj.zinv, jcfg.OBSGP_2D, c_cap=c_cap)
    for name in ("alpha", "linv"):
        np.testing.assert_allclose(getattr(comp, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_newmeas_3d_compacted_matches_dense(frame, dense, monkeypatch):
    """newmeas_3d(nv_cap) after the compacted fit: the dense sweep's
    results to the last bit where a pixel can insert, and the JAX
    package's compacted frame at the module tolerances."""
    _, nv_cap, c_cap = _caps(frame, monkeypatch)
    nd = dense[2]
    nc = _port(frame, nv_cap=nv_cap, obs_c_cap=c_cap)[2]
    ok = nd.insert_ok
    assert torch.equal(nc.insert_ok, ok) and int(ok.sum()) > 100
    for name in NM_FIELDS:
        assert torch.equal(getattr(nc, name)[ok], getattr(nd, name)[ok]), name
    nj = _jax(frame, nv_cap=nv_cap, obs_c_cap=c_cap)[2]
    np.testing.assert_array_equal(np.asarray(nj.insert_ok), ok.numpy())
    okn = ok.numpy()
    for name in NM_FIELDS:
        tol = GRAD_TOL if name in ("grad", "grad_noise") else 1e-4
        np.testing.assert_allclose(getattr(nc, name).numpy()[okn],
                                   np.asarray(getattr(nj, name))[okn],
                                   rtol=tol, atol=tol, err_msg=name)


def test_nv_cap_beyond_the_pixel_count():
    """The 1024 floor of _obs_nv_cap exceeds a 64x48 camera's 768 pixels:
    the JAX package's newmeas_3d then fails to reshape its [nv_cap, 7]
    block; the port clamps the cap to the pixel count and gives the
    dense result."""
    frame = torch_scenes.object_frames(2, tcfg.CameraParam(**SMALL_CAM))[1]
    nd = _port(frame, SMALL_CAM, blocked=False)[2]
    nc = _port(frame, SMALL_CAM, nv_cap=1024)[2]
    ok = nd.insert_ok
    assert ok.shape[0] == 768 and int(ok.sum()) > 50
    assert torch.equal(nc.insert_ok, ok)
    for name in NM_FIELDS:
        assert torch.equal(getattr(nc, name)[ok], getattr(nd, name)[ok]), name
    with pytest.raises(TypeError, match="reshape"):
        _jax(frame, SMALL_CAM, nv_cap=1024)


def test_grid_ownership_matches_jax():
    for cam in (CAM, SMALL_CAM):
        rt, ct = tm._grid_ownership(tcfg.CameraParam(**cam), tcfg.MAPPER_3D,
                                    tcfg.OBSGP_2D)
        rj, cj = jm._grid_ownership(jcfg.CameraParam(**cam), jcfg.MAPPER_3D,
                                    jcfg.OBSGP_2D)
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(ct, cj)


def test_blocked_sweep_matches_gather(frame, dense):
    """newmeas_3d(blocked=True) against the gather sweep at the JAX
    package's bounds, and every valid pixel's probes within one cell of
    its pixel's static owning cell (the roff=1 coverage)."""
    prep, obs, nd = dense
    nb = _port(frame, blocked=True)[2]
    ok = nd.insert_ok
    assert torch.equal(nb.insert_ok, ok) and int(ok.sum()) > 100
    np.testing.assert_allclose(nb.pos[ok].numpy(), nd.pos[ok].numpy(),
                               rtol=1e-6, atol=1e-6)
    for name in ("grad", "noise", "grad_noise"):
        a, b = getattr(nb, name)[ok].numpy(), getattr(nd, name)[ok].numpy()
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3, err_msg=name)
        assert np.median(np.abs(a - b)) < 1e-4, name

    row_idx, col_idx = tm._grid_ownership(tcfg.CameraParam(**CAM),
                                          tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    m, n = prep.valid.shape
    a_of_row = np.full(m, -1)
    for a, rows in enumerate(row_idx):
        a_of_row[rows[rows >= 0]] = a
    b_of_col = np.full(n, -1)
    for b, cols in enumerate(col_idx):
        b_of_col[cols[cols >= 0]] = b
    ppos = (prep.xyz_local.numpy()[:, :, None, :]
            + np.asarray(tm._PROBES, np.float32) * tcfg.MAPPER_3D.delx)
    pz = np.where(np.abs(ppos[..., 2]) > 1e-12, ppos[..., 2], 1e-12)
    val_i, val_j = obs.val_i.numpy(), obs.val_j.numpy()
    a_true = np.clip(np.searchsorted(val_i[1:], ppos[..., 1] / pz, "right"),
                     0, len(val_i) - 2)
    b_true = np.clip(np.searchsorted(val_j[1:], ppos[..., 0] / pz, "right"),
                     0, len(val_j) - 2)
    valid = prep.valid.numpy()
    assert np.abs(a_true - a_of_row[:, None, None])[valid].max() <= 1
    assert np.abs(b_true - b_of_col[None, :, None])[valid].max() <= 1


def test_blocked_sweep_is_the_gather_in_float64(frame, dense):
    """The blocked sweep and the gather in float64: the same insertable
    pixels and results within F64_TOL, so they compute one function; in
    float32 the blocked sweep's largest normal and noise differences from
    the gather are below the gather's own float32 error."""
    depth, tr, rot, cam = _args(frame)
    args = (torch.as_tensor(depth).double(), torch.as_tensor(tr).double(),
            torch.as_tensor(rot).double(), tcfg.CameraParam(**cam),
            tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    d64 = tm.frame_compute_3d(*args, blocked=False)[2]
    b64 = tm.frame_compute_3d(*args, blocked=True)[2]
    ok = d64.insert_ok
    assert d64.grad.dtype == torch.float64
    assert torch.equal(b64.insert_ok, ok) and int(ok.sum()) > 100
    nd = dense[2]
    nb = _port(frame, blocked=True)[2]
    both = ok & nd.insert_ok
    for name in NM_FIELDS:
        a, b = getattr(b64, name)[ok], getattr(d64, name)[ok]
        assert float((a - b).abs().max()) <= F64_TOL, name
        if name == "pos":
            continue
        exact = getattr(d64, name)[both]
        own = float((getattr(nd, name)[both].double() - exact).abs().max())
        gap = float((getattr(nb, name)[both]
                     - getattr(nd, name)[both]).abs().max())
        assert gap < own, (name, gap, own)


def test_obsgp2d_test_blocked_matches_jax(frame, dense):
    """obsgp2d_test_blocked on the same grouped probe queries: the port
    and the JAX package at 1e-4, sentinels in the same places."""
    prep, obs, _ = dense
    pj, oj, _ = _jax(frame, blocked=False)
    row_idx, col_idx = tm._grid_ownership(tcfg.CameraParam(**CAM),
                                          tcfg.MAPPER_3D, tcfg.OBSGP_2D)
    rc = np.clip(row_idx, 0, prep.valid.shape[0] - 1)
    cc = np.clip(col_idx, 0, prep.valid.shape[1] - 1)
    vu = np.stack(np.meshgrid(prep.v.numpy(), prep.u.numpy(),
                              indexing="ij"), -1)
    rng = np.random.default_rng(3)
    q = vu[rc][:, :, cc].transpose(0, 2, 1, 3, 4).reshape(
        len(rc), len(cc), -1, 2)
    # probes move a query by well under a cell span
    q = (q + rng.normal(0.0, 2e-3, q.shape)).astype(np.float32)
    mt, vt = to.obsgp2d_test_blocked(obs, torch.as_tensor(q),
                                     tcfg.OBSGP_2D, roff=1)
    mj, vj = jo.obsgp2d_test_blocked(oj, jnp.asarray(q), jcfg.OBSGP_2D,
                                     roff=1)
    np.testing.assert_array_equal(vt.numpy() == 1e6, np.asarray(vj) == 1e6)
    assert (vt.numpy() < 1e6).sum() > 100
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-4,
                               atol=1e-4)


def test_obs_settings_are_passed_down(monkeypatch):
    """api3d reads GPISMAP_OBS_COMPACT and GPISMAP_OBS_BLOCKED at each
    update and passes them to frame_compute_3d: the blocked sweep only
    with 1/on, compaction winning over it, neither on the CPU unset."""
    seen = []
    orig = tm.frame_compute_3d

    def spy(*a, **kw):
        seen.append((kw["blocked"], kw["nv_cap"], kw["obs_c_cap"]))
        return orig(*a, **kw)

    monkeypatch.setattr(tm, "frame_compute_3d", spy)
    frame = torch_scenes.object_frames(2, tcfg.CameraParam(**SMALL_CAM))[1]
    m = GPisMap3D(camera=tcfg.CameraParam(**SMALL_CAM), device="cpu")
    cases = ((None, None, (False, False)), ("1", None, (True, False)),
             ("on", "0", (True, False)), ("0", "1", (False, True)),
             ("1", "1", (True, True)), ("off", None, (False, False)))
    for blocked, compact, (want_b, want_c) in cases:
        for key, v in (("GPISMAP_OBS_BLOCKED", blocked),
                       ("GPISMAP_OBS_COMPACT", compact)):
            if v is None:
                monkeypatch.delenv(key, raising=False)
            else:
                monkeypatch.setenv(key, v)
        m.update(*frame)
        b, nv_cap, c_cap = seen[-1]
        assert b == want_b and (nv_cap is not None) == want_c
        assert (c_cap is not None) == want_c
    assert len(seen) == len(cases)
