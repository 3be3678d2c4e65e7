"""The port's own numpy copies of gpismap_tpu/datasets.py and viz.py
against the JAX package's, on synthetic files written to tmp_path (the
bundled data is not needed to check the loaders) and on synthetic
fields. Plots are drawn on matplotlib's Agg canvas."""
import os

import numpy as np

from gpismap_tpu import datasets as jd
from gpismap_tpu import viz as jv
from gpismap_tpu_torch import datasets as td
from gpismap_tpu_torch import viz as tv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gazebo_mat(path, n=350, b=9, seed=0):
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    sio.savemat(path, dict(
        poses=rng.uniform(-3, 3, (n, 3)),
        thetas=np.linspace(-2.3, 2.3, b)[None, :],
        ranges=rng.uniform(0.5, 20.0, (n, b))))


def _bigbird_dir(root, h=6, w=8, seed=0):
    """A bigbird-layout tree: pose/poses.txt and one masked depth PNG
    (0.1 mm units) per frame of the demo schedule."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pose"))
    os.makedirs(os.path.join(root, "masked_depth"))
    np.savetxt(os.path.join(root, "pose", "poses.txt"),
               rng.normal(size=(60, 16)))
    frame_nums = list(range(93, 360, 3)) + list(range(3, 91, 3))
    cams = [1, 2, 3, 4, 3, 2] * 30
    for count, k in enumerate(range(0, len(frame_nums), 3)):
        depth = rng.integers(0, 9000, (h, w)).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(
            root, "masked_depth",
            f"frame{frame_nums[k]}_cam{cams[count]}.png"))


def test_gazebo_loaders_match_jax(tmp_path):
    path = str(tmp_path / "gazebo1.mat")
    _gazebo_mat(path)
    for a, b in zip(td.load_gazebo(path), jd.load_gazebo(path)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    ft, fj = list(td.gazebo_frames(path)), list(jd.gazebo_frames(path))
    assert len(ft) == len(fj) == 3          # frames 101, 201, 301
    for a, b in zip(ft, fj):
        assert a.frame == b.frame
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    for intv in (0.1, 0.25):
        (xt, st), (xj, sj) = td.gazebo_test_grid(intv), \
            jd.gazebo_test_grid(intv)
        assert st == sj
        np.testing.assert_array_equal(xt, xj)
    assert td.gazebo_test_grid()[0].shape == (49551, 2)


def test_bigbird_loaders_match_jax(tmp_path):
    root = str(tmp_path / "bigbird_detergent")
    _bigbird_dir(root)
    ft, fj = list(td.bigbird_frames(root)), list(jd.bigbird_frames(root))
    assert len(ft) == len(fj) == 40
    for a, b in zip(ft, fj):
        assert (a.frame, a.cam_id) == (b.frame, b.cam_id)
        for x, y in zip(a[2:], b[2:]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    (xt, st), (xj, sj) = td.bigbird_test_grid(), jd.bigbird_test_grid()
    assert st == sj and xt.shape == (15225, 3)
    np.testing.assert_array_equal(xt, xj)


def test_data_root_defaults(monkeypatch):
    """$GPISMAP_DATA names the data root in both packages; unset, the
    port reads data/ at the checkout's root."""
    import importlib

    try:
        monkeypatch.setenv("GPISMAP_DATA", "/some/root")
        assert importlib.reload(td).REFERENCE_DATA == "/some/root"
        monkeypatch.delenv("GPISMAP_DATA")
        assert importlib.reload(td).REFERENCE_DATA == os.path.join(REPO,
                                                                   "data")
    finally:
        monkeypatch.undo()
        importlib.reload(td)


def _sdf_volume():
    """The demo volume grid and a sphere SDF on it, as test() gives it
    ([N, 8], f = sdf - fbias, var_f)."""
    xtest, shape = jd.bigbird_test_grid()
    c = np.array([0.03, 0.02, 0.14], np.float32)
    r = np.linalg.norm(xtest - c, axis=1)
    res = np.zeros((len(xtest), 8), np.float32)
    res[:, 0] = r - 0.07 - 0.2
    res[:, 4] = np.clip(r - 0.05, 0.0, 1.0)
    return xtest, shape, res


def test_marching_and_surface_match_jax():
    n = 14
    xs = np.linspace(-1.3, 1.3, n)
    x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    f = np.sqrt(x * x + y * y + (1.2 * z) ** 2) - 1.0
    f[2, 3, 4] = np.nan
    sp, org = (xs[1] - xs[0],) * 3, (xs[0],) * 3
    for level in (0.0, 0.3):
        vt, ft = tv.marching_tetrahedra(f, level, spacing=sp, origin=org)
        vj, fj = jv.marching_tetrahedra(f, level, spacing=sp, origin=org)
        assert len(ft) > 100
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
    xtest, shape, res = _sdf_volume()
    (vt, ft), (vj, fj) = tv.extract_surface_3d(res, xtest, shape), \
        jv.extract_surface_3d(res, xtest, shape)
    assert len(vt) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    r = np.linalg.norm(vt - np.array([0.03, 0.02, 0.14]), axis=1)
    assert abs(r.mean() - 0.07) < 2e-3
    for (pt, st), (pj, sj) in zip(tv.slice_planes_3d(30.0),
                                  jv.slice_planes_3d(30.0)):
        assert st == sj
        np.testing.assert_array_equal(pt, pj)


def test_plots_match_jax():
    """Each plot helper draws the same artists on the caller's axes as
    the JAX package's (tests/test_torch_slice.py checks that importing
    the module loads no matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xtest, shape = jd.gazebo_test_grid(0.5)
    r = np.linalg.norm(xtest - np.array([5.0, -4.0]), axis=1)
    res = np.zeros((len(xtest), 6), np.float32)
    res[:, 0] = r - 3.0 - 0.2
    res[:, 3] = np.clip((r - 2.0) / 4.0, 0.0, 1.0)
    scan = xtest[::7]
    pose = np.array([5.0, -4.0, 1, 0, 0, 1], np.float32)
    xvol, svol, rvol = _sdf_volume()
    drawn = []
    for mod in (tv, jv):
        fig = plt.figure()
        ax = fig.add_subplot(1, 2, 1)
        pc = mod.plot_field_2d(ax, res, xtest, shape, scan_xy=scan,
                               pose=pose)
        ax3 = fig.add_subplot(1, 2, 2, projection="3d")
        verts, faces = mod.extract_surface_3d(rvol, xvol, svol)
        col = mod.plot_surface_3d(ax3, verts, faces,
                                  vertex_var=np.full(len(verts), 0.01))
        planes = mod.slice_planes_3d()
        mappable = mod.plot_slices_3d(
            ax3, planes, [np.full((len(p), 8), 0.05, np.float32)
                          for p, _ in planes])
        fig.canvas.draw()
        drawn.append((np.asarray(pc.get_array()), len(ax.collections),
                      len(ax.lines), len(ax3.collections),
                      col.get_facecolor().copy(), mappable.get_clim()))
        plt.close(fig)
    (at, nt, lt, ct, fct, cl_t), (aj, nj, lj, cj, fcj, cl_j) = drawn
    np.testing.assert_array_equal(at, aj)
    assert (nt, lt, ct, cl_t) == (nj, lj, cj, cl_j) and lt == 2
    np.testing.assert_array_equal(fct, fcj)
    assert tv.plot_surface_3d(None, np.zeros((0, 3)), np.zeros((0, 3))) \
        is None
