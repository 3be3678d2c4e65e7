"""Visualization for GPIS maps (the port's own numpy copy of
gpismap_tpu/viz.py; it takes numpy arrays, e.g. a mapper's test()
output, and the caller's matplotlib axes, and imports matplotlib only
inside the plot helpers that draw).

Python/matplotlib equivalents of the reference MATLAB plot scripts:
 - plot_field_2d: SDF pcolor + variance-filtered zero contour + scan rays
   (reference: matlab/visualize_gpisMap.m)
 - extract_surface_3d / plot_surface_3d: isosurface with per-vertex
   variance alpha (reference: matlab/visualize_gpisMap3.m)

Marching squares comes from matplotlib's contour machinery (the reference
bundles a third-party isocontour.m for the same job); the 3D isosurface is
extracted with vectorized marching *tetrahedra* (correct by construction,
no 256-entry tables, no scikit-image dependency).
"""
from __future__ import annotations

import numpy as np


def plot_field_2d(ax, res: np.ndarray, xtest: np.ndarray, grid_shape,
                  fbias: float = 0.2, var_thre: float = 0.4,
                  scan_xy: np.ndarray | None = None,
                  pose: np.ndarray | None = None):
    """2D SDF field + surface contour (visualize_gpisMap.m:20-60).

    res: [N, 6] output of GPisMap2D.test on the meshgrid flatten of
    `grid_shape`; xtest: [N, 2].
    """
    f = (res[:, 0] + fbias).reshape(grid_shape)
    var = res[:, 3].reshape(grid_shape)
    xg = xtest[:, 0].reshape(grid_shape)
    yg = xtest[:, 1].reshape(grid_shape)

    pc = ax.pcolormesh(xg, yg, f, cmap="RdBu", vmin=-1.0, vmax=1.0,
                       shading="auto")
    # variance overlay: a white layer whose per-pixel alpha IS the
    # variance, washing uncertain regions out (the MATLAB second-axes
    # pcolor(ones)+alpha(va) trick, visualize_gpisMap.m:60-64)
    ax.pcolormesh(xg, yg, np.ones_like(var), cmap="gray", vmin=0.0,
                  vmax=1.0, shading="auto",
                  alpha=np.clip(var, 0.0, 1.0))
    # zero contour, masked where uncertain (visualize_gpisMap.m:51-58)
    fm = np.where(var < var_thre, f, np.nan)
    ax.contour(xg, yg, fm, levels=[0.0], colors="k", linewidths=1.5)
    if scan_xy is not None:
        ax.plot(scan_xy[:, 0], scan_xy[:, 1], ".", ms=1, color="lime")
    if pose is not None:
        ax.plot([pose[0]], [pose[1]], "r^", ms=8)
    ax.set_aspect("equal")
    return pc


# body-diagonal (corner 0 to corner 6) decomposition of a cube into 6 tets
_CUBE_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                          [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]])
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]])
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def marching_tetrahedra(field: np.ndarray, level: float = 0.0,
                        spacing=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """Isosurface triangles of `field` at `level`.

    field: [NX, NY, NZ]; NaN corners suppress their cubes. Returns
    (verts [V, 3] float, faces [F, 3] int) with shared vertices.
    """
    nx, ny, nz = field.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    vals = np.empty((nx - 1, ny - 1, nz - 1, 8), np.float64)
    for ci, (dx, dy, dz) in enumerate(_CUBE_CORNERS):
        vals[..., ci] = field[dx:nx - 1 + dx, dy:ny - 1 + dy,
                              dz:nz - 1 + dz]
    ok = np.all(np.isfinite(vals), -1)
    below = vals < level
    some = below.any(-1) & (~below.all(-1)) & ok
    cxs, cys, czs = np.nonzero(some)
    if len(cxs) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    base = np.stack([cxs, cys, czs], -1)                     # [K, 3]
    cube_vals = vals[cxs, cys, czs]                          # [K, 8]

    # expand to tets: [K*6, 4] corner ids + values
    k = len(base)
    tet_corner = np.broadcast_to(_TETS, (k, 6, 4)).reshape(-1, 4)
    tet_vals = cube_vals[:, _TETS.reshape(-1)].reshape(k, 6, 4)\
        .reshape(-1, 4)
    tet_base = np.repeat(base, 6, axis=0)                    # [K6, 3]
    tb = tet_vals < level
    count = tb.sum(-1)

    # handle each sign case by reindexing so "inside" corners come first
    order = np.argsort(~tb, axis=-1, kind="stable")          # inside first
    tcs = np.take_along_axis(tet_corner, order, -1)
    tvs = np.take_along_axis(tet_vals, order, -1)

    def interp(sel, a, b):
        """Edge point between local corners a (inside) and b (outside)."""
        ca = tcs[sel, a]
        cb = tcs[sel, b]
        va = tvs[sel, a]
        vb = tvs[sel, b]
        t = (level - va) / np.where(vb != va, vb - va, 1.0)
        pa = tet_base[sel] + _CUBE_CORNERS[ca]
        pb = tet_base[sel] + _CUBE_CORNERS[cb]
        return pa * (1.0 - t[:, None]) + pb * t[:, None]

    tris = []
    sel1 = count == 1
    if sel1.any():
        p0 = interp(sel1, 0, 1)
        p1 = interp(sel1, 0, 2)
        p2 = interp(sel1, 0, 3)
        tris.append(np.stack([p0, p1, p2], 1))
    sel3 = count == 3
    if sel3.any():
        # one corner outside (local 3 after ordering)
        p0 = interp(sel3, 0, 3)
        p1 = interp(sel3, 1, 3)
        p2 = interp(sel3, 2, 3)
        tris.append(np.stack([p0, p1, p2], 1))
    sel2 = count == 2
    if sel2.any():
        # inside {0,1}, outside {2,3}: quad (0-2, 0-3, 1-3, 1-2)
        a = interp(sel2, 0, 2)
        b = interp(sel2, 0, 3)
        c = interp(sel2, 1, 3)
        d = interp(sel2, 1, 2)
        tris.append(np.stack([a, b, c], 1))
        tris.append(np.stack([a, c, d], 1))
    if not tris:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tri_pts = np.concatenate(tris, 0)                        # [F, 3, 3]

    # weld vertices
    flat = tri_pts.reshape(-1, 3)
    key = np.round(flat * 1e6).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    # representative positions
    verts = np.zeros((len(uniq), 3))
    verts[inv] = flat
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    spacing = np.asarray(spacing, float)
    origin = np.asarray(origin, float)
    return verts * spacing + origin, faces


def extract_surface_3d(res: np.ndarray, xtest: np.ndarray, grid_shape,
                       fbias: float = 0.2):
    """Isosurface of (f + fbias) at 0 on the demo volume grid
    (visualize_gpisMap3.m:25-36).

    The demo grid comes from meshgrid(xs, ys, zs) which orders axes
    (y, x, z); spacing/origin are recovered from xtest. Returns
    (verts [V, 3] in world xyz, faces).
    """
    f = (res[:, 0] + fbias).reshape(grid_shape)
    gy, gx, gz = grid_shape
    x0 = xtest[:, 0].reshape(grid_shape)
    y0 = xtest[:, 1].reshape(grid_shape)
    z0 = xtest[:, 2].reshape(grid_shape)
    sp = (y0[1, 0, 0] - y0[0, 0, 0] if gy > 1 else 1.0,
          x0[0, 1, 0] - x0[0, 0, 0] if gx > 1 else 1.0,
          z0[0, 0, 1] - z0[0, 0, 0] if gz > 1 else 1.0)
    org = (y0[0, 0, 0], x0[0, 0, 0], z0[0, 0, 0])
    verts, faces = marching_tetrahedra(f, 0.0, sp, org)
    if len(verts):
        verts = verts[:, [1, 0, 2]]          # back to world (x, y, z)
    return verts, faces


def slice_planes_3d(ang_deg: float = 20.0):
    """The two oblique SDF slice planes of the reference 3D visualization
    (visualize_gpisMap3.m:53-68): a horizontal plane at z = 0.12 and a
    vertical x = 0 plane, both rotated by R(ang)^T about the z axis
    (about the point (0.04, 0.02, 0) / translated by (0.04, 0, 0)).

    Returns [(pts [N, 3] float32 query points, grid_shape), ...] — query
    each through test() and color by f + fbias (plot_slices_3d).
    """
    ang = np.deg2rad(ang_deg)
    r = np.array([[np.cos(ang), np.sin(ang), 0.0],
                  [-np.sin(ang), np.cos(ang), 0.0],
                  [0.0, 0.0, 1.0]])
    out = []
    # plane 2: z = 0.12 sheet (visualize_gpisMap3.m:54-58)
    xg2, yg2 = np.meshgrid(np.arange(-0.05, 0.13 + 1e-9, 0.01),
                           np.arange(-0.10, 0.14 + 1e-9, 0.01))
    pts = np.stack([xg2.ravel(), yg2.ravel(),
                    np.full(xg2.size, 0.12)], 0)
    c = np.array([[0.04], [0.02], [0.0]])
    pts = r.T @ (pts - c) + c
    out.append((pts.T.astype(np.float32), xg2.shape))
    # plane 3: x = 0 sheet (visualize_gpisMap3.m:62-66)
    yg3, zg3 = np.meshgrid(np.arange(-0.10, 0.14 + 1e-9, 0.01),
                           np.arange(0.0, 0.30 + 1e-9, 0.01))
    pts = np.stack([np.zeros(yg3.size), yg3.ravel(), zg3.ravel()], 0)
    pts = r.T @ pts + np.array([[0.04], [0.0], [0.0]])
    out.append((pts.T.astype(np.float32), yg3.shape))
    return out


def plot_slices_3d(ax, planes, results, fbias: float = 0.2,
                   clim=(-0.05, 0.2), alpha: float = 0.6):
    """Overlay the re-queried SDF slice planes on the 3D axes
    (visualize_gpisMap3.m:70-82: jet colormap, CLim [-0.05, 0.2],
    FaceAlpha 0.6).

    planes: output of slice_planes_3d; results: matching list of [N, >=1]
    test() outputs (column 0 = f).
    """
    from matplotlib import cm
    from matplotlib.colors import Normalize

    norm = Normalize(vmin=clim[0], vmax=clim[1])
    mappable = cm.ScalarMappable(norm=norm, cmap="jet")
    for (pts, shape), res in zip(planes, results):
        f = (np.asarray(res)[:, 0] + fbias).reshape(shape)
        colors = mappable.to_rgba(f)
        colors[..., 3] = alpha
        ax.plot_surface(pts[:, 0].reshape(shape), pts[:, 1].reshape(shape),
                        pts[:, 2].reshape(shape), facecolors=colors,
                        rstride=1, cstride=1, linewidth=0,
                        antialiased=False, shade=False)
    return mappable


def plot_surface_3d(ax, verts, faces, vertex_var=None, var_thre=0.02):
    """Trisurf with variance alpha (visualize_gpisMap3.m:30-48)."""
    if len(verts) == 0:
        return None
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    tris = verts[faces]
    col = Poly3DCollection(tris, linewidths=0.05)
    if vertex_var is not None:
        fv = np.clip(1.0 - vertex_var[faces].mean(-1) / var_thre, 0.0, 1.0)
        colors = np.zeros((len(faces), 4))
        colors[:, 0] = 0.2
        colors[:, 1] = 0.5
        colors[:, 2] = 0.9
        colors[:, 3] = 0.15 + 0.85 * fv
        col.set_facecolor(colors)
    else:
        col.set_facecolor((0.2, 0.5, 0.9, 0.9))
    ax.add_collection3d(col)
    lo = verts.min(0)
    hi = verts.max(0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    return col
