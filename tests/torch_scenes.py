"""Synthetic 2D LiDAR and 3D depth scenes for the PyTorch port (numpy
only).

2D: a polygonal floor plan inside the extent of the gazebo demo grid
(x in [-5, 20], y in [-15, 5], gpismap_tpu.datasets.gazebo_test_grid),
ray-cast for a scanner with the gazebo sequence's geometry: 1081 beams
over +-135 degrees, 30 m maximum range, mounted 0.08 m ahead of the
pose (MAPPER_2D.sensor_offset). Beams that hit nothing return the
maximum range, which the mapper's range gate drops.

3D: a box and a cylinder standing on z = 0 inside the bigbird demo
volume (x in [-0.07, 0.13], y in [-0.1, 0.14], z in [0, 0.28],
gpismap_tpu.datasets.bigbird_test_grid), ray-cast into depth images
(meters) of a pinhole camera on a ring of poses 0.62-0.70 m away, as the
bigbird rig circles its object. Pixels that hit nothing read BACKGROUND,
beyond MAPPER_3D.max_range, so the range gate drops them.

Used by the CPU parity tests (few beams, a 64x48 camera) and by
chip_smoke.py (at full width: 1081 beams, 640x480 depth).
"""
from __future__ import annotations

import os

import numpy as np

N_BEAMS = 1081
HALF_FOV = 0.75 * np.pi
MAX_RANGE = 30.0
SENSOR_OFFSET = (0.08, 0.0)
# the gazebo demo grid (demo_gpisMap.m:29-35): 0.1 m over the extent
GRID_X = (-5.0, 20.0)
GRID_Y = (-15.0, 5.0)


def _closed(*pts):
    p = np.asarray(pts, np.float64)
    return np.stack([p, np.roll(p, -1, axis=0)], axis=1)


def _polygon(cx, cy, r, n, phase=0.0):
    a = phase + 2 * np.pi * np.arange(n) / n
    return _closed(*np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1))


def floor_plan() -> np.ndarray:
    """Wall segments [S, 2, 2] of an office-like floor: outer walls, two
    interior walls with a door, a box, a pillar and a triangular crate.
    Coordinates stay off the quadtree's 0.2 m cell lattice."""
    segs = [
        _closed((-4.33, -14.29), (19.27, -14.29), (19.27, 4.31),
                (-4.33, 4.31)),
        np.array([[[-4.33, -2.13], [3.07, -2.13]],
                  [[4.73, -2.13], [8.07, -2.13]],
                  [[8.07, -2.13], [8.07, -9.31]],
                  [[13.09, -14.29], [13.09, -11.13]]]),
        _closed((11.53, -0.07), (12.87, -0.07), (12.87, 1.27),
                (11.53, 1.27)),
        _polygon(2.31, -6.71, 0.61, 8, phase=0.1),
        _closed((14.03, -8.93), (15.61, -8.47), (14.47, -7.29)),
    ]
    return np.concatenate(segs, axis=0)


def room_plan() -> np.ndarray:
    """A 4.6 x 3.8 m room with a box: small enough for tiny capacities."""
    return np.concatenate([
        _closed((-2.33, -1.87), (2.27, -1.87), (2.27, 1.93), (-2.33, 1.93)),
        _closed((0.73, 0.53), (1.37, 0.53), (1.37, 1.17), (0.73, 1.17)),
    ], axis=0)


def _path_poses(waypoints, n: int) -> np.ndarray:
    """n poses [x, y, heading] evenly spaced along a polyline."""
    w = np.asarray(waypoints, np.float64)
    seg = np.diff(w, axis=0)
    seglen = np.linalg.norm(seg, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seglen)])
    s = np.linspace(0.0, cum[-1], n)
    i = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg) - 1)
    t = (s - cum[i]) / seglen[i]
    xy = w[i] + t[:, None] * seg[i]
    heading = np.arctan2(seg[i, 1], seg[i, 0])
    return np.concatenate([xy, heading[:, None]], axis=1)


def floor_trajectory(n: int = 28) -> np.ndarray:
    """Poses [n, 3] (x, y, heading) through the free space of floor_plan."""
    return _path_poses([(0.1, 1.1), (10.3, 2.7), (16.5, 2.7), (16.5, -10.1),
                        (10.3, -10.3), (5.1, -11.7), (3.9, -4.9),
                        (3.9, 0.3)], n)


def room_trajectory(n: int = 3) -> np.ndarray:
    return _path_poses([(-1.2, -0.9), (0.1, -0.5), (-0.4, 0.6)], n)


def pose6(x, y, heading) -> np.ndarray:
    """[tx, ty, R00, R10, R01, R11] (column-major rotation, the mapper's
    pose convention)."""
    c, s = np.cos(heading), np.sin(heading)
    return np.array([x, y, c, s, -s, c], np.float32)


def cast(walls: np.ndarray, origin, angles: np.ndarray,
         max_range: float = MAX_RANGE) -> np.ndarray:
    """Distance from `origin` along each world angle to the nearest wall
    (max_range where nothing is hit)."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)[:, None, :]  # [B,1,2]
    a = walls[None, :, 0, :] - np.asarray(origin)                   # [1,S,2]
    e = (walls[:, 1, :] - walls[:, 0, :])[None]                     # [1,S,2]

    def cross(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    den = cross(d, e)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = cross(a, e) / den                    # distance along the ray
        u = cross(a, d) / den                    # position along the wall
    hit = (np.abs(den) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    return np.min(np.where(hit, t, np.inf), axis=1).clip(max=max_range)


def scans(walls: np.ndarray, poses: np.ndarray, n_beams: int = N_BEAMS,
          noise: float = 0.005, seed: int = 0):
    """Frames [(thetas [B], ranges [B], pose6 [6])] of the scanner at
    each pose, with Gaussian range noise of `noise` m from `seed`."""
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-HALF_FOV, HALF_FOV, n_beams).astype(np.float32)
    frames = []
    for x, y, h in poses:
        p = pose6(x, y, h)
        rot = p[2:6].reshape(2, 2, order="F").astype(np.float64)
        origin = np.array([x, y]) + rot @ np.asarray(SENSOR_OFFSET)
        r = cast(walls, origin, thetas.astype(np.float64) + h)
        hit = r < MAX_RANGE
        r = np.where(hit, r + noise * rng.standard_normal(n_beams),
                     MAX_RANGE)
        frames.append((thetas, r.astype(np.float32), p))
    return frames


def frame_rays(frames):
    """Every beam of frames [(thetas [B], ranges [B], pose6 [6])] as a ray
    for a renderer: (origins [F*B, 2] at the sensor, unit dirs [F*B, 2],
    the frames' ranges [F*B]), float32, frame-major."""
    origins, dirs = [], []
    for thetas, _, p in frames:
        rot = p[2:6].reshape(2, 2, order="F").astype(np.float64)
        origin = p[:2].astype(np.float64) + rot @ np.asarray(SENSOR_OFFSET)
        ang = thetas.astype(np.float64) + np.arctan2(p[3], p[2])
        origins.append(np.broadcast_to(origin, (len(thetas), 2)))
        dirs.append(np.stack([np.cos(ang), np.sin(ang)], -1))
    return (np.concatenate(origins).astype(np.float32),
            np.concatenate(dirs).astype(np.float32),
            np.concatenate([f[1] for f in frames]).astype(np.float32))


def beams(walls: np.ndarray, poses: np.ndarray, n_beams: int = N_BEAMS):
    """Every beam of the scanner at each pose as a ray for a renderer: the
    frame_rays of the noise-free scans (ranges MAX_RANGE where nothing is
    hit)."""
    return frame_rays(scans(walls, poses, n_beams, noise=0.0))


def floor_frames(n_frames: int = 28, n_beams: int = N_BEAMS, seed: int = 0):
    return scans(floor_plan(), floor_trajectory(n_frames), n_beams,
                 seed=seed)


def room_frames(n_frames: int = 3, n_beams: int = 181, seed: int = 0):
    return scans(room_plan(), room_trajectory(n_frames), n_beams, seed=seed)


def gazebo_path():
    """The bundled gazebo sequence under $GPISMAP_DATA (the data root
    gpismap_tpu.datasets reads), or None when it is not there."""
    root = os.environ.get("GPISMAP_DATA")
    path = root and os.path.join(root, "2D", "gazebo1.mat")
    return path if path and os.path.exists(path) else None


def gazebo_frames(path: str, n_frames: int = 28):
    """The real sequence on the demo schedule (demo_gpisMap.m:37-40,
    frames 101:100:end, 1-based), as gpismap_tpu.datasets.gazebo_frames
    yields it: [(thetas, ranges, pose6)]."""
    import scipy.io as sio
    d = sio.loadmat(path)
    poses = np.asarray(d["poses"], np.float32)
    thetas = np.asarray(d["thetas"], np.float32).reshape(-1)
    ranges = np.asarray(d["ranges"], np.float32)
    frames = []
    for nf in range(101, poses.shape[0] + 1, 100)[:n_frames]:
        x, y, phi = poses[nf - 1]
        frames.append((thetas, ranges[nf - 1], pose6(x, y, phi)))
    return frames


def query_grid(intv: float = 0.1) -> np.ndarray:
    """The gazebo demo evaluation grid (demo_gpisMap.m:29-35): 49,551
    points at 0.1 m, the constants of gazebo_test_grid."""
    xs = np.arange(GRID_X[0] + intv, GRID_X[1] - intv / 2, intv,
                   dtype=np.float32)
    ys = np.arange(GRID_Y[0] + intv, GRID_Y[1] - intv / 2, intv,
                   dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], -1)


def wall_probes(walls: np.ndarray, poses: np.ndarray, offset: float = 0.3,
                n_per_wall: int = 5):
    """Pairs of points `offset` m either side of each wall, at points the
    trajectory sees head-on: returns (near [K, 2], far [K, 2]), `near` on
    the side of the scanner, `far` behind the wall."""
    near, far = [], []
    centers = poses[:, :2]
    for (p0, p1) in walls:
        e = p1 - p0
        length = np.linalg.norm(e)
        nrm = np.array([-e[1], e[0]]) / length
        for s in (np.arange(n_per_wall) + 0.5) / n_per_wall:
            w = p0 + s * e
            to_c = centers - w
            dist = np.linalg.norm(to_c, axis=1)
            # the closest pose that sees this wall point without occlusion
            i = int(np.argmin(dist))
            ang = np.arctan2(-to_c[i, 1], -to_c[i, 0])
            if abs(cast(walls, centers[i], np.array([ang]))[0]
                   - dist[i]) > 1e-3 or dist[i] > 8.0:
                continue
            side = 1.0 if np.dot(to_c[i], nrm) > 0 else -1.0
            near.append(w + side * offset * nrm)
            far.append(w - side * offset * nrm)
    return np.asarray(near, np.float32), np.asarray(far, np.float32)


# ---- 3D: an object in the bigbird demo volume --------------------------
VOLUME_X = (-0.07, 0.13)
VOLUME_Y = (-0.1, 0.14)
VOLUME_Z = (0.0, 0.28)
# an upright box and cylinder; coordinates stay off the octree's 0.0125 m
# leaf lattice
BOX = (np.array([-0.0437, -0.0713, 0.0]), np.array([0.0361, 0.0089, 0.1693]))
CYLINDER = (0.0731, 0.0787, 0.0347, 0.0, 0.2213)   # cx, cy, r, z0, z1
RING_CENTER = (0.03, 0.02)
LOOK_AT_Z = 0.11
BACKGROUND = 5.0          # depth of a pixel that hits nothing (> 4 m)


def ring_poses(n: int) -> np.ndarray:
    """n camera poses [n, 12] = [t(3), R column-major(9)] (the 3D mapper's
    convention, R world-from-camera: x right, y down, z forward) on a
    ring around the object at alternating radii (0.62 / 0.70 m) and
    heights (0.18 to 0.42 m), each looking at the object's middle."""
    poses = []
    for i in range(n):
        ang = 2.0 * np.pi * i / n
        rad = (0.62, 0.70)[i % 2]
        eye = np.array([RING_CENTER[0] + rad * np.cos(ang),
                        RING_CENTER[1] + rad * np.sin(ang),
                        (0.18, 0.30, 0.42, 0.30)[i % 4]])
        fwd = np.array([RING_CENTER[0], RING_CENTER[1], LOOK_AT_Z]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd], axis=1)
        poses.append(np.concatenate([eye, rot.ravel(order="F")]))
    return np.asarray(poses, np.float32)


def _hit_box(o, d):
    lo, hi = BOX
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - o) / d
        t2 = (hi - o) / d
    tmin = np.max(np.minimum(t1, t2), axis=-1)
    tmax = np.min(np.maximum(t1, t2), axis=-1)
    return np.where((tmax >= tmin) & (tmin > 0), tmin, np.inf)


def _hit_cylinder(o, d):
    cx, cy, r, z0, z1 = CYLINDER
    ox, oy = o[0] - cx, o[1] - cy
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (ox * d[..., 0] + oy * d[..., 1])
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4.0 * a * c
    with np.errstate(divide="ignore", invalid="ignore"):
        ts = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
        zs = o[2] + ts * d[..., 2]
        side = np.where((disc >= 0) & (ts > 0) & (zs >= z0) & (zs <= z1),
                        ts, np.inf)
        caps = []
        for zc in (z0, z1):
            tc = (zc - o[2]) / d[..., 2]
            px = o[0] + tc * d[..., 0] - cx
            py = o[1] + tc * d[..., 1] - cy
            caps.append(np.where((tc > 0) & (px * px + py * py <= r * r),
                                 tc, np.inf))
    return np.minimum(side, np.minimum(*caps))


def render_depth(pose: np.ndarray, cam, noise: float = 3e-4,
                 rng=None) -> np.ndarray:
    """Depth image [cam.height, cam.width] (meters along the optical
    axis) of the object seen from `pose`; cam has the pinhole fields of
    CameraParam (fx, fy, cx, cy, width, height). Hits get Gaussian noise
    of `noise` m from `rng` and the 0.1 mm quantization of the bigbird
    depth images; misses read BACKGROUND."""
    eye = pose[:3].astype(np.float64)
    rot = pose[3:12].reshape(3, 3, order="F").astype(np.float64)
    u = (np.arange(cam.width) - cam.cx) / cam.fx
    v = (np.arange(cam.height) - cam.cy) / cam.fy
    ray = np.stack([np.broadcast_to(u[None, :], (cam.height, cam.width)),
                    np.broadcast_to(v[:, None], (cam.height, cam.width)),
                    np.ones((cam.height, cam.width))], -1)
    d = ray @ rot.T          # camera z = 1: the ray parameter is the depth
    t = np.minimum(_hit_box(eye, d), _hit_cylinder(eye, d))
    hit = np.isfinite(t)
    if rng is not None and noise > 0:
        t = t + noise * rng.standard_normal(t.shape)
    t = np.round(t * 1e4) * 1e-4
    return np.where(hit, t, BACKGROUND).astype(np.float32)


def ray_lengths(pose: np.ndarray, cam, subsample: int = 1) -> np.ndarray:
    """Noise-free truth for a renderer's unit pixel rays (the rows and
    columns a renderer at `subsample` takes): render_depth gives the depth
    z along the optical axis, and a unit ray through pixel (u, v) travels
    z * |(u, v, 1)| to the same point. inf where nothing is hit."""
    z = render_depth(pose, cam, noise=0.0).astype(np.float64)
    z = np.where(z < BACKGROUND, z, np.inf)[::subsample, ::subsample]
    u = (np.arange(0, cam.width, subsample) - cam.cx) / cam.fx
    v = (np.arange(0, cam.height, subsample) - cam.cy) / cam.fy
    return z * np.sqrt(u[None, :] ** 2 + v[:, None] ** 2 + 1.0)


def object_frames(n_frames: int, cam, seed: int = 0):
    """Frames [(depth [H, W], pose12 [12])] of the object from the first
    n_frames poses of ring_poses(40) (fewer frames keep the ring's
    spacing), with depth noise from `seed`."""
    rng = np.random.default_rng(seed)
    poses = ring_poses(40)[:n_frames]
    return [(render_depth(p, cam, rng=rng), p) for p in poses]


def volume_grid(intv: float = 0.01) -> np.ndarray:
    """The bigbird demo volume (demo_gpisMap3.m:37-38): 21 x 25 x 29 =
    15,225 points at 0.01 m, the constants of bigbird_test_grid."""
    xs = np.arange(VOLUME_X[0], VOLUME_X[1] + intv / 2, intv,
                   dtype=np.float32)
    ys = np.arange(VOLUME_Y[0], VOLUME_Y[1] + intv / 2, intv,
                   dtype=np.float32)
    zs = np.arange(VOLUME_Z[0], VOLUME_Z[1] + intv / 2, intv,
                   dtype=np.float32)
    xg, yg, zg = np.meshgrid(xs, ys, zs)
    return np.stack([xg.reshape(-1), yg.reshape(-1), zg.reshape(-1)], -1)


def surface_probes(offset: float = 0.01, step: float = 0.01,
                   margin: float = 0.015):
    """Pairs of points `offset` m outside and inside the object's surface
    along its true normal, on a `step` grid over the faces the ring sees
    (box sides and top, cylinder side and top), `margin` m clear of
    every edge. Returns (outside [K, 3], inside [K, 3])."""
    lo, hi = BOX
    pts, nrm = [], []

    def grid(a0, a1, b0, b1):
        a = np.arange(a0 + margin, a1 - margin + 1e-9, step)
        b = np.arange(b0 + margin, b1 - margin + 1e-9, step)
        return np.stack(np.meshgrid(a, b), -1).reshape(-1, 2)

    for ax in (0, 1):                       # box sides
        other = 1 - ax
        for sign, face in ((-1.0, lo[ax]), (1.0, hi[ax])):
            g = grid(lo[other], hi[other], lo[2], hi[2])
            p = np.zeros((len(g), 3))
            p[:, ax] = face
            p[:, other] = g[:, 0]
            p[:, 2] = g[:, 1]
            n = np.zeros(3)
            n[ax] = sign
            pts.append(p)
            nrm.append(np.broadcast_to(n, p.shape))
    g = grid(lo[0], hi[0], lo[1], hi[1])    # box top
    pts.append(np.concatenate([g, np.full((len(g), 1), hi[2])], 1))
    nrm.append(np.broadcast_to([0.0, 0.0, 1.0], (len(g), 3)))
    cx, cy, r, z0, z1 = CYLINDER
    ang = np.arange(0.0, 2.0 * np.pi, step / r)
    zz = np.arange(z0 + margin, z1 - margin + 1e-9, step)
    a, z = [x.reshape(-1) for x in np.meshgrid(ang, zz)]
    n = np.stack([np.cos(a), np.sin(a), np.zeros_like(a)], -1)
    pts.append(np.stack([cx + r * n[:, 0], cy + r * n[:, 1], z], -1))
    nrm.append(n)
    g = grid(cx - r, cx + r, cy - r, cy + r)  # cylinder top
    g = g[np.hypot(g[:, 0] - cx, g[:, 1] - cy) <= r - margin]
    pts.append(np.concatenate([g, np.full((len(g), 1), z1)], 1))
    nrm.append(np.broadcast_to([0.0, 0.0, 1.0], (len(g), 3)))
    p, n = np.concatenate(pts), np.concatenate(nrm)
    return ((p + offset * n).astype(np.float32),
            (p - offset * n).astype(np.float32))
