"""The benchmark's frozen synthetic scenes (numpy and plain torch only).

A copy, frozen here so that the benchmark's traffic does not move when the
program or its tests change, of the scene generator that the port's CPU
tests use (tests/torch_scenes.py):

2D: a polygonal floor plan inside the extent of the gazebo demo grid
(x in [-5, 20], y in [-15, 5]), ray-cast for a scanner whose geometry
(beams, field of view, maximum range, mount offset) the configuration's
`sensor` gives: for gazebo2d the gazebo sequence's 1081 beams over +-135
degrees, 30 m, mounted 0.08 m ahead of the pose. Beams that hit nothing
return the maximum range, which the mapper's range gate drops.

3D: a box and a cylinder standing on z = 0 inside the bigbird demo
volume (x in [-0.07, 0.13], y in [-0.1, 0.14], z in [0, 0.28]), ray-cast
into depth images (meters along the optical axis) of a pinhole camera on
a ring of poses 0.62-0.70 m away. Pixels that hit nothing read
BACKGROUND, beyond the mapper's 4 m range gate. The cast runs in torch,
every pose of a schedule in one call, on the device it is given.

Besides the scenes, the exact distance from a point to the scene's
surface (surface_distance_2d / _3d), which the map check reads.
"""
from __future__ import annotations

import numpy as np
import torch

class Lidar:
    """A scanner's geometry, from a configuration's `sensor`."""

    def __init__(self, sensor: dict):
        self.beams = sensor["beams"]
        self.half_fov = np.deg2rad(sensor["half_fov_deg"])
        self.max_range = sensor["max_range_m"]
        self.offset = np.asarray(sensor["mount_offset_m"], np.float64)


def _closed(*pts):
    p = np.asarray(pts, np.float64)
    return np.stack([p, np.roll(p, -1, axis=0)], axis=1)


def _polygon(cx, cy, r, n, phase=0.0):
    a = phase + 2 * np.pi * np.arange(n) / n
    return _closed(*np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1))


def floor_plan() -> np.ndarray:
    """Wall segments [S, 2, 2] of an office-like floor: outer walls, two
    interior walls with a door, a box, a pillar and a triangular crate."""
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
    """A 4.6 x 3.8 m room with a box (the tests' tiny scene)."""
    return np.concatenate([
        _closed((-2.33, -1.87), (2.27, -1.87), (2.27, 1.93), (-2.33, 1.93)),
        _closed((0.73, 0.53), (1.37, 0.53), (1.37, 1.17), (0.73, 1.17)),
    ], axis=0)


PLANS = {"floor": floor_plan, "room": room_plan}


def path_poses(waypoints, n: int) -> np.ndarray:
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


def pose6(x, y, heading) -> np.ndarray:
    """[tx, ty, R00, R10, R01, R11] (column-major rotation)."""
    c, s = np.cos(heading), np.sin(heading)
    return np.array([x, y, c, s, -s, c], np.float32)


def cast(walls: np.ndarray, origin, angles: np.ndarray,
         max_range: float) -> np.ndarray:
    """Distance from `origin` along each world angle to the nearest wall
    (max_range where nothing is hit)."""
    d = np.stack([np.cos(angles), np.sin(angles)], -1)[:, None, :]
    a = walls[None, :, 0, :] - np.asarray(origin)
    e = (walls[:, 1, :] - walls[:, 0, :])[None]

    def cross(u, v):
        return u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]

    den = cross(d, e)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = cross(a, e) / den
        u = cross(a, d) / den
    hit = (np.abs(den) > 1e-12) & (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    return np.min(np.where(hit, t, np.inf), axis=1).clip(max=max_range)


def scan_truth(walls: np.ndarray, poses: np.ndarray, lidar: Lidar):
    """Noise-free scans: (thetas [B] f32, ranges [F, B] f64 (the maximum
    range where nothing is hit), pose6 [F, 6] f32)."""
    thetas = np.linspace(-lidar.half_fov, lidar.half_fov,
                         lidar.beams).astype(np.float32)
    ranges, p6 = [], []
    for x, y, h in poses:
        p = pose6(x, y, h)
        rot = p[2:6].reshape(2, 2, order="F").astype(np.float64)
        origin = np.array([x, y]) + rot @ lidar.offset
        ranges.append(cast(walls, origin, thetas.astype(np.float64) + h,
                           lidar.max_range))
        p6.append(p)
    return thetas, np.asarray(ranges), np.asarray(p6)


def noisy_scans(thetas, ranges, p6, noise: float, rng, lidar: Lidar):
    """Frames [(thetas, ranges f32, pose6)] with Gaussian range noise of
    `noise` m on the beams that hit something."""
    hit = ranges < lidar.max_range
    r = np.where(hit, ranges + noise * rng.standard_normal(ranges.shape),
                 lidar.max_range).astype(np.float32)
    return [(thetas, r[i], p6[i]) for i in range(len(p6))]


def hit_points_2d(thetas, ranges, p6, lidar: Lidar) -> np.ndarray:
    """World points [K, 2] of the noise-free hits of every beam."""
    out = []
    for r, p in zip(ranges, p6):
        rot = p[2:6].reshape(2, 2, order="F").astype(np.float64)
        hit = r < lidar.max_range
        loc = np.stack([r * np.cos(thetas), r * np.sin(thetas)], -1)[hit]
        out.append((loc + lidar.offset) @ rot.T
                   + p[:2].astype(np.float64))
    return np.concatenate(out) if out else np.zeros((0, 2))


def grid_2d(x0, x1, y0, y1, intv: float) -> np.ndarray:
    """The gazebo demo evaluation grid (demo_gpisMap.m:29-35) over
    (x0, x1) x (y0, y1) at intv: 49,551 points at the demo's values."""
    xs = np.arange(x0 + intv, x1 - intv / 2, intv, dtype=np.float32)
    ys = np.arange(y0 + intv, y1 - intv / 2, intv, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], -1)


def surface_distance_2d(walls: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Distance [K] from each point to the nearest wall segment."""
    p = np.asarray(pts, np.float64)[:, None, :]
    a, b = walls[None, :, 0, :], walls[None, :, 1, :]
    e = b - a
    t = np.clip(np.sum((p - a) * e, -1) / np.sum(e * e, -1), 0.0, 1.0)
    d = p - (a + t[..., None] * e)
    return np.sqrt(np.min(np.sum(d * d, -1), axis=1))


# ---- 3D: an object in the bigbird demo volume --------------------------
BOX = ((-0.0437, -0.0713, 0.0), (0.0361, 0.0089, 0.1693))
CYLINDER = (0.0731, 0.0787, 0.0347, 0.0, 0.2213)   # cx, cy, r, z0, z1
RING_CENTER = (0.03, 0.02)
LOOK_AT_Z = 0.11
BACKGROUND = 5.0          # depth of a pixel that hits nothing (> 4 m)


def ring_poses(n: int) -> np.ndarray:
    """n camera poses [n, 12] = [t(3), R column-major(9)] (R world-from-
    camera: x right, y down, z forward) on a ring around the object at
    alternating radii (0.62 / 0.70 m) and heights (0.18 to 0.42 m), each
    looking at the object's middle."""
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
    lo = o.new_tensor(BOX[0])
    hi = o.new_tensor(BOX[1])
    t1 = (lo - o) / d
    t2 = (hi - o) / d
    tmin = torch.amax(torch.minimum(t1, t2), -1)
    tmax = torch.amin(torch.maximum(t1, t2), -1)
    return torch.where((tmax >= tmin) & (tmin > 0), tmin, torch.inf)


def _hit_cylinder(o, d):
    cx, cy, r, z0, z1 = CYLINDER
    ox, oy, oz = o[..., 0] - cx, o[..., 1] - cy, o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - r * r
    disc = b * b - 4.0 * a * c
    ts = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    zs = oz + ts * dz
    t = torch.where((disc >= 0) & (ts > 0) & (zs >= z0) & (zs <= z1),
                    ts, torch.inf)
    for zc in (z0, z1):
        tc = (zc - oz) / dz
        px = ox + tc * dx
        py = oy + tc * dy
        t = torch.minimum(t, torch.where(
            (tc > 0) & (px * px + py * py <= r * r), tc, torch.inf))
    return t


def depth_truth(poses: np.ndarray, cam, device) -> torch.Tensor:
    """Noise-free depth [F, H, W] (float64, meters along the optical
    axis; inf where nothing is hit) of the object from every pose, in
    one batched cast on `device`."""
    p = torch.as_tensor(np.asarray(poses, np.float64), device=device)
    eye = p[:, None, None, :3]
    rot = p[:, 3:12].reshape(-1, 3, 3).transpose(1, 2)   # column-major
    u = (torch.arange(cam.width, device=device, dtype=torch.float64)
         - cam.cx) / cam.fx
    v = (torch.arange(cam.height, device=device, dtype=torch.float64)
         - cam.cy) / cam.fy
    ray = torch.stack([u[None, :].expand(cam.height, cam.width),
                       v[:, None].expand(cam.height, cam.width),
                       torch.ones(cam.height, cam.width, device=device,
                                  dtype=torch.float64)], -1)
    d = torch.einsum("hwj,fij->fhwi", ray, rot)   # camera z = 1: t = depth
    return torch.minimum(_hit_box(eye, d), _hit_cylinder(eye, d))


def noisy_depth(truth: torch.Tensor, noise: float, quantum: float,
                gen: torch.Generator) -> torch.Tensor:
    """Depth images [F, H, W] float32: the truth with Gaussian noise of
    `noise` m from `gen`, rounded to the depth images' quantum (0.1 mm
    for bigbird's); misses read BACKGROUND."""
    hit = torch.isfinite(truth)
    n = torch.randn(truth.shape, generator=gen, device=truth.device,
                    dtype=torch.float64)
    t = torch.round((truth + noise * n) * (1.0 / quantum)) * quantum
    return torch.where(hit, t, BACKGROUND).to(torch.float32)


def hit_points_3d(truth: torch.Tensor, poses: np.ndarray, cam,
                  skip: int) -> torch.Tensor:
    """World points [K, 3] (float64) of the noise-free hits of every
    `skip`-th pixel row and column of every frame."""
    dev = truth.device
    p = torch.as_tensor(np.asarray(poses, np.float64), device=dev)
    rows = torch.arange(0, cam.height, skip, device=dev)
    cols = torch.arange(0, cam.width, skip, device=dev)
    z = truth[:, rows][:, :, cols]                       # [F, h, w]
    u = (cols.to(torch.float64) - cam.cx) / cam.fx
    v = (rows.to(torch.float64) - cam.cy) / cam.fy
    loc = torch.stack([u[None, None, :] * z, v[None, :, None] * z, z], -1)
    rot = p[:, 3:12].reshape(-1, 3, 3).transpose(1, 2)
    world = torch.einsum("fhwj,fij->fhwi", loc, rot) + p[:, None, None, :3]
    return world[torch.isfinite(z)]


def grid_3d(x, y, z, intv: float) -> np.ndarray:
    """The bigbird demo volume (demo_gpisMap3.m:37-38): 21 x 25 x 29 =
    15,225 points at 0.01 m at the demo's bounds."""
    axes = [np.arange(a0, a1 + intv / 2, intv, dtype=np.float32)
            for a0, a1 in (x, y, z)]
    xg, yg, zg = np.meshgrid(*axes)
    return np.stack([xg.reshape(-1), yg.reshape(-1), zg.reshape(-1)], -1)


def surface_distance_3d(pts: torch.Tensor) -> torch.Tensor:
    """Distance [K] from each point to the surface of the box or the
    cylinder, whichever is nearer (float64)."""
    p = pts.to(torch.float64)
    lo, hi = p.new_tensor(BOX[0]), p.new_tensor(BOX[1])
    c = 0.5 * (lo + hi)
    h = 0.5 * (hi - lo)
    q = torch.abs(p - c) - h
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.amax(q, -1), max=0.0)
    d_box = torch.abs(outside + inside)
    cx, cy, r, z0, z1 = CYLINDER
    rad = torch.hypot(p[:, 0] - cx, p[:, 1] - cy) - r
    zc, zh = 0.5 * (z0 + z1), 0.5 * (z1 - z0)
    dz = torch.abs(p[:, 2] - zc) - zh
    q2 = torch.stack([rad, dz], -1)
    d_cyl = torch.abs(torch.linalg.norm(torch.clamp(q2, min=0.0), dim=-1)
                      + torch.clamp(torch.amax(q2, -1), max=0.0))
    return torch.minimum(d_box, d_cyl)
