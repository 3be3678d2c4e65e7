"""Loaders for the bundled reference datasets (the port's own numpy copy
of gpismap_tpu/datasets.py; the loaders return numpy arrays, as the
mappers' update() takes them).

2D: gazebo1.mat LiDAR sequence (reference: matlab/demo_gpisMap.m:26,42-51)
3D: bigbird "detergent" depth frames (reference: matlab/demo_gpisMap3.m:28-47)
"""
from __future__ import annotations

import os
from typing import Iterator, NamedTuple

import numpy as np

# the data root: $GPISMAP_DATA, else data/ at the checkout's root
REFERENCE_DATA = os.environ.get(
    "GPISMAP_DATA",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "data"))


class Scan2D(NamedTuple):
    frame: int
    thetas: np.ndarray   # [B]
    ranges: np.ndarray   # [B]
    pose: np.ndarray     # [6] = [tx, ty, R00, R10, R01, R11] column-major


def load_gazebo(path: str | None = None):
    """gazebo1.mat: poses [N, 3] (x, y, phi), thetas [B], ranges [N, B]."""
    import scipy.io as sio
    path = path or os.path.join(REFERENCE_DATA, "2D", "gazebo1.mat")
    d = sio.loadmat(path)
    return (np.asarray(d["poses"], np.float32),
            np.asarray(d["thetas"], np.float32).reshape(-1),
            np.asarray(d["ranges"], np.float32))


def gazebo_frames(path: str | None = None, init_frame: int = 101,
                  skip: int = 100) -> Iterator[Scan2D]:
    """The demo frame schedule (demo_gpisMap.m:37-40): frames
    initframe : skip : last, 1-based inclusive."""
    poses, thetas, ranges = load_gazebo(path)
    n = poses.shape[0]
    last = ((n - init_frame) // skip) * skip + init_frame
    for nf in range(init_frame, last + 1, skip):
        i = nf - 1                      # matlab 1-based
        x, y, phi = poses[i]
        c, s = np.cos(phi), np.sin(phi)
        pose = np.array([x, y, c, s, -s, c], np.float32)
        yield Scan2D(frame=nf, thetas=thetas, ranges=ranges[i], pose=pose)


def gazebo_test_grid(intv: float = 0.1):
    """The demo evaluation grid (demo_gpisMap.m:29-35):
    meshgrid over [xmin+intv : intv : xmax-intv] x [ymin+intv : ...]."""
    xs = np.arange(-5 + intv, 20 - intv / 2, intv, dtype=np.float32)
    ys = np.arange(-15 + intv, 5 - intv / 2, intv, dtype=np.float32)
    xg, yg = np.meshgrid(xs, ys)
    return np.stack([xg.reshape(-1), yg.reshape(-1)], -1), xg.shape


class Depth3D(NamedTuple):
    frame: int
    cam_id: int          # 1-based camera id (bigbird tables)
    depth: np.ndarray    # [H, W] float32 meters
    pose: np.ndarray     # [12] = [t(3), R column-major(9)]


def bigbird_frames(path: str | None = None) -> Iterator[Depth3D]:
    """The 3D demo schedule (demo_gpisMap3.m:33-47): FrameNums
    [93:3:359, 3:3:90] stepped by 3 with cams cycling [1 2 3 4 3 2];
    depth PNGs are 0.1 mm units."""
    from PIL import Image
    path = path or os.path.join(REFERENCE_DATA, "3D", "bigbird_detergent")
    poses = np.loadtxt(os.path.join(path, "pose", "poses.txt"),
                       dtype=np.float32)
    frame_nums = list(range(93, 360, 3)) + list(range(3, 91, 3))
    cam_ids = ([1, 2, 3, 4, 3, 2] * 30)
    count = 0
    for k in range(0, len(frame_nums), 3):
        frm = frame_nums[k]
        cam = cam_ids[count]
        count += 1
        f = os.path.join(path, "masked_depth", f"frame{frm}_cam{cam}.png")
        depth = np.asarray(Image.open(f), np.float32) * 1e-4
        row = poses[count - 1]
        # matlab: T = reshape(row, 4, 4) column-major; R = T(1:3,1:3);
        # t = T(4,1:3)' — pose to mex is [t' reshape(R,1,[])]
        t = np.array([row[3], row[7], row[11]], np.float32)
        r_colmajor = np.array([row[0], row[1], row[2],
                               row[4], row[5], row[6],
                               row[8], row[9], row[10]], np.float32)
        yield Depth3D(frame=frm, cam_id=cam, depth=depth,
                      pose=np.concatenate([t, r_colmajor]))


def bigbird_test_grid(intv: float = 0.01):
    """The 3D demo volume grid (demo_gpisMap3.m:37-38)."""
    xs = np.arange(-0.07, 0.13 + intv / 2, intv, dtype=np.float32)
    ys = np.arange(-0.1, 0.14 + intv / 2, intv, dtype=np.float32)
    zs = np.arange(0.0, 0.28 + intv / 2, intv, dtype=np.float32)
    xg, yg, zg = np.meshgrid(xs, ys, zs)
    return (np.stack([xg.reshape(-1), yg.reshape(-1), zg.reshape(-1)], -1),
            xg.shape)
