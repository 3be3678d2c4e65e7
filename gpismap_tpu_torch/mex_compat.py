"""Command-string front end mirroring the reference mex API.

Port of gpismap_tpu/mex_compat.py: a stateful global and string dispatch
('update' | 'test' | 'reset' and, in 3D, 'setCamera' | 'getAllPoints';
reference: mex/mexGPisMap.cpp:40-130, mex/mexGPisMap3.cpp:43-160),
returning wall-clock seconds for update/test, with the same returns and
shapes. The map is created on the CUDA card unless the keyword-only
`device` of the command that creates it says otherwise; later commands
ignore it.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .api import GPisMap2D
from .api3d import GPisMap3D

_gpm2: Optional[GPisMap2D] = None
_gpm3: Optional[GPisMap3D] = None


def gpismap(command: str, *args, device="cuda"):
    """2D dispatch (mexGPisMap.cpp:38-130).

    'update', thetas, ranges, pose6 -> elapsed seconds
    'test', x [2, N] or [N, 2]     -> (res [6, N], elapsed seconds)
    'reset'
    """
    global _gpm2
    if command == "update":
        if _gpm2 is None:
            _gpm2 = GPisMap2D(device=device)
        thetas, ranges, pose = args
        t0 = time.time()
        _gpm2.update(thetas, ranges, pose)
        return time.time() - t0
    if command == "test":
        if _gpm2 is None:
            raise RuntimeError("Create the map first! (mexGPisMap.cpp:88)")
        (x,) = args
        x = np.asarray(x, np.float32)
        if x.ndim == 2 and x.shape[0] == 2 and x.shape[1] != 2:
            x = x.T
        t0 = time.time()
        res = _gpm2.test(x)
        return res.T, time.time() - t0
    if command == "reset":
        if _gpm2 is not None:
            _gpm2.reset()
            _gpm2 = None
        return None
    raise ValueError(f"unknown command {command!r}")


def gpismap3(command: str, *args, device="cuda"):
    """3D dispatch (mexGPisMap3.cpp:43-160).

    'setCamera', cam_id, family('bigbird'|'ycb')
    'update', depth [H, W], pose12 -> elapsed seconds
    'test', x [3, N] or [N, 3]     -> (res [8, N], elapsed seconds)
    'getAllPoints'                 -> pos [N, 3]
    'reset'
    """
    global _gpm3
    if command == "setCamera":
        if _gpm3 is None:
            _gpm3 = GPisMap3D(device=device)
        cam_id = args[0]
        family = args[1] if len(args) > 1 else "bigbird"
        _gpm3.set_camera(cam_id, "ycb" if str(family).lower() == "ycb"
                         else "bigbird")
        return None
    if command == "update":
        if _gpm3 is None:
            _gpm3 = GPisMap3D(device=device)
        depth, pose = args
        t0 = time.time()
        _gpm3.update(depth, pose)
        return time.time() - t0
    if command == "test":
        if _gpm3 is None:
            raise RuntimeError("Create the map first!")
        (x,) = args
        x = np.asarray(x, np.float32)
        if x.ndim == 2 and x.shape[0] == 3 and x.shape[1] != 3:
            x = x.T
        t0 = time.time()
        res = _gpm3.test(x)
        return res.T, time.time() - t0
    if command == "getAllPoints":
        if _gpm3 is None:
            return np.zeros((0, 3), np.float32)
        return _gpm3.get_all_points()
    if command == "reset":
        if _gpm3 is not None:
            _gpm3.reset()
            _gpm3 = None
        return None
    raise ValueError(f"unknown command {command!r}")
