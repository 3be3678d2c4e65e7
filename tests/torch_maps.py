"""The tiny maps that several of the port's test files build, made in
one place: tests/test_torch_slice.py's room (2D) and
tests/test_torch_slice3d.py's object frames through the 64x48 camera
(3D), at those files' capacities, for the JAX package and the port.

built() keeps each map it makes for the rest of the process, so the
files that share a map (and the tests of one file) replay its frames
once per pytest worker; its callers only read the maps or change their
query-side caches (the factor cache, the candidate table)."""
import functools

import torch_scenes
from gpismap_tpu.api import GPisMap2D as JaxMapper2D
from gpismap_tpu.api3d import GPisMap3D as JaxMapper3D
from gpismap_tpu.config import CameraParam as JaxCamera
from gpismap_tpu.config import CapacityParam as JaxCapacity
from gpismap_tpu_torch import CameraParam, CapacityParam, GPisMap2D, GPisMap3D
from test_torch_slice import TINY as TINY_2D
from test_torch_slice3d import CAM
from test_torch_slice3d import TINY as TINY_3D


@functools.lru_cache(maxsize=None)
def frames(dim: int, n: int):
    """n frames of the 2D room (181 beams) or of the 3D object."""
    if dim == 2:
        return torch_scenes.room_frames(n, 181)
    return torch_scenes.object_frames(n, CameraParam(**CAM))


def make(dim: int, jax: bool = False, mode=None, **cap):
    """A fresh tiny mapper of either package: mode is the 2D
    strict_reeval flag's "strict" or the 3D reeval_mode (None: the
    default)."""
    if dim == 2:
        caps = dict(TINY_2D, **cap)
        strict = mode == "strict"
        return (JaxMapper2D(cap=JaxCapacity(**caps), strict_reeval=strict)
                if jax else GPisMap2D(cap=CapacityParam(**caps),
                                      strict_reeval=strict, device="cpu"))
    caps = dict(TINY_3D, **cap)
    return (JaxMapper3D(cap=JaxCapacity(**caps), camera=JaxCamera(**CAM),
                        reeval_mode=mode) if jax else
            GPisMap3D(cap=CapacityParam(**caps), camera=CameraParam(**CAM),
                      reeval_mode=mode, device="cpu"))


@functools.lru_cache(maxsize=None)
def built(dim: int, n: int, jax: bool = False, mode=None):
    """make(dim, jax, mode) after frames(dim, n), kept for the process."""
    m = make(dim, jax, mode)
    for f in frames(dim, n):
        m.update(*f)
    return m
