"""The 2D frame's observation-GP stages on the card: one CUDA kernel for
the re-evaluation of the map's nodes and the new measurements.

frame_2d launches csrc/obsgp1d_frame.cu over k nodes and n beams (either
may be empty) against the frame's 1D observation GP and returns one
packed float32 buffer: NODE_WORDS words a node, then BEAM_WORDS a beam,
in the layout models/mapper2d.py splits (unpack_frame_2d). It takes CUDA
tensors only and launches the kernel or raises; the plain versions of
what it computes are mapper2d.reeval_2d_reference and
newmeas_2d_reference, which mapper2d runs for CPU tensors. The JAX
package has no kernel here: it computes these stages in XLA.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import _native

_SRC = os.path.join(_native.PKG_DIR, "csrc", "obsgp1d_frame.cu")
_NAME = "libobsgp1d_frame.so"
# nvcc fuses no product into a sum here: the kernel rounds each step as
# the plain versions' torch operations do (csrc/obsgp1d_frame.cu)
_COMPILER = _native.NVCC + ["-fmad=false"]
_LOCK = threading.Lock()
_LIB: Optional[ct.CDLL] = None
# words of the packed output per node and per beam (the kernel's too)
NODE_WORDS = 10
BEAM_WORDS = 7
# the kernel's largest group size: one warp lane per group sample
MAX_M = 32
# launches of the CUDA kernel by frame_2d
launches = 0


def build_library() -> str:
    """Compile the kernel library if it is missing or stale; returns the
    compiler's output (ptxas register report; "" when up to date)."""
    return _native.build(_SRC, _NAME, _COMPILER)[1]


def _lib() -> ct.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = _native.build(_SRC, _NAME, _COMPILER)
            lib = ct.CDLL(path)
            p, i, f, ll = ct.c_void_p, ct.c_int, ct.c_float, ct.c_longlong
            lib.obsgp1d_frame_launch.restype = i
            lib.obsgp1d_frame_launch.argtypes = (
                [p] * 4 + [ll] * 3 + [p] * 5 + [i, i, f, f]   # obs GP
                + [p, p, ll, ll]                              # pose
                + [f] * 10 + [i]                              # parameters
                + [p] * 5 + [i]                               # nodes
                + [p] * 5 + [i]                               # beams
                + [p, p])                                     # out, stream
            for name in ("obsgp1d_frame_node_words",
                         "obsgp1d_frame_beam_words"):
                getattr(lib, name).restype = i
            lib.obsgp1d_frame_error_string.restype = ct.c_char_p
            lib.obsgp1d_frame_error_string.argtypes = [i]
            if (lib.obsgp1d_frame_node_words() != NODE_WORDS
                    or lib.obsgp1d_frame_beam_words() != BEAM_WORDS):
                raise RuntimeError(f"{_NAME}: the kernel's packed layout "
                                   f"differs from this module's")
            _LIB = lib
        return _LIB


def _recip(x: float) -> float:
    """1 / x in float32, as PyTorch's CUDA division of a float32 tensor by
    a Python number computes its multiplier."""
    return float(np.float32(1.0) / np.float32(x))


def _check(name: str, t: torch.Tensor, dtype, shape, dev,
           strided: bool = False) -> None:
    if t.device != dev:
        raise ValueError(f"frame_2d: {name} is on {t.device}, not {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"frame_2d: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if not strided and not t.is_contiguous():
        raise ValueError(f"frame_2d: {name} is not contiguous")


def frame_2d(obs, nodes, beams, tr: torch.Tensor, rot: torch.Tensor, mp,
             op, iters: int, occ_stop: float) -> torch.Tensor:
    """The kernel over the frame's nodes and beams.

    obs: the frame's ObsGP1DState (models/obsgp.py; group size <= 32);
    nodes: (pos [k, 2], grad [k, 2], pos_sig [k], grad_sig [k],
    valid [k] bool) or None; beams: (valid [n] bool, theta [n], rng [n],
    xy_local [n, 2], xy_global [n, 2]) or None; tr [2] (None without
    nodes) and rot [2, 2] the pose (world-from-sensor rotation; any
    strides); mp, op the MapperParam and ObsGPParam; iters and occ_stop
    the re-localization's step cap and occupancy stop. Every tensor on
    one CUDA device, float32 or bool, contiguous (obs.linv and rot may
    have any strides). Returns the packed float32 buffer
    [k NODE_WORDS + n BEAM_WORDS], filled by one launch on the current
    stream (none when k + n == 0)."""
    global launches
    dev = obs.x.device
    if dev.type != "cuda":
        raise ValueError(f"frame_2d: unsupported device {dev}")
    f32, b8 = torch.float32, torch.bool
    g, m = obs.x.shape[0], obs.x.shape[1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"frame_2d: group size {m} is not in [1, {MAX_M}]")
    for name, t, dt, shape, strided in (
            ("obs.x", obs.x, f32, (g, m, 1), False),
            ("obs.valid", obs.valid, b8, (g, m), False),
            ("obs.alpha", obs.alpha, f32, (g, m), False),
            ("obs.linv", obs.linv, f32, (g, m, m), True),
            ("obs.trained", obs.trained, b8, (g,), False),
            ("obs.bounds", obs.bounds, f32, (g + 1,), False),
            ("obs.liml", obs.liml, f32, (), False),
            ("obs.limr", obs.limr, f32, (), False),
            ("obs.any_trained", obs.any_trained, b8, (), False),
            ("rot", rot, f32, (2, 2), True)):
        _check(name, t, dt, shape, dev, strided)
    k = 0 if nodes is None else nodes[0].shape[0]
    n = 0 if beams is None else beams[0].shape[0]
    if nodes is not None:
        _check("tr", tr, f32, (2,), dev)
        for name, t, dt, shape in zip(
                ("pos", "grad", "pos_sig", "grad_sig", "node valid"), nodes,
                (f32, f32, f32, f32, b8), ((k, 2), (k, 2), (k,), (k,), (k,))):
            _check(name, t, dt, shape, dev)
    if beams is not None:
        for name, t, dt, shape in zip(
                ("beam valid", "theta", "rng", "xy_local", "xy_global"),
                beams, (b8, f32, f32, f32, f32),
                ((n,), (n,), (n,), (n, 2), (n, 2))):
            _check(name, t, dt, shape, dev)
    out = torch.empty(k * NODE_WORDS + n * BEAM_WORDS, dtype=f32, device=dev)
    if k + n == 0:
        return out
    lib = _lib()
    ptrs = [[None] * 5 if ts is None else [t.data_ptr() for t in ts]
            for ts in (nodes, beams)]
    with torch.cuda.device(dev):
        rc = lib.obsgp1d_frame_launch(
            obs.x.data_ptr(), obs.valid.data_ptr(), obs.alpha.data_ptr(),
            obs.linv.data_ptr(), *obs.linv.stride(), obs.trained.data_ptr(),
            obs.bounds.data_ptr(), obs.liml.data_ptr(), obs.limr.data_ptr(),
            obs.any_trained.data_ptr(), g, m, _recip(op.scale),
            1.0 + op.noise, None if tr is None else tr.data_ptr(),
            rot.data_ptr(), *rot.stride(), mp.delx, _recip(mp.delx),
            _recip(3.0), mp.obs_var_thre, mp.min_position_noise,
            mp.min_grad_noise, mp.map_noise_param, mp.sensor_offset[0],
            mp.sensor_offset[1], occ_stop, iters, *ptrs[0], k, *ptrs[1], n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"frame_2d: kernel launch failed: CUDA error {rc} "
            f"({lib.obsgp1d_frame_error_string(rc).decode()}) at k={k}, "
            f"n={n}, g={g}, m={m}")
    launches += 1
    return out
