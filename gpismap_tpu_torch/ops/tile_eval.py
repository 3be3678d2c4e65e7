"""Cluster-GP tile evaluation of the map query: the CUDA kernel and its
plain PyTorch version.

Port of gpismap_tpu/ops/pallas_tile.py (tile_eval_pallas), with the same
signature and layouts:

  tile_seg   [NT] int32 compact cell per tile; -1 = inactive tile
             (skipped — its outputs are left unspecified)
  linv       [S, MP, MP] per-cell L^-1, lower triangular
  xt         [S, D, M] axis-major support positions
  alpha      [S, MP]
  gradflag / valid  [S, M] float32 0/1
  qt         [NT, D, T] axis-major tile queries
  -> (f [NT, T], g [NT, D, T], vf [NT, T], vg [NT, D, T])

`tile_eval` runs the plain version for CPU tensors and the hand-written
kernel (csrc/tile_eval.cu, d = 2 or 3) for CUDA tensors; there is no
fallback from one to the other.

On CUDA tensors the kernel runs inside a torch.autograd.Function
(_TileEval): the forward is the kernel; the backward (tile_eval_backward)
recomputes the plain version at the saved inputs and returns its
vector-Jacobian product, in chunks of active tiles so that the per-tile
copies of L^-1 and K* it holds stay bounded. The JAX package has no VJP
for the Pallas kernel either: its differentiable evaluation runs the
XLA path, which is what the plain version is. scale, val_const and
grad_const may be floats or 0-d tensors; a tensor gets its gradient.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .. import _native
from . import kernels

_SRC = os.path.join(_native.PKG_DIR, "csrc", "tile_eval.cu")
_LOCK = threading.Lock()
_LIB: Optional[ct.CDLL] = None
# launches of the CUDA kernel by tile_eval (not of the plain version)
launches = 0


def build_library() -> str:
    """Compile the kernel library if it is missing or stale; returns the
    compiler's output (ptxas register/shared-memory report; "" when up to
    date)."""
    return _native.build(_SRC, "libtile_eval.so", _native.NVCC)[1]


def _lib() -> ct.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = _native.build(_SRC, "libtile_eval.so", _native.NVCC)
            lib = ct.CDLL(path)
            lib.tile_eval_launch.restype = ct.c_int
            lib.tile_eval_launch.argtypes = (
                [ct.c_void_p] * 11 + [ct.c_int] * 5 + [ct.c_float] * 3
                + [ct.c_void_p])
            lib.tile_eval_smem_bytes.restype = ct.c_longlong
            lib.tile_eval_smem_bytes.argtypes = [ct.c_int, ct.c_int]
            lib.tile_eval_error_string.restype = ct.c_char_p
            lib.tile_eval_error_string.argtypes = [ct.c_int]
            _LIB = lib
        return _LIB


def tile_eval_reference(tile_seg: torch.Tensor, linv: torch.Tensor,
                        xt: torch.Tensor, alpha: torch.Tensor,
                        gradflag: torch.Tensor, valid: torch.Tensor,
                        qt: torch.Tensor, d: int, scale, val_const,
                        grad_const):
    """Plain PyTorch version of the tile kernel (any d): the same math
    through ops/kernels.py on the active tiles; inactive tiles give 0."""
    nt, _, t = qt.shape
    act = torch.nonzero(tile_seg >= 0).reshape(-1)
    seg = tile_seg[act].long()
    ks = kernels.matern32_deriv_cross_cov(
        xt[seg].transpose(-1, -2), gradflag[seg] > 0.5, valid[seg] > 0.5,
        qt[act].transpose(-1, -2), scale)            # [A, MP, T(1+d)]
    res = torch.einsum('amc,am->ac', ks, alpha[seg])
    v = torch.matmul(linv[seg], ks)
    vs = torch.sum(v * v, dim=-2)
    f = qt.new_zeros((nt, t))
    g = qt.new_zeros((nt, d, t))
    vf = qt.new_zeros((nt, t))
    vg = qt.new_zeros((nt, d, t))
    f[act] = res[:, :t]
    g[act] = res[:, t:].reshape(-1, d, t)
    vf[act] = val_const - vs[:, :t]
    vg[act] = grad_const - vs[:, t:].reshape(-1, d, t)
    return f, g, vf, vg


# per-tile copies of L^-1 that one chunk of tile_eval_backward's
# recompute may hold (the plain version gathers one per active tile)
_BACKWARD_CHUNK_BYTES = 1 << 28


def tile_eval_backward(tile_seg: torch.Tensor, linv: torch.Tensor,
                       xt: torch.Tensor, alpha: torch.Tensor,
                       gradflag: torch.Tensor, valid: torch.Tensor,
                       qt: torch.Tensor, d: int, scale, val_const,
                       grad_const, grads, needs=(True,) * 7):
    """Vector-Jacobian product of the tile evaluation: the gradients of
    sum(grads[i] * outputs[i]) (outputs (f, g, vf, vg)) with respect to
    (linv, xt, alpha, qt, scale, val_const, grad_const), by autograd
    through tile_eval_reference recomputed at these inputs. An entry is
    None where `needs` (same order) is False, and for scale, val_const
    or grad_const when it is not a tensor; gradflag and valid are 0/1
    masks and get none. Inactive tiles (tile_seg < 0) contribute
    nothing, whatever their upstream gradients hold. The active tiles run
    in chunks of as many as keep _BACKWARD_CHUNK_BYTES of L^-1 copies,
    each on only the cells it reads."""
    mp = linv.shape[-1]
    tiles_per_chunk = max(1, _BACKWARD_CHUNK_BYTES
                          // (mp * mp * linv.element_size()))
    inputs = (linv, xt, alpha, qt, scale, val_const, grad_const)
    want = [n and isinstance(x, torch.Tensor) for n, x in zip(needs, inputs)]
    hyper = [h.detach().requires_grad_(w) if isinstance(h, torch.Tensor)
             else h for h, w in zip(inputs[4:], want[4:])]
    out = [torch.zeros_like(x) if w else None for x, w in zip(
        inputs[:4] + tuple(hyper), want)]
    act = torch.nonzero(tile_seg >= 0).reshape(-1)
    for s in range(0, act.numel(), tiles_per_chunk):
        tiles = act[s:s + tiles_per_chunk]
        cells, seg = torch.unique(tile_seg[tiles].long(),
                                  return_inverse=True)
        rows = (cells, cells, cells, tiles)
        leaves = [x[r].detach().requires_grad_(w)
                  for x, r, w in zip(inputs[:4], rows, want)]
        with torch.enable_grad():
            res = tile_eval_reference(
                seg.to(torch.int32), leaves[0], leaves[1], leaves[2],
                gradflag[cells], valid[cells], leaves[3], d, *hyper)
            wrt = [(i, x) for i, x in enumerate(leaves + hyper) if want[i]]
            gs = torch.autograd.grad(
                res, [x for _, x in wrt],
                [g[tiles] for g in grads], allow_unused=True)
        for (i, _), g in zip(wrt, gs):
            if g is None:
                continue
            if i < 4:
                out[i].index_add_(0, rows[i], g)
            else:
                out[i] += g
    return tuple(out)


class _TileEval(torch.autograd.Function):
    """tile_eval on CUDA tensors: the kernel forward, tile_eval_backward
    (the plain version's VJP, recomputed) for the gradients."""

    @staticmethod
    def forward(ctx, tile_seg, linv, xt, alpha, gradflag, valid, qt, d,
                scale, val_const, grad_const):
        out = _launch(tile_seg, linv, xt, alpha, gradflag, valid, qt, d,
                      float(scale), float(val_const), float(grad_const))
        hyper = (scale, val_const, grad_const)
        ctx.d = d
        # the floats; a tensor is saved and stands as None here
        ctx.hyper = [None if isinstance(h, torch.Tensor) else h
                     for h in hyper]
        ctx.save_for_backward(
            tile_seg, linv, xt, alpha, gradflag, valid, qt,
            *(h for h in hyper if isinstance(h, torch.Tensor)))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_f, g_g, g_vf, g_vg):
        saved = ctx.saved_tensors
        it = iter(saved[7:])
        hyper = [next(it) if h is None else h for h in ctx.hyper]
        needs = [ctx.needs_input_grad[i] for i in (1, 2, 3, 6, 8, 9, 10)]
        g_linv, g_xt, g_alpha, g_qt, g_s, g_vc, g_gc = tile_eval_backward(
            *saved[:7], ctx.d, *hyper, (g_f, g_g, g_vf, g_vg), needs)
        return (None, g_linv, g_xt, g_alpha, None, None, g_qt, None, g_s,
                g_vc, g_gc)


def tile_eval(tile_seg: torch.Tensor, linv: torch.Tensor, xt: torch.Tensor,
              alpha: torch.Tensor, gradflag: torch.Tensor,
              valid: torch.Tensor, qt: torch.Tensor, d: int, scale,
              val_const, grad_const):
    """Evaluate all tiles: the CUDA kernel through _TileEval for CUDA
    tensors, the plain version for CPU tensors. The module's `launches`
    counts kernel launches."""
    args = (tile_seg, linv, xt, alpha, gradflag, valid, qt)
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"tile_eval: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return tile_eval_reference(*args, d=d, scale=scale,
                                   val_const=val_const, grad_const=grad_const)
    if dev.type != "cuda":
        raise ValueError(f"tile_eval: unsupported device {dev}")
    return _TileEval.apply(*args, d, scale, val_const, grad_const)


def _launch(tile_seg, linv, xt, alpha, gradflag, valid, qt, d: int,
            scale: float, val_const: float, grad_const: float):
    """Checks the CUDA tensors and runs the kernel into new outputs
    (f, g, vf, vg); counts the launch in `launches`."""
    global launches
    args = (tile_seg, linv, xt, alpha, gradflag, valid, qt)
    dev = qt.device
    if d not in (2, 3):
        raise ValueError(f"tile_eval: the CUDA kernel takes d=2 or d=3, "
                         f"got {d}")
    nt, _, t = qt.shape
    s, mp, _ = linv.shape
    m = xt.shape[-1]
    shapes = {"tile_seg": (tile_seg, (nt,), torch.int32),
              "linv": (linv, (s, mp, mp), torch.float32),
              "xt": (xt, (s, d, m), torch.float32),
              "alpha": (alpha, (s, mp), torch.float32),
              "gradflag": (gradflag, (s, m), torch.float32),
              "valid": (valid, (s, m), torch.float32),
              "qt": (qt, (nt, d, t), torch.float32)}
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"tile_eval: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if not x.is_contiguous():
            raise ValueError(f"tile_eval: {name} is not contiguous")
    if mp != m * (1 + d):
        raise ValueError(f"tile_eval: MP={mp} != M(1+d)={m * (1 + d)}")
    lib = _lib()
    f = torch.empty((nt, t), dtype=torch.float32, device=dev)
    g = torch.empty((nt, d, t), dtype=torch.float32, device=dev)
    vf = torch.empty((nt, t), dtype=torch.float32, device=dev)
    vg = torch.empty((nt, d, t), dtype=torch.float32, device=dev)
    if nt == 0 or t == 0:
        return f, g, vf, vg
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tile_eval_launch(
            *(x.data_ptr() for x in args),
            f.data_ptr(), g.data_ptr(), vf.data_ptr(), vg.data_ptr(),
            nt, s, d, m, t, scale, val_const, grad_const, stream)
    if rc != 0:
        raise RuntimeError(
            f"tile_eval kernel launch failed: CUDA error {rc} "
            f"({lib.tile_eval_error_string(rc).decode()}); a block needs "
            f"{lib.tile_eval_smem_bytes(d, m)} B of shared memory at d={d}, "
            f"M={m}")
    launches += 1
    return f, g, vf, vg
