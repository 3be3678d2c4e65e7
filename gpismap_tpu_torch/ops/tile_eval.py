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
(_TileEval): the forward is the kernel; the backward is the
vector-Jacobian product of the plain version in three more CUDA kernels
(csrc/tile_eval_backward.cu, a library of its own, launched by
_launch_backward and counted in `launches_backward`).
tile_eval_vjp_reference is that closed-form VJP in plain PyTorch (the
kernels' twin), and tile_eval_backward the VJP by autograd through the
plain version recomputed (the twin's oracle); no card path calls either.
The JAX package has no VJP for the Pallas kernel: its differentiable
evaluation runs the XLA path, which is what the plain version is.
scale, val_const and grad_const may be floats or 0-d tensors; a tensor
gets its gradient. A cotangent that autograd leaves undefined (an
output that does not reach the loss) is not materialized: with no
cotangent of the variances the backward forms no Z and no dL.

bf16=True is the Pallas kernel's bf16 variant (tile_eval_pallas(bf16=),
the JAX package's GPISMAP_PALLAS_BF16 query path): the variance product
V = L^-1 K* takes bfloat16 multiplicands, rounded to nearest even, with
f32 accumulation; K*, the mean (f, g) and colsum(V^2) stay f32, so f and
g are bitwise those of bf16=False. On CUDA tensors it launches the bf16
kernel (csrc/tile_eval_bf16.cu, a library of its own, counted in
`launches_bf16`, not in `launches`), which runs the product over each
slot's kept 16-row stages only (kept_stages; tile_eval_packed_reference
is that packing in plain PyTorch). It is forward-only, as the Pallas
kernel is (no VJP): a call that would record a gradient raises
NotImplementedError.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from .. import _native
from . import kernels

_SRC = os.path.join(_native.PKG_DIR, "csrc", "tile_eval.cu")
_SRC_BF16 = os.path.join(_native.PKG_DIR, "csrc", "tile_eval_bf16.cu")
_SRC_BWD = os.path.join(_native.PKG_DIR, "csrc", "tile_eval_backward.cu")
# the K* code every kernel includes
_DEPS = (os.path.join(_native.PKG_DIR, "csrc", "tile_kstar.cuh"),)
_LOCK = threading.Lock()
_LIB: Optional[ct.CDLL] = None
_LIB_BF16: Optional[ct.CDLL] = None
_LIB_BWD: Optional[ct.CDLL] = None
# launches of the CUDA kernel by tile_eval (not of the plain version):
# the f32 instance, and the bf16 variant's apart
launches = 0
launches_bf16 = 0
# CUDA launches of the backward kernels by _launch_backward, in all and
# by kernel ("z", "kstar", "linv")
launches_backward = 0
launches_backward_by_kernel = {"z": 0, "kstar": 0, "linv": 0}


def build_library() -> str:
    """Compile the f32 kernel's library if it is missing or stale; returns
    the compiler's output (ptxas register/shared-memory report; "" when
    up to date)."""
    return _native.build(_SRC, "libtile_eval.so", _native.NVCC, _DEPS)[1]


def build_library_bf16() -> str:
    """build_library for the bf16 kernel's library."""
    return _native.build(_SRC_BF16, "libtile_eval_bf16.so", _native.NVCC,
                         _DEPS)[1]


def build_library_backward() -> str:
    """build_library for the backward kernels' library."""
    return _native.build(_SRC_BWD, "libtile_eval_backward.so", _native.NVCC,
                         _DEPS)[1]


def bind_backward(path: str) -> ct.CDLL:
    """Load a built backward library and declare its C entry points."""
    lib = ct.CDLL(path)
    p, i, f = ct.c_void_p, ct.c_int, ct.c_float
    lib.tile_bwd_z_launch.argtypes = [p] * 13 + [i] * 4 + [f, p]
    lib.tile_bwd_kstar_launch.argtypes = (
        [p] * 14 + [i] * 2 + [p] * 3 + [i] * 4 + [f, p])
    lib.tile_bwd_linv_launch.argtypes = [p] * 13 + [i] * 5 + [f, p]
    for name in ("tile_bwd_z_launch", "tile_bwd_kstar_launch",
                 "tile_bwd_linv_launch"):
        getattr(lib, name).restype = ct.c_int
    lib.tile_bwd_smem_bytes.restype = ct.c_longlong
    lib.tile_bwd_smem_bytes.argtypes = [ct.c_int] * 4
    lib.tile_bwd_error_string.restype = ct.c_char_p
    lib.tile_bwd_error_string.argtypes = [ct.c_int]
    return lib


def bind(path: str, bf16: bool) -> ct.CDLL:
    """Load a built kernel library and declare its C entry points (the
    f32 kernel's, or with bf16 the bf16 kernel's)."""
    lib = ct.CDLL(path)
    if bf16:
        lib.tile_eval_bf16_launch.restype = ct.c_int
        lib.tile_eval_bf16_launch.argtypes = (
            [ct.c_void_p] * 13 + [ct.c_int] * 6 + [ct.c_float] * 3
            + [ct.c_void_p])
        lib.tile_eval_bf16_smem_bytes.restype = ct.c_longlong
        lib.tile_eval_bf16_smem_bytes.argtypes = [ct.c_int] * 3
        lib.tile_eval_bf16_error_string.restype = ct.c_char_p
        lib.tile_eval_bf16_error_string.argtypes = [ct.c_int]
    else:
        lib.tile_eval_launch.restype = ct.c_int
        lib.tile_eval_launch.argtypes = (
            [ct.c_void_p] * 11 + [ct.c_int] * 5 + [ct.c_float] * 3
            + [ct.c_void_p])
        lib.tile_eval_smem_bytes.restype = ct.c_longlong
        lib.tile_eval_smem_bytes.argtypes = [ct.c_int, ct.c_int]
        lib.tile_eval_error_string.restype = ct.c_char_p
        lib.tile_eval_error_string.argtypes = [ct.c_int]
    return lib


def _lib() -> ct.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = bind(_native.build(_SRC, "libtile_eval.so", _native.NVCC,
                                      _DEPS)[0], bf16=False)
        return _LIB


def _lib_bf16() -> ct.CDLL:
    global _LIB_BF16
    with _LOCK:
        if _LIB_BF16 is None:
            _LIB_BF16 = bind(_native.build(
                _SRC_BF16, "libtile_eval_bf16.so", _native.NVCC, _DEPS)[0],
                bf16=True)
        return _LIB_BF16


def _lib_backward() -> ct.CDLL:
    global _LIB_BWD
    with _LOCK:
        if _LIB_BWD is None:
            _LIB_BWD = bind_backward(_native.build(
                _SRC_BWD, "libtile_eval_backward.so", _native.NVCC,
                _DEPS)[0])
        return _LIB_BWD


def _kstar_and_mean(tile_seg, xt, alpha, gradflag, valid, qt, scale):
    """(active tiles, their cells, K* [A, MP, T(1+d)], alpha^T K*
    [A, T(1+d)]) of the plain version."""
    act = torch.nonzero(tile_seg >= 0).reshape(-1)
    seg = tile_seg[act].long()
    ks = kernels.matern32_deriv_cross_cov(
        xt[seg].transpose(-1, -2), gradflag[seg] > 0.5, valid[seg] > 0.5,
        qt[act].transpose(-1, -2), scale)            # [A, MP, T(1+d)]
    return act, seg, ks, torch.einsum('amc,am->ac', ks, alpha[seg])


def _outputs(qt, d, act, res, vs, val_const, grad_const):
    """(f, g, vf, vg) of all tiles from the active tiles' means `res` and
    sums of squares `vs` [A, T(1+d)]; inactive tiles give 0."""
    nt, _, t = qt.shape
    f = qt.new_zeros((nt, t))
    g = qt.new_zeros((nt, d, t))
    vf = qt.new_zeros((nt, t))
    vg = qt.new_zeros((nt, d, t))
    f[act] = res[:, :t]
    g[act] = res[:, t:].reshape(-1, d, t)
    vf[act] = val_const - vs[:, :t]
    vg[act] = grad_const - vs[:, t:].reshape(-1, d, t)
    return f, g, vf, vg


def tile_eval_reference(tile_seg: torch.Tensor, linv: torch.Tensor,
                        xt: torch.Tensor, alpha: torch.Tensor,
                        gradflag: torch.Tensor, valid: torch.Tensor,
                        qt: torch.Tensor, d: int, scale, val_const,
                        grad_const, bf16: bool = False):
    """Plain PyTorch version of the tile kernel (any d): the same math
    through ops/kernels.py on the active tiles; inactive tiles give 0.
    bf16: both multiplicands of the variance product rounded to bfloat16
    (nearest even), then multiplied in f32, as the Pallas kernel's bf16
    branch does (a product of two bf16 values is exact in f32)."""
    act, seg, ks, res = _kstar_and_mean(tile_seg, xt, alpha, gradflag,
                                        valid, qt, scale)
    if bf16:
        v = torch.matmul(linv[seg].to(torch.bfloat16).float(),
                         ks.to(torch.bfloat16).float())
    else:
        v = torch.matmul(linv[seg], ks)
    return _outputs(qt, d, act, res, torch.sum(v * v, dim=-2), val_const,
                    grad_const)


def kept_stages(valid: torch.Tensor, gradflag: torch.Tensor, d: int):
    """The 16-row stages of K* (and of L^-1's rows and columns) that the
    bf16 kernel computes: (stages [S, NS] int32, count [S] int32), NS =
    ceil(MP / 16), MP = M (1 + d). Row r of MP is kept if it is an f row
    (r < M) of a valid node, or a gradient row of a node whose
    gradflag * valid is set; a stage is kept if any of its rows is. Each
    slot's kept stages come first in stages[s], ascending; the rest is
    -1. A stage with no kept row adds nothing: its K* rows are zero, and
    its rows and columns of L^-1 are the identity's. Torch code on the
    tensors' device, without a host sync."""
    s, m = valid.shape
    mp = m * (1 + d)
    ns = -(-mp // 16)
    vm = valid > 0.5
    gm = vm & (gradflag > 0.5)
    rows = torch.cat([vm] + [gm] * d, dim=1)           # [S, MP]
    rows = torch.nn.functional.pad(rows, (0, 16 * ns - mp))
    keep = rows.reshape(s, ns, 16).any(dim=-1)         # [S, NS]
    count = keep.sum(dim=-1, dtype=torch.int32)
    order = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)
    idx = torch.arange(ns, device=valid.device)
    stages = torch.where(idx < count[:, None], order, -1)
    return stages.to(torch.int32), count


def tile_eval_packed_reference(tile_seg: torch.Tensor, linv: torch.Tensor,
                               xt: torch.Tensor, alpha: torch.Tensor,
                               gradflag: torch.Tensor, valid: torch.Tensor,
                               qt: torch.Tensor, d: int, scale, val_const,
                               grad_const):
    """The bf16 evaluation as the bf16 kernel packs it: the variance
    product runs over the kept stages only (kept_stages), on the rows and
    columns of L^-1 and the rows of K* that they hold, with rows past MP
    zero; f and g as the plain version computes them. It gives
    tile_eval_reference(bf16=True)'s outputs up to the order of the f32
    sums: the rows and columns it leaves out add exact zeros."""
    act, seg, ks, res = _kstar_and_mean(tile_seg, xt, alpha, gradflag,
                                        valid, qt, scale)
    stages, count = kept_stages(valid, gradflag, d)
    mp, ns = linv.shape[-1], stages.shape[-1]
    rows = (16 * stages.clamp(min=0).long()[:, :, None]
            + torch.arange(16, device=linv.device))      # [S, NS, 16]
    keep = ((torch.arange(ns, device=linv.device) < count[:, None])[:, :, None]
            & (rows < mp)).reshape(linv.shape[0], -1)
    rows = torch.where(keep, rows.reshape(keep.shape), 0)
    cell = torch.arange(linv.shape[0], device=linv.device)[:, None, None]
    lp = torch.where(keep[:, :, None] & keep[:, None, :],
                     linv[cell, rows[:, :, None], rows[:, None, :]], 0.0)
    kp = torch.where(keep[seg][:, :, None],
                     torch.gather(ks, 1, rows[seg][:, :, None].expand(
                         -1, -1, ks.shape[-1])), 0.0)
    v = torch.matmul(lp[seg].to(torch.bfloat16).float(),
                     kp.to(torch.bfloat16).float())
    return _outputs(qt, d, act, res, torch.sum(v * v, dim=-2), val_const,
                    grad_const)


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
            # an output that depends on none of them (f and g on linv) is
            # left out
            used = [(o, g[tiles]) for o, g in zip(res, grads)
                    if o.requires_grad]
            gs = torch.autograd.grad(
                [o for o, _ in used], [x for _, x in wrt],
                [g for _, g in used], allow_unused=True)
        for (i, _), g in zip(wrt, gs):
            if g is None:
                continue
            if i < 4:
                out[i].index_add_(0, rows[i], g)
            else:
                out[i] += g
    return tuple(out)


def _cotangent_columns(grads, nt: int, d: int, t: int, like):
    """(gF, gV): the cotangents of (f, g) and of (vf, vg) as [NT, T(1+d)]
    in K*'s column order (f block, then the d gradient blocks); None where
    both of a pair are None, zeros for one None of a pair."""
    def cols(a, b):
        if a is None and b is None:
            return None
        a = like.new_zeros((nt, t)) if a is None else a
        b = like.new_zeros((nt, d, t)) if b is None else b
        return torch.cat([a[:, None, :], b], dim=1).reshape(nt, (1 + d) * t)
    return cols(grads[0], grads[1]), cols(grads[2], grads[3])


def _vjp_plan(tile_seg, qt, d: int, inputs, grads, needs):
    """What the VJP of the tile evaluation computes (twin and kernels
    alike): (want, out, gF, gV, z_on, chain). want[i]: input i of inputs
    (linv, xt, alpha, qt, scale, val_const, grad_const) gets a gradient
    (needed and a tensor); out: zeros for each, the constants' already
    summed over the active tiles' columns; gF / gV from
    _cotangent_columns; z_on: Z = (L^-1 K*) diag(gV) is needed (a
    cotangent of the variances, and linv, xt, qt or scale wanted); chain:
    dK* is chained into its entries (xt, qt or scale wanted)."""
    want = [n and isinstance(x, torch.Tensor) for n, x in zip(needs, inputs)]
    out = [torch.zeros_like(x) if w else None for x, w in zip(inputs, want)]
    nt, _, t = qt.shape
    gfc, gvc = _cotangent_columns(grads, nt, d, t, qt)
    for i, gi in ((5, 2), (6, 3)):
        if want[i] and grads[gi] is not None:
            g = grads[gi].reshape(nt, -1, t)
            out[i] = torch.where((tile_seg >= 0)[:, None, None], g,
                                 0.0).sum().reshape(inputs[i].shape).to(
                                     inputs[i].dtype)
    z_on = gvc is not None and any(want[i] for i in (0, 1, 3, 4))
    chain = any(want[i] for i in (1, 3, 4))
    return want, out, gfc, gvc, z_on, chain


def _entry_grads(dd, r, e, inv_r, a, rb: int, cb: int, d: int):
    """(dK*/dDelta_l for l < d, dK*/da) of the K* entries of row block rb
    and column block cb, unmasked, on per-pair arrays: Delta = x - q (dd),
    r, e = exp(-a r), inv_r (0 at r = 0). csrc/tile_kstar.cuh:kstar_grad
    has the same formulas."""
    a2e = a * a * e
    if rb == 0 and cb == 0:
        return [-a2e * dd[l] for l in range(d)], -a * r * r * e
    if rb == 0 or cb == 0:
        i = (cb if rb == 0 else rb) - 1
        sgn = 1.0 if rb == 0 else -1.0
        gd = [sgn * a2e * ((1.0 if l == i else 0.0)
                           - a * dd[i] * dd[l] * inv_r) for l in range(d)]
        return gd, sgn * a * dd[i] * e * (2.0 - a * r)
    i, j = rb - 1, cb - 1
    p = dd[i] * dd[j] * inv_r
    w = (1.0 if i == j else 0.0) - a * p
    gd = [-a * a2e * (((dd[j] if l == i else 0.0) + (dd[i] if l == j else 0.0))
                      * inv_r - p * dd[l] * inv_r * inv_r + w * dd[l] * inv_r)
          for l in range(d)]
    return gd, a * e * ((2.0 - a * r) * w - a * p)


def _kstar_chain(g, xs, qs, vm, gm, a, d: int):
    """dK* g [A, MP, T(1+d)] chained through each K* entry of the tiles
    with support xs [A, M, d], masks vm / gm [A, M] (valid, gradflag *
    valid) and queries qs [A, T, d]: (d xs [A, M, d], d qs [A, T, d],
    d a)."""
    na, m = xs.shape[:2]
    t = qs.shape[1]
    dd = [xs[:, :, None, l] - qs[:, None, :, l] for l in range(d)]
    r = torch.sqrt(sum(x * x for x in dd))
    e = torch.exp(-a * r)
    inv_r = torch.where(r > 0, 1.0 / torch.where(r > 0, r, 1.0), 0.0)
    g5 = g.reshape(na, 1 + d, m, 1 + d, t)
    gdel = [torch.zeros_like(r) for _ in range(d)]
    ga = r.new_zeros(())
    for rb in range(1 + d):
        msk = (vm if rb == 0 else gm)[:, :, None]
        for cb in range(1 + d):
            gd, gae = _entry_grads(dd, r, e, inv_r, a, rb, cb, d)
            gm_ = g5[:, rb, :, cb, :] * msk
            for l in range(d):
                gdel[l] = gdel[l] + gm_ * gd[l]
            ga = ga + torch.sum(gm_ * gae)
    gdel = torch.stack(gdel, dim=-1)                  # [A, M, T, d]
    return gdel.sum(2), -gdel.sum(1), ga


def tile_eval_vjp_reference(tile_seg: torch.Tensor, linv: torch.Tensor,
                            xt: torch.Tensor, alpha: torch.Tensor,
                            gradflag: torch.Tensor, valid: torch.Tensor,
                            qt: torch.Tensor, d: int, scale, val_const,
                            grad_const, grads, needs=(True,) * 7):
    """Vector-Jacobian product of the tile evaluation in closed form, the
    backward kernels' plain twin (csrc/tile_eval_backward.cu: the same
    decomposition and the same chain formulas): tile_eval_backward's
    arguments and results, and grads entries may be None (no cotangent).
    Per active tile t of cell s, with gF / gV the cotangents of (f, g) /
    (vf, vg) in K*'s column order, Z = (L^-1 K*) diag(gV):
      d val_const = sum gV over the f columns, d grad_const over the
      gradient columns; d alpha_s = sum_t K* gF; dL_s = -2 sum_t Z K*^T;
      dK* = alpha gF^T - 2 L^-T Z, chained through each K* entry
      (_entry_grads) into dq, dx and d a; d scale = -(a / scale) d a.
    Z is formed only with a cotangent of the variances and when linv, xt,
    qt or scale needs a gradient. Runs in chunks of active tiles that
    keep _BACKWARD_CHUNK_BYTES of L^-1 copies."""
    want, out, gfc, gvc, z_on, chain = _vjp_plan(
        tile_seg, qt, d, (linv, xt, alpha, qt, scale, val_const, grad_const),
        grads, needs)
    if not (z_on or (gfc is not None and (chain or want[2]))):
        return tuple(out)
    sc = float(scale)
    a = kernels._SQRT3 / sc
    mp = linv.shape[-1]
    per = max(1, _BACKWARD_CHUNK_BYTES // (mp * mp * linv.element_size()))
    act = torch.nonzero(tile_seg >= 0).reshape(-1)
    da = qt.new_zeros(())
    for s0 in range(0, act.numel(), per):
        tiles = act[s0:s0 + per]
        seg = tile_seg[tiles].long()
        vm, gm = valid[seg] > 0.5, gradflag[seg] > 0.5
        xs, qs = xt[seg].transpose(-1, -2), qt[tiles].transpose(-1, -2)
        ks = kernels.matern32_deriv_cross_cov(xs, gm, vm, qs, sc)
        gf = gfc[tiles] if gfc is not None else ks.new_zeros(
            (tiles.numel(), ks.shape[-1]))
        g = alpha[seg][:, :, None] * gf[:, None, :]
        if z_on:
            lc = linv[seg]
            z = torch.matmul(lc, ks) * gvc[tiles][:, None, :]
            if want[0]:
                out[0].index_add_(0, seg, -2.0 * torch.matmul(z, ks.mT))
            if chain:
                g = g - 2.0 * torch.matmul(lc.mT, z)
        if want[2]:
            out[2].index_add_(0, seg, torch.einsum('amc,ac->am', ks, gf))
        if chain:
            vmf = vm.to(ks.dtype)
            gx, gq, ga = _kstar_chain(g, xs, qs, vmf, vmf * gm.to(ks.dtype),
                                      a, d)
            if want[1]:
                out[1].index_add_(0, seg, gx.transpose(-1, -2))
            if want[3]:
                out[3][tiles] = gq.transpose(-1, -2)
            da = da + ga
    if want[4]:
        out[4] = (-(a / sc) * da).reshape(scale.shape).to(scale.dtype)
    return tuple(out)


class _TileEval(torch.autograd.Function):
    """tile_eval on CUDA tensors: the kernel forward, the backward
    kernels (_launch_backward) for the gradients."""

    @staticmethod
    def forward(ctx, tile_seg, linv, xt, alpha, gradflag, valid, qt, d,
                scale, val_const, grad_const):
        out = _launch(tile_seg, linv, xt, alpha, gradflag, valid, qt, d,
                      float(scale), float(val_const), float(grad_const),
                      False)
        hyper = (scale, val_const, grad_const)
        ctx.d = d
        # an output that does not reach the loss gets None, not zeros: the
        # backward then skips the work that only it needs
        ctx.set_materialize_grads(False)
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
        g_linv, g_xt, g_alpha, g_qt, g_s, g_vc, g_gc = _launch_backward(
            *saved[:7], ctx.d, *hyper, (g_f, g_g, g_vf, g_vg), needs)
        return (None, g_linv, g_xt, g_alpha, None, None, g_qt, None, g_s,
                g_vc, g_gc)


def tile_eval(tile_seg: torch.Tensor, linv: torch.Tensor, xt: torch.Tensor,
              alpha: torch.Tensor, gradflag: torch.Tensor,
              valid: torch.Tensor, qt: torch.Tensor, d: int, scale,
              val_const, grad_const, bf16: bool = False):
    """Evaluate all tiles: the CUDA kernel through _TileEval for CUDA
    tensors, the plain version for CPU tensors. The module's `launches`
    counts kernel launches. bf16=True: the bf16 variance variant (the
    plain version's bf16 branch on the CPU, the kernel's bf16 instance on
    CUDA, counted in `launches_bf16`); forward-only, so it raises
    NotImplementedError when grad mode is on and an input requires
    grad."""
    args = (tile_seg, linv, xt, alpha, gradflag, valid, qt)
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"tile_eval: tensors on several devices {devices}")
    dev = devices.pop()
    if bf16 and torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad
            for x in args + (scale, val_const, grad_const)):
        raise NotImplementedError(
            "tile_eval(bf16=True) is forward-only, as the Pallas kernel's "
            "bf16 variant is (no VJP); differentiate the f32 evaluation "
            "(bf16=False)")
    if dev.type == "cpu":
        return tile_eval_reference(*args, d=d, scale=scale,
                                   val_const=val_const, grad_const=grad_const,
                                   bf16=bf16)
    if dev.type != "cuda":
        raise ValueError(f"tile_eval: unsupported device {dev}")
    if bf16:
        return _launch(*args, d, float(scale), float(val_const),
                       float(grad_const), True)
    return _TileEval.apply(*args, d, scale, val_const, grad_const)


def _check_args(args, d: int, grads=()):
    """Raises ValueError unless the tile op's CUDA arguments (tile_seg,
    linv, xt, alpha, gradflag, valid, qt), and the cotangents of (f, g,
    vf, vg) where given (None entries are skipped), have the kernels'
    types and shapes and are contiguous. Returns (NT, S, M, T)."""
    tile_seg, linv, xt, alpha, gradflag, valid, qt = args
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
    for name, g in zip(("g_f", "g_g", "g_vf", "g_vg"), grads):
        if g is not None:
            shapes[name] = (g, (nt, t) if name in ("g_f", "g_vf")
                            else (nt, d, t), torch.float32)
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"tile_eval: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {dtype} {shape}")
        if not x.is_contiguous() and not name.startswith("g_"):
            raise ValueError(f"tile_eval: {name} is not contiguous")
    if mp != m * (1 + d):
        raise ValueError(f"tile_eval: MP={mp} != M(1+d)={m * (1 + d)}")
    return nt, s, m, t


def _launch(tile_seg, linv, xt, alpha, gradflag, valid, qt, d: int,
            scale: float, val_const: float, grad_const: float, bf16: bool):
    """Checks the CUDA tensors and runs the kernel (its bf16 instance with
    bf16) into new outputs (f, g, vf, vg); counts the launch in
    `launches` (`launches_bf16`)."""
    global launches, launches_bf16
    args = (tile_seg, linv, xt, alpha, gradflag, valid, qt)
    dev = qt.device
    nt, s, m, t = _check_args(args, d)
    f = torch.empty((nt, t), dtype=torch.float32, device=dev)
    g = torch.empty((nt, d, t), dtype=torch.float32, device=dev)
    vf = torch.empty((nt, t), dtype=torch.float32, device=dev)
    vg = torch.empty((nt, d, t), dtype=torch.float32, device=dev)
    if nt == 0 or t == 0:
        return f, g, vf, vg
    outs = (f.data_ptr(), g.data_ptr(), vf.data_ptr(), vg.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            lib = _lib_bf16()
            stages, count = kept_stages(valid, gradflag, d)
            # the shared memory holds the largest kept cell's K*: one
            # scalar read back
            nk_cap = int(count.max()) if s else 0
            rc = lib.tile_eval_bf16_launch(
                *(x.data_ptr() for x in args), stages.data_ptr(),
                count.data_ptr(), *outs, nt, s, d, m, t, nk_cap, scale,
                val_const, grad_const, stream)
            err = lib.tile_eval_bf16_error_string
            need = lib.tile_eval_bf16_smem_bytes(d, m, nk_cap)
        else:
            lib = _lib()
            rc = lib.tile_eval_launch(
                *(x.data_ptr() for x in args), *outs, nt, s, d, m, t, scale,
                val_const, grad_const, stream)
            err = lib.tile_eval_error_string
            need = lib.tile_eval_smem_bytes(d, m)
    if rc != 0:
        raise RuntimeError(
            f"tile_eval{' bf16' if bf16 else ''} kernel launch failed: CUDA "
            f"error {rc} ({err(rc).decode()}); a block needs {need} B of "
            f"shared memory at d={d}, M={m}")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return f, g, vf, vg


def _chunks(cell_bytes, cap: int):
    """[(first, end)) runs of consecutive cells whose bytes sum to at most
    cap; a cell larger than cap runs alone."""
    out, first, acc = [], 0, 0
    for j, b in enumerate(cell_bytes):
        if j > first and acc + b > cap:
            out.append((first, j))
            first, acc = j, 0
        acc += b
    if len(cell_bytes):
        out.append((first, len(cell_bytes)))
    return out


def _launch_backward(tile_seg, linv, xt, alpha, gradflag, valid, qt,
                     d: int, scale, val_const, grad_const, grads,
                     needs=(True,) * 7):
    """_TileEval's backward on CUDA tensors: the backward kernels
    (csrc/tile_eval_backward.cu) compute tile_eval_vjp_reference's
    results (same arguments; grads entries may be None). Each CUDA launch
    is counted in `launches_backward` and `launches_backward_by_kernel`.

    One read back (the tile segments and the kept-stage counts) plans the
    work: the active tiles grouped by cell, in chunks of whole cells
    whose scratch Z (16 kept-stage rows by T(1+d) floats per tile) keeps
    within _BACKWARD_CHUNK_BYTES. Per chunk, with a cotangent of the
    variances: the Z kernel when linv, xt, qt or scale needs a gradient,
    the dL kernel when linv does; then the K* kernel when xt, alpha, qt
    or scale does. Zero cotangents are found on the device: per
    16-column stage, gv_nz says whether any gV is nonzero, and the
    kernels skip what needs none. The K* kernel's per-block partials
    (d alpha and dx per row of MP, d a) are summed to cells in a fixed
    order by torch reductions over fixed shapes, so the gradients are
    bitwise the same in two runs."""
    args = (tile_seg, linv, xt, alpha, gradflag, valid, qt)
    nt, _, m, t = _check_args(args, d, grads)
    dev, mp, nc = qt.device, linv.shape[-1], t * (1 + d)
    want, out, gfc, gvc, z_on, chain = _vjp_plan(
        tile_seg, qt, d, (linv, xt, alpha, qt, scale, val_const, grad_const),
        grads, needs)
    k_on = chain or want[2]
    if not (z_on or (gfc is not None and k_on)) or nt == 0 or t == 0:
        return tuple(out)
    if gfc is None:
        gfc = qt.new_zeros((nt, nc))
    nst = -(-nc // 16)
    if gvc is None:
        gv_nz = torch.zeros((nt, nst), dtype=torch.int32, device=dev)
    else:
        gv_nz = (torch.nn.functional.pad(gvc, (0, 16 * nst - nc))
                 .reshape(nt, nst, 16) != 0).any(-1).to(torch.int32)
    stages, counts = kept_stages(valid, gradflag, d)
    host = torch.cat([tile_seg, counts]).cpu().numpy()
    ts, cnt = host[:nt], host[nt:]
    act = np.flatnonzero(ts >= 0)
    tiles = act[np.argsort(ts[act], kind="stable")]    # grouped by cell
    cells, first, ntile = np.unique(ts[tiles], return_index=True,
                                    return_counts=True)
    rows = 16 * cnt[ts[tiles]].astype(np.int64)        # Z rows per tile
    zb = 4 * nc * np.add.reduceat(rows, first) if z_on else np.zeros(
        len(cells), np.int64)
    lib = _lib_backward()
    sc = float(scale)
    a = float(np.float32(kernels._SQRT3) / np.float32(sc))
    n_cb = -(-nc // 128)
    dqc = torch.zeros((nt, 1 + d, d, t), dtype=torch.float32, device=dev) \
        if chain else None
    da = torch.zeros((), dtype=torch.float32, device=dev)

    def run(name, fn, *a_):
        global launches_backward
        with torch.cuda.device(dev):
            rc = fn(*a_, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            kernel = {"z": 2, "kstar": 3, "linv": 4}[name]
            raise RuntimeError(
                f"tile_eval backward: the {name} kernel's launch failed: CUDA "
                f"error {rc} ({lib.tile_bwd_error_string(rc).decode()}); a "
                f"block needs {lib.tile_bwd_smem_bytes(kernel, d, m, t)} B "
                f"of shared memory at d={d}, M={m}, T={t}")
        launches_backward += 1
        launches_backward_by_kernel[name] += 1

    common = (tile_seg.data_ptr(), linv.data_ptr(), xt.data_ptr())
    masks = (gradflag.data_ptr(), valid.data_ptr(), qt.data_ptr(),
             stages.data_ptr(), counts.data_ptr())
    for c0, c1 in _chunks(zb, _BACKWARD_CHUNK_BYTES):
        t0 = first[c0]
        t1 = first[c1] if c1 < len(cells) else len(tiles)
        n_ct, n_cell = t1 - t0, c1 - c0
        z_off = np.concatenate([[0], np.cumsum(rows[t0:t1] * nc)[:-1]])
        starts = np.append(first[c0:c1], t1) - t0
        ints = torch.as_tensor(np.concatenate(
            [tiles[t0:t1], cells[c0:c1], starts]).astype(np.int32),
            device=dev)
        tl, cl = ints[:n_ct], ints[n_ct:n_ct + n_cell]
        cs = ints[n_ct + n_cell:]
        zo = torch.as_tensor(z_off.astype(np.int64), device=dev)
        zbuf = torch.empty(int(rows[t0:t1].sum()) * nc if z_on else 0,
                           dtype=torch.float32, device=dev)
        if z_on:
            run("z", lib.tile_bwd_z_launch, tl.data_ptr(), zo.data_ptr(),
                *common, *masks, gvc.data_ptr(), gv_nz.data_ptr(),
                zbuf.data_ptr(), n_ct, d, m, t, sc)
            if want[0]:
                n_ot = -(-int(16 * cnt[cells[c0:c1]].max()) // 128)
                run("linv", lib.tile_bwd_linv_launch, cl.data_ptr(),
                    cs.data_ptr(), tl.data_ptr(), zo.data_ptr(),
                    xt.data_ptr(), *masks, gv_nz.data_ptr(),
                    zbuf.data_ptr(), out[0].data_ptr(), n_cell, max(n_ot, 1),
                    d, m, t, sc)
        if not k_on:
            continue
        nb = n_ct * n_cb
        part = torch.zeros((nb, mp, 1 + d), dtype=torch.float32, device=dev)
        da_part = torch.zeros(nb, dtype=torch.float32, device=dev)
        run("kstar", lib.tile_bwd_kstar_launch, tl.data_ptr(), zo.data_ptr(),
            *common, alpha.data_ptr(), *masks, gfc.data_ptr(),
            gv_nz.data_ptr(), zbuf.data_ptr(), int(z_on), int(chain),
            dqc.data_ptr() if chain else 0, part.data_ptr(),
            da_part.data_ptr(), n_ct, d, m, t, sc)
        # per tile (its column blocks), then per cell (its tiles, padded
        # to the chunk's most with a zero row), in a fixed order
        per_tile = torch.cat([part.reshape(n_ct, n_cb, mp, 1 + d).sum(1),
                              part.new_zeros((1, mp, 1 + d))])
        nmax = int(ntile[c0:c1].max())
        pad = np.full((n_cell, nmax), n_ct, np.int64)
        for j in range(n_cell):
            pad[j, :ntile[c0 + j]] = np.arange(first[c0 + j] - t0,
                                               first[c0 + j] - t0
                                               + ntile[c0 + j])
        per_cell = per_tile[torch.as_tensor(pad, device=dev)].sum(1)
        cl_long = cl.long()
        if want[2]:
            out[2][cl_long] = per_cell[..., 0]
        if want[1]:
            out[1][cl_long] = per_cell[..., 1:].reshape(
                n_cell, 1 + d, m, d).sum(1).transpose(1, 2)
        da = da + da_part.sum()
    if want[3]:
        out[3] = dqc.sum(1)
    if want[4]:
        out[4] = (-(a / sc) * da).reshape(scale.shape).to(scale.dtype)
    return tuple(out)
