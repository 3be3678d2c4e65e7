"""Batched Cholesky and L^-1 of the cluster-GP systems: the CUDA kernels
and their plain PyTorch versions.

Port of gpismap_tpu/ops/pallas_chol.py (chol_pallas, linv_pallas):

  chol(k)   k [B, n, n] SPD float32 -> lower L, L L^T = k, exact zeros
            above the diagonal
  linv(l)   l [B, n, n] lower triangular -> L^-1, exact zeros above the
            diagonal

n <= 1280 (the cluster systems are n = 96, 192 or 384 in 2D and 320,
640 or 1280 in 3D). Each runs
the plain version for a CPU tensor and the hand-written kernel
(csrc/chol.cu) for a CUDA tensor; there is no fallback from one to the
other. On a non-positive pivot the kernel clamps it to sqrt(1e-30), as
the Pallas kernel does, where torch.linalg.cholesky raises. One chol() of
a CUDA tensor is a blocked factorization of several kernel launches on
the current stream (cuda_launches_per_chol), and one linv() the inverses
of the 64-wide diagonal blocks merged level by level
(cuda_launches_per_linv).

On a CUDA tensor both run through torch.autograd.Functions (_Chol,
_Linv) whose forward is the kernel and whose backward is closed-form in
plain matrix products (chol_backward, linv_backward), as the JAX
package's autodiff emits them outside any Pallas kernel. chol's backward
takes L^-1 from the linv kernel. A clamped pivot needs no special case:
the backward is the closed form at the clamped factor, whose inverse is
then huge, where torch.linalg would have raised in the forward.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from .. import _native

_SRC = os.path.join(_native.PKG_DIR, "csrc", "chol.cu")
MAX_N = 1280
_LOCK = threading.Lock()
_LIB: Optional[ct.CDLL] = None
# launches of the CUDA kernels by chol and linv (not of the plain versions)
chol_launches = 0
linv_launches = 0


def build_library() -> str:
    """Compile the kernel library if it is missing or stale; returns the
    compiler's output (ptxas register/shared-memory report; "" when up to
    date)."""
    return _native.build(_SRC, "libchol.so", _native.NVCC)[1]


def _lib() -> ct.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path, _ = _native.build(_SRC, "libchol.so", _native.NVCC)
            lib = ct.CDLL(path)
            lib.chol_launch.restype = lib.linv_launch.restype = ct.c_int
            lib.chol_launch.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                        ct.c_int, ct.c_void_p]
            # l, w, scratch, b, n, stream
            lib.linv_launch.argtypes = [ct.c_void_p, ct.c_void_p,
                                        ct.c_void_p, ct.c_int, ct.c_int,
                                        ct.c_void_p]
            for name in ("chol_smem", "linv_smem", "linv_scratch"):
                getattr(lib, name).restype = ct.c_longlong
                getattr(lib, name).argtypes = [ct.c_int]
            for name in ("chol_launch_count", "linv_launch_count"):
                getattr(lib, name).restype = ct.c_int
                getattr(lib, name).argtypes = [ct.c_int]
            lib.chol_error_string.restype = ct.c_char_p
            lib.chol_error_string.argtypes = [ct.c_int]
            _LIB = lib
        return _LIB


def cuda_launches_per_chol(n: int) -> int:
    """CUDA kernel launches that one chol() of a CUDA tensor with matrices
    of size n issues (the blocked factorization: an init kernel, then a
    panel and a trailing-update kernel per 64-wide panel that has rows
    below it). chol_launches counts calls of chol(), not these."""
    return int(_lib().chol_launch_count(n))


def cuda_launches_per_linv(n: int) -> int:
    """CUDA kernel launches that one linv() of a CUDA tensor with matrices
    of size n issues (the 64-wide diagonal inverses, then two products per
    merge level: 1 + 2 ceil(log2(ceil(n / 64)))). linv_launches counts
    calls of linv(), not these."""
    return int(_lib().linv_launch_count(n))


def chol_reference(k: torch.Tensor) -> torch.Tensor:
    """Plain version of chol: torch.linalg.cholesky (lower)."""
    return torch.linalg.cholesky(k)


def linv_reference(l: torch.Tensor) -> torch.Tensor:
    """Plain version of linv: the triangular solve L X = I."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye.expand(l.shape), upper=False)


def _launch(name: str, x: torch.Tensor):
    """Checks x and runs kernel `name` ("chol" or "linv") on it into a new
    tensor. Returns (the tensor, whether the kernel was launched: an empty
    batch launches nothing)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.ndim != 3 or x.shape[1] != x.shape[2] or x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 [B, n, n], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input is not contiguous")
    b, n, _ = x.shape
    if n > MAX_N:
        raise ValueError(f"{name}: n={n} > {MAX_N}")
    out = torch.empty_like(x)
    if b == 0 or n == 0:
        return out, False
    lib = _lib()
    ptrs = [x.data_ptr(), out.data_ptr()]
    if name == "linv":
        # the merge products' T = C A^-1; freed into the caching allocator
        # on this stream, so its next use waits for these kernels
        scratch = torch.empty(b * int(lib.linv_scratch(n)),
                              dtype=torch.float32, device=x.device)
        ptrs.append(scratch.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(*ptrs, b, n, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.chol_error_string(rc).decode()}); a block needs "
            f"{getattr(lib, f'{name}_smem')(n)} B of shared memory at n={n}")
    return out, True


def chol_backward(l: torch.Tensor, linv_l: torch.Tensor,
                  grad_l: torch.Tensor) -> torch.Tensor:
    """Gradient of the loss with respect to the SPD input k of l = chol(k):
    with X = L^-1 (linv_l) and Phi the lower triangle with its diagonal
    halved, A = X^T Phi(L^T grad_l) X, symmetrized as (A + A^T) / 2 (the
    closed form torch.linalg.cholesky's autograd uses). Plain matrix
    products, on any device."""
    p = torch.tril(l.mT @ grad_l)
    p = p - 0.5 * torch.diag_embed(torch.diagonal(p, dim1=-2, dim2=-1))
    a = linv_l.mT @ p @ linv_l
    return 0.5 * (a + a.mT)


def linv_backward(x: torch.Tensor, grad_x: torch.Tensor) -> torch.Tensor:
    """Gradient of the loss with respect to the lower-triangular input l
    of x = linv(l) = L^-1: tril(-X^T grad_x X^T). Plain matrix products,
    on any device."""
    return torch.tril(-x.mT @ grad_x @ x.mT)


class _Chol(torch.autograd.Function):
    """chol on a CUDA tensor: the kernel forward, chol_backward with L^-1
    from the linv kernel."""

    @staticmethod
    def forward(ctx, k):
        global chol_launches
        out, launched = _launch("chol", k)
        chol_launches += launched
        ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_l):
        (l,) = ctx.saved_tensors
        return chol_backward(l, linv(l), grad_l)


class _Linv(torch.autograd.Function):
    """linv on a CUDA tensor: the kernel forward, linv_backward."""

    @staticmethod
    def forward(ctx, l):
        global linv_launches
        out, launched = _launch("linv", l)
        linv_launches += launched
        ctx.save_for_backward(out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_x):
        (x,) = ctx.saved_tensors
        return linv_backward(x, grad_x)


def chol(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of k [B, n, n]: the CUDA
    kernel through _Chol for a CUDA tensor (counted in chol_launches), the
    plain version for a CPU tensor."""
    if k.device.type == "cpu":
        return chol_reference(k)
    return _Chol.apply(k)


def linv(l: torch.Tensor) -> torch.Tensor:
    """L^-1 of each lower-triangular matrix of l [B, n, n]: the CUDA
    kernel through _Linv for a CUDA tensor (counted in linv_launches), the
    plain version for a CPU tensor."""
    if l.device.type == "cpu":
        return linv_reference(l)
    return _Linv.apply(l)
