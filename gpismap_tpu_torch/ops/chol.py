"""Batched Cholesky and L^-1 of the cluster-GP systems: the CUDA kernels
and their plain PyTorch versions.

Port of gpismap_tpu/ops/pallas_chol.py (chol_pallas, linv_pallas):

  chol(k)   k [B, n, n] SPD float32 -> lower L, L L^T = k, exact zeros
            above the diagonal
  linv(l)   l [B, n, n] lower triangular -> L^-1, exact zeros above the
            diagonal

n <= 512 (the cluster systems are n = 96, 192 or 384 in 2D). Each runs
the plain version for a CPU tensor and the hand-written kernel
(csrc/chol.cu) for a CUDA tensor; there is no fallback from one to the
other. On a non-positive pivot the kernel clamps it to sqrt(1e-30), as
the Pallas kernel does, where torch.linalg.cholesky raises.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
from typing import Optional

import torch

from .. import _native

_SRC = os.path.join(_native.PKG_DIR, "csrc", "chol.cu")
MAX_N = 512
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
            for name in ("chol_launch", "linv_launch"):
                fn = getattr(lib, name)
                fn.restype = ct.c_int
                fn.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
                               ct.c_void_p]
            for name in ("chol_smem", "linv_smem"):
                getattr(lib, name).restype = ct.c_longlong
                getattr(lib, name).argtypes = [ct.c_int]
            lib.chol_error_string.restype = ct.c_char_p
            lib.chol_error_string.argtypes = [ct.c_int]
            _LIB = lib
        return _LIB


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(x.data_ptr(), out.data_ptr(), b,
                                            n, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({lib.chol_error_string(rc).decode()}); a block needs "
            f"{getattr(lib, f'{name}_smem')(n)} B of shared memory at n={n}")
    return out, True


def chol(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix of k [B, n, n]: the CUDA
    kernel for a CUDA tensor (counted in chol_launches), the plain version
    for a CPU tensor."""
    global chol_launches
    if k.device.type == "cpu":
        return chol_reference(k)
    out, launched = _launch("chol", k)
    chol_launches += launched
    return out


def linv(l: torch.Tensor) -> torch.Tensor:
    """L^-1 of each lower-triangular matrix of l [B, n, n]: the CUDA
    kernel for a CUDA tensor (counted in linv_launches), the plain version
    for a CPU tensor."""
    global linv_launches
    if l.device.type == "cpu":
        return linv_reference(l)
    out, launched = _launch("linv", l)
    linv_launches += launched
    return out
