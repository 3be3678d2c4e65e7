"""Batched masked GP fit / posterior for the two GP families.

Port of gpismap_tpu/ops/gp.py. The cluster-GP systems (fit_ongpis,
linv_from_chol) are factored by ops/chol: the CUDA kernels on a CUDA
tensor, the plain versions on a CPU tensor (the counterparts of the JAX
package's gp._chol and linv_from_chol with GPISMAP_PALLAS_CHOL=1). The
observation-GP systems (fit_gpou, gpou_linv) stay on torch.linalg on
every device, as they never reach the Pallas kernels in the JAX package.
The triangular solves for alpha stay torch.linalg.solve_triangular (the
JAX package computes them outside any Pallas kernel too). The TPU-only
blocked factorization route is not ported.

 - GPou: tiny OU-kernel regressor of the observation GPs (ObsGP.cpp:32-62)
 - OnGPIS: Matern-3/2 SDF GP with gradient observations, one per cluster
   cell (OnGPIS.cpp)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import chol as chol_ops
from . import kernels


def _solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b with L lower triangular; batched."""
    return torch.linalg.solve_triangular(l, b, upper=False)


def _solve_chol(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b; batched (the two solveInPlace calls, ObsGP.cpp:43-44)."""
    y = _solve_lower(l, b)
    return torch.linalg.solve_triangular(l.mT, y, upper=True)


class GPouState(NamedTuple):
    """Batched trained GPou groups (ObsGP.cpp:32-48)."""

    x: torch.Tensor        # [B, M, D] inputs
    valid: torch.Tensor    # [B, M] bool
    l: torch.Tensor        # [B, M, M] Cholesky factor
    alpha: torch.Tensor    # [B, M]
    trained: torch.Tensor  # [B] bool — group has >0 samples


def fit_gpou(x: torch.Tensor, f: torch.Tensor, valid: torch.Tensor,
             scale: float, noise: float) -> GPouState:
    """Train a batch of GPou units (ObsGP.cpp:32-48).
    x: [B, M, D], f: [B, M], valid: [B, M]."""
    f = torch.where(valid, f, 0.0)
    k = kernels.ou_train_cov(x, noise, valid, scale)
    l = chol_ops.chol_reference(k)
    alpha = _solve_chol(l, f[..., None])[..., 0]
    return GPouState(x=x, valid=valid, l=l, alpha=alpha,
                     trained=torch.any(valid, dim=-1))


def _chol(k: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of cluster-GP systems [B, n, n]: the CUDA kernel on
    a CUDA tensor (gp._chol with the Pallas gate open)."""
    return chol_ops.chol(k)


def linv_from_chol(l: torch.Tensor) -> torch.Tensor:
    """Explicit L^-1 from a (masked) cluster-GP Cholesky factor: the
    per-query triangular solve of the reference (ObsGP.cpp:56-59) becomes
    one precomputed inverse plus matrix products, while the variance
    ||L^-1 k||^2 keeps the reference's stable form. The result is lower
    triangular with an exactly zero strict upper triangle. The CUDA kernel
    on a CUDA tensor."""
    return chol_ops.linv(l)


def gpou_test(state: GPouState, xt: torch.Tensor, scale: float,
              noise: float):
    """Posterior mean/variance at xt [B, Q, D] (ObsGP.cpp:50-62).

    Returns (mean [B, Q], var [B, Q]); var = 1 + noise - sum((L^-1 k*)^2).
    """
    ks = kernels.ou_cross_cov(state.x, state.valid, xt, scale)  # [B, M, Q]
    mean = torch.einsum('...mq,...m->...q', ks, state.alpha)
    v = _solve_lower(state.l, ks)
    var = 1.0 + noise - torch.sum(v * v, dim=-2)
    return mean, var


def gpou_linv(l: torch.Tensor) -> torch.Tensor:
    """linv_from_chol for the observation GPs' small factors (n = 26 in
    2D): torch.linalg on every device."""
    return chol_ops.linv_reference(l)


def gpou_posterior_gather(x: torch.Tensor, alpha: torch.Tensor,
                          linv: torch.Tensor, valid: torch.Tensor,
                          trained: torch.Tensor, cell_idx: torch.Tensor,
                          q: torch.Tensor, scale: float, noise: float,
                          chunk: int = 4096):
    """Many single-point GPou posteriors, one small GP per query — the
    batched form of the reference's per-point group lookup + GPou::test
    (ObsGP.cpp:352-463). Chunked to bound the [C, M, M] factor gather.

    x: [S, M, D]; alpha: [S, M]; linv: [S, M, M] (see gpou_linv);
    valid: [S, M]; trained: [S] bool; cell_idx: [Q] group per query
    (clipped to [0, S)); q: [Q, D]. Returns (mean [Q], var [Q]);
    untrained groups give (0, 1e6), the reference sentinel
    (ObsGP.cpp:161,363).
    """
    means, vars_ = [], []
    for s in range(0, q.shape[0], chunk):
        ci = cell_idx[s:s + chunk]
        qc = q[s:s + chunk]
        diff = x[ci] - qc[:, None, :]
        r = torch.sqrt(torch.sum(diff * diff, dim=-1))
        ks = torch.where(valid[ci], torch.exp(-r / scale), 0.0)  # [C, M]
        mean = torch.sum(ks * alpha[ci], dim=-1)
        v = torch.einsum('cmn,cn->cm', linv[ci], ks)             # L^-1 k*
        var = 1.0 + noise - torch.sum(v * v, dim=-1)
        tr = trained[ci]
        means.append(torch.where(tr, mean, 0.0))
        vars_.append(torch.where(tr, var, 1e6))
    return torch.cat(means), torch.cat(vars_)


class OnGPISState(NamedTuple):
    """Batched trained cluster GPs (OnGPIS.cpp:34-149)."""

    x: torch.Tensor         # [B, M, D]
    valid: torch.Tensor     # [B, M] bool
    gradflag: torch.Tensor  # [B, M] bool
    l: torch.Tensor         # [B, M(1+D), M(1+D)]
    alpha: torch.Tensor     # [B, M(1+D)]
    trained: torch.Tensor   # [B]


def ongpis_prepare(grad: torch.Tensor, sigx: torch.Tensor,
                   siggrad: torch.Tensor, valid: torch.Tensor):
    """Gradient-validity rule (OnGPIS.cpp:63-65,122-124): a node gives
    gradient rows unless its gradient noise exceeds 0.1001 or its
    gradient is (numerically) zero; such nodes get value noise 2.0.
    Returns (gradflag [B, M] bool, sigx_adjusted [B, M])."""
    no_grad = (siggrad > 0.1001) | torch.all(torch.abs(grad) < 1e-6, dim=-1)
    gradflag = valid & (~no_grad)
    sigx = torch.where(valid & no_grad, 2.0, sigx)
    return gradflag, sigx


def fit_ongpis(x: torch.Tensor, grad: torch.Tensor, val: torch.Tensor,
               sigx: torch.Tensor, siggrad: torch.Tensor,
               valid: torch.Tensor, scale: float) -> OnGPISState:
    """Train a batch of cluster SDF GPs (OnGPIS.cpp:34-89).

    x: [B, M, D] node positions; grad: [B, M, D] unit normals;
    val: [B, M] SDF targets; sigx/siggrad: [B, M] noises; valid: [B, M].
    Target layout y = [f; gx; gy] (OnGPIS.cpp:75-76) with masked rows 0.
    """
    d = x.shape[-1]
    gradflag, sigx = ongpis_prepare(grad, sigx, siggrad, valid)
    k = kernels.matern32_deriv_train_cov(x, sigx, siggrad, gradflag, valid,
                                         scale)
    gmaskf = gradflag.to(x.dtype)
    y = torch.cat([torch.where(valid, val, 0.0)]
                  + [grad[..., i] * gmaskf for i in range(d)], dim=-1)
    l = _chol(k)
    alpha = _solve_chol(l, y[..., None])[..., 0]
    return OnGPISState(x=x, valid=valid, gradflag=gradflag, l=l,
                       alpha=alpha, trained=torch.any(valid, dim=-1))


def ongpis_test(state: OnGPISState, xt: torch.Tensor, scale: float,
                val_const: float, grad_const: float):
    """Posterior SDF value/gradient + variances at xt [B, Q, D].

    Parity: OnGPIS.cpp:218-263 (test2Dpoint: val_const=1.01,
    grad_const=3/l^2+0.1) and :177-216 (testSinglePoint 3D branch:
    val_const=1.001, grad_const=3/l^2+0.001).

    Returns (f [B, Q], grad [B, Q, D], varf [B, Q], vargrad [B, Q, D]).
    """
    d = xt.shape[-1]
    q = xt.shape[-2]
    ks = kernels.matern32_deriv_cross_cov(state.x, state.gradflag,
                                          state.valid, xt, scale)
    res = torch.einsum('...mq,...m->...q', ks, state.alpha)  # [B, (1+D)Q]
    f = res[..., :q]
    grad = torch.stack([res[..., (1 + i) * q:(2 + i) * q] for i in range(d)],
                       dim=-1)
    v = _solve_lower(state.l, ks)
    vsum = torch.sum(v * v, dim=-2)
    varf = val_const - vsum[..., :q]
    vargrad = torch.stack(
        [grad_const - vsum[..., (1 + i) * q:(2 + i) * q] for i in range(d)],
        dim=-1)
    return f, grad, varf, vargrad
