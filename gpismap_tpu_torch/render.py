"""Sphere-traced rendering against the GPIS SDF, with autograd.

Port of gpismap_tpu/render.py. The map's batched SDF oracle
(models/cluster.map_test) drives a ray marcher, and depth is
differentiable end to end:

  * the march runs under torch.no_grad() (the JAX package's
    stop_gradient of the rays, store, hyper and factors): a loop of
    n_steps fixed steps with the same hit / done / steps rules as its
    lax.scan, left early once every ray is done (the remaining steps
    would change nothing);
  * the returned depth applies one implicit-function correction
      t* = t_hat - f(o + t_hat d) / <grad f, d>
    which carries the exact first-order gradients of the root of f along
    the ray with respect to the ray origins and directions, the cluster
    store (support positions, targets, alpha) and the hyperparameters.

On a CUDA device both the march and the correction run the tile kernel,
and the factorizations the chol and linv kernels; the correction's
gradients come from their torch.autograd.Functions (ops/tile_eval.py,
ops/chol.py). RenderConfig.two_phase sends the march's queries through
map_test's two-phase evaluation (the same results); the correction is
always single-phase. The JAX package's RenderConfig also carries
use_pallas, remat and flat_eval: the device, not a switch, picks the
kernels, and the eager port has no program forms to choose, so those
fields are gone.

The Matern kernel's distance is a sqrt (ops/kernels.py), whose backward
is NaN at r = 0: a gradient that flows into a pair of coincident points
(a query on a support node, with the node positions differentiated) is
NaN, as in the JAX package. Differentiate with respect to origins,
alpha, targets, scale and noise, as its tests do.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .models import cluster


class RenderConfig(NamedTuple):
    """SDF-oracle and marcher parameters (taken from the mapper)."""

    cell_size: float
    grid_half: int
    noff: int
    search_half: float
    scale: float
    val_const: float
    grad_const: float
    var_thre: float
    default_var: float
    tile: int
    max_cells: int
    max_active: int
    fbias: float
    n_steps: int = 48
    eps: float = 1e-3
    t_max: float = 10.0
    step_scale: float = 0.9
    two_phase: bool = False


class Hyper(NamedTuple):
    """GP hyperparameters as tensors: they override the RenderConfig
    values so that gradients reach the kernel length scale and the
    variance constants (the reference's scale / noise hyperparameters,
    covFnc.cpp:29-33, params.h:73-93)."""

    scale: torch.Tensor
    val_const: torch.Tensor
    grad_const: torch.Tensor


def hyper_from_scale(scale, dim: int, device=None) -> Hyper:
    """Hyper with the dimension's variance constants; grad_const tracks
    scale as 3/l^2 + const (OnGPIS.h:47,58). A float32 tensor `scale` on
    `device` (or its own device) keeps its graph."""
    sc = torch.as_tensor(scale, dtype=torch.float32, device=device)
    vc = torch.tensor(1.001 if dim == 3 else 1.01, dtype=torch.float32,
                      device=sc.device)
    gc = 3.0 / (sc * sc) + (0.001 if dim == 3 else 0.1)
    return Hyper(scale=sc, val_const=vc, grad_const=gc)


def config_from_mapper(m, **overrides) -> RenderConfig:
    """RenderConfig from a GPisMap2D / GPisMap3D: its query constants
    (_test_kwargs), fbias, and the march limits of its dimension."""
    is3d = m.dim == 3
    kw = m._test_kwargs()
    cfg = RenderConfig(
        cell_size=kw["cell_size"], grid_half=kw["grid_half"],
        noff=kw["noff"], search_half=kw["search_half"], scale=kw["scale"],
        val_const=kw["val_const"], grad_const=kw["grad_const"],
        var_thre=kw["var_thre"], default_var=kw["default_var"],
        tile=kw["tile"], max_cells=kw["max_cells"],
        max_active=kw["max_active"], fbias=m.p.fbias,
        t_max=4.0 if is3d else 30.0, eps=1e-4 if is3d else 1e-3)
    return cfg._replace(**overrides) if overrides else cfg


def sdf_eval(store: cluster.ClusterStore, grid: torch.Tensor,
             x: torch.Tensor, cfg: RenderConfig, factors=None,
             hyper: Optional[Hyper] = None):
    """(sdf, grad, var) at x [N, D]; sdf = posterior mean + fbias so the
    surface sits at sdf == 0 (visualize_gpisMap.m:26). Pass prefactorized
    cell factors (cluster.factorize_slots) to avoid refactorizing per
    call, as the march does; without them the touched cells are factored
    through chol and linv, so a gradient reaches hyper.scale through the
    factors too. `hyper` overrides the config's scale and variance
    constants."""
    h = hyper or Hyper(scale=cfg.scale, val_const=cfg.val_const,
                       grad_const=cfg.grad_const)
    f, g, vf, _, _ = cluster.map_test(
        store, grid, x, cell_size=cfg.cell_size, grid_half=cfg.grid_half,
        noff=cfg.noff, search_half=cfg.search_half, scale=h.scale,
        val_const=h.val_const, grad_const=h.grad_const,
        var_thre=cfg.var_thre, default_var=cfg.default_var, tile=cfg.tile,
        max_cells=cfg.max_cells, max_active=cfg.max_active,
        factors=factors, two_phase=cfg.two_phase)
    return f + cfg.fbias, g, vf


def implicit_correct(store: cluster.ClusterStore, grid: torch.Tensor,
                     origins: torch.Tensor, dirs: torch.Tensor,
                     t_hat: torch.Tensor, cfg: RenderConfig, factors=None,
                     hyper: Optional[Hyper] = None):
    """One differentiable implicit-function correction of a marched depth:
    t* = t_hat - f(o + t_hat d) / <grad f, d>.

    This is the ONLY differentiable evaluation of the render path (the
    march runs under no_grad). Callers doing backward-heavy work can
    march the full ray set, then call this on the HIT rays only: non-hit
    rays carry zero gradient for any hit-masked loss, so the compaction
    is exact, and the backward's recompute of the plain tile evaluation
    holds K* and L^-1 K* only for the tiles of those rays.

    Single-phase whatever cfg.two_phase says, as in the JAX package.
    Returns (t [N], f [N], g [N, D], vf [N]).
    """
    cfg = cfg._replace(two_phase=False)
    x_hat = origins + t_hat[:, None] * dirs
    f, g, vf = sdf_eval(store, grid, x_hat, cfg, factors, hyper)
    denom = torch.sum(g * dirs, dim=-1)
    denom = torch.where(torch.abs(denom) > 1e-3, denom,
                        torch.where(denom < 0, -1e-3, 1e-3))
    return t_hat - f / denom, f, g, vf


def sphere_trace(store: cluster.ClusterStore, grid: torch.Tensor,
                 origins: torch.Tensor, dirs: torch.Tensor,
                 cfg: RenderConfig, factors=None,
                 hyper: Optional[Hyper] = None):
    """March rays against the SDF; differentiable depth through the
    implicit correction.

    origins/dirs: [N, D] (dirs unit). Returns a dict with t [N]
    (corrected, differentiable), t_hat [N] (marched), hit [N] bool, pos
    [N, D], normal [N, D] (posterior gradient, normalized), var [N] and
    steps [N] int32.
    """
    n = origins.shape[0]
    with torch.no_grad():
        t = origins.new_zeros(n)
        done = torch.zeros(n, dtype=torch.bool, device=origins.device)
        steps = torch.zeros(n, dtype=torch.int32, device=origins.device)
        for _ in range(cfg.n_steps):
            f, _, _ = sdf_eval(store, grid, origins + t[:, None] * dirs,
                               cfg, factors, hyper)
            hit = torch.abs(f) < cfg.eps
            adv = torch.where(done | hit, 0.0, cfg.step_scale * f)
            # unmapped space returns f = fbias -> fixed forward steps
            t_new = torch.clamp(t + adv, 0.0, cfg.t_max)
            steps = steps + (~done).to(torch.int32)
            done = done | hit | (t_new >= cfg.t_max)
            t = t_new
            if bool(done.all()):
                break
    t_hat = t
    t, f, g, vf = implicit_correct(store, grid, origins, dirs, t_hat, cfg,
                                   factors, hyper)
    hit = (torch.abs(f) < 10.0 * cfg.eps) & (t_hat < cfg.t_max)
    pos = origins + t[:, None] * dirs
    nrm = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                          min=1e-9)
    return dict(t=t, t_hat=t_hat, hit=hit, pos=pos, normal=nrm, var=vf,
                steps=steps)


def camera_rays(pose_tr, pose_rot, cam, subsample: int = 4):
    """Pinhole ray grid in the world frame (numpy). Returns (origins
    [N, 3], unit dirs [N, 3], (h, w)). A pixel's ray length t is its
    optical-axis depth z times |(u, v, 1)|."""
    rows = np.arange(0, cam.height, subsample)
    cols = np.arange(0, cam.width, subsample)
    v = (rows - cam.cy) / cam.fy
    u = (cols - cam.cx) / cam.fx
    uu, vv = np.meshgrid(u, v)
    d_cam = np.stack([uu, vv, np.ones_like(uu)], -1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    d_world = d_cam.reshape(-1, 3) @ np.asarray(pose_rot).T
    o = np.broadcast_to(np.asarray(pose_tr), d_world.shape)
    return (o.astype(np.float32), d_world.astype(np.float32),
            (len(rows), len(cols)))


def render_depth(mapper, pose_tr, pose_rot, cam=None, subsample: int = 4,
                 **cfg_overrides):
    """Render a depth (ray length) / normal image from a mapper's current
    state, through its factor cache. Returns numpy arrays: depth [h, w]
    (NaN where no hit), hit, normal [h, w, 3] and var."""
    cam = cam or getattr(mapper, "cam", None)
    cfg = config_from_mapper(mapper, **cfg_overrides)
    o, d, shape = camera_rays(pose_tr, pose_rot, cam, subsample)
    out = sphere_trace(mapper.store, mapper.grid,
                       torch.as_tensor(o, device=mapper.device),
                       torch.as_tensor(d, device=mapper.device), cfg,
                       mapper._get_factors())

    def host(x):
        return x.detach().cpu().numpy()

    depth = host(out["t"]).reshape(shape)
    hit = host(out["hit"]).reshape(shape)
    return dict(depth=np.where(hit, depth, np.nan), hit=hit,
                normal=host(out["normal"]).reshape(shape + (3,)),
                var=host(out["var"]).reshape(shape))
