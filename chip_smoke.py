#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (gpismap_tpu_torch) on one NVIDIA GPU.

Builds the native libraries from the checkout (all at once) and drives
both mappers' main paths through their public entry points, each kernel
of a path first checked against its plain PyTorch version at the path's
production shapes:

  2D (phases 3-5): the tile evaluation at d=2 and the Cholesky and L^-1
  of the cluster GPs at MP <= 384; GPisMap2D(device="cuda").update on 28
  synthetic 1081-beam LiDAR frames, test() on the 49,551-point 0.1 m
  demo grid, then the last frame once more to drive the factor-cache
  refresh from the fits' own Cholesky factors. When $GPISMAP_DATA holds
  the bundled gazebo sequence (2D/gazebo1.mat), the 28 demo frames of the
  real sequence replace the synthetic ones, and the run says so.

  3D (phases 6-8): the tile evaluation at d=3 (MP=1280, T=128) and the
  Cholesky and L^-1 at MP 320/640/1280; GPisMap3D() (its default device,
  the card) on 40 synthetic 640x480 depth frames of a box and a cylinder
  (tests/torch_scenes.py), test() twice on the 15,225-point demo volume,
  then the last frame once more (the refresh).

  Rendering and gradients (phases 9-11), on the maps of phases 4 and 7:
  sphere_trace of all 28 poses' 1081 beams (30,268 rays, 48 and then
  RENDER_STEPS_2D steps) against the floor plan's noise-free ranges (with
  the real sequence: every beam of its frames, ungated), and the march
  against the CPU port's on the same map on every 32nd beam;
  render_depth of the 3D map from the last ring pose at subsample 2
  (76,800 rays) against the scene's noise-free ray lengths; each followed
  by the hit rays' implicit correction with their cells factored anew and
  its backward to alpha and scale (the tile, chol and linv kernels'
  autograd Functions). Then each Function's gradient against autograd
  through its plain version (chol/linv at B=64, n=384 and 1280; the tile
  kernel on phases 7's and 4's tile plans), the correction on 256 hit rays
  against the CPU port on the same map, moved across with
  runtime.checkpoint; the 3D map saved and loaded into a fresh
  GPisMap3D(); and the mex front end (mex_compat) on the card.

Usage: python3 chip_smoke.py    (from the repository root; needs CUDA)

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the one
before that lists each kernel at each shape of the two paths with its
launches on the update->test path (`launches`) and on each path apart
(`launches_by_path`: update->test, the gated render march or
render_depth, the correction with its backward; each counted from 0 just
before that path ran), its error against the plain
version, its time, the plain version's, the bound (the least time the
card could take for the same work) and the time of the PyTorch call that
computes the same function, where there is one. Any failed phase exits non-zero
before that.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel vs plain version, per output; fp32 throughout, see PERF.md. At
# d=3 an output's error is taken relative to its largest magnitude (at
# least 1): var_grad there is grad_const - s with grad_const = 3/l^2 +
# 0.001 = 1875 (l = 0.04 m, 2.18 in 2D), and one f32 ulp of 1875 is
# already 1.2e-4
KERNEL_TOL = 1e-4
# Cholesky factor vs the plain version: the synthetic SPD tolerance of
# tests/test_pallas.py (f32, rounding order only), relative to the
# factor's largest entry where that exceeds 1: the 3D systems' gradient
# block has 3/l^2 = 1875 on its diagonal (l = 0.04 m), so L reaches 43
# there (about 1.5 in 2D)
CHOL_TOL = 2e-4
# L^-1 vs the plain version, relative to max |L^-1|: its entries grow with
# the condition of the cluster system (variances are built from them), so
# an absolute bound would depend on the map
LINV_REL_TOL = 1e-4
# GPU port vs CPU port (plain tile evaluation, LAPACK factors) on the
# same map at random query points
CROSS_TOL = 1e-3
# mapped share of the demo grid (var_f < 1 + map_noise) the 28-frame
# synthetic floor must reach: its walls span the grid's extent, and a
# CPU run of the same scene at 271 beams mapped all of it
MAPPED_FLOOR = 0.9
# share of wall probe pairs whose SDF signs differ across the wall
SIGN_FLOOR = 0.9
# mapped share of the 3D demo volume (var_f < 1 + map_noise) the 40-frame
# synthetic object must reach: a CPU run of the port on the same scene and
# poses at 320x240 (half the focal length; tools/torch_scene3d_cpu.py)
# mapped 0.9887 of it
MAPPED_FLOOR_3D = 0.9
# share of the confident surface probe pairs (1 cm outside and 1 cm
# inside the object along its true normal) whose SDF signs differ
SIGN_FLOOR_3D = 0.9
# render gates, fixed before the first chip run: the share of rays with
# a finite true range that hit, and the median |t - true range| at those
# hits (the JAX circle test's atol in 2D). The 2D gate holds the render
# marched with RENDER_STEPS_2D steps: in free space a step is 0.9 fbias =
# 0.18 m, so the 48 steps of the JAX package's default reach 8.6 m there,
# and on every 16th beam 48 steps hit 0.834 of the beams, every miss out
# of steps, 96 steps 0.939 (tests/test_torch_render_floor.py, the port
# and the JAX package alike)
RENDER_HIT_2D = 0.9
RENDER_MEDIAN_2D = 0.05
RENDER_STEPS_2D = 96
# share of the 2D beams with a true range hit within 0.5 m of it: the
# other hits stop at zero crossings of the posterior mean in cells far
# from data, and the JAX package's render of the same map stops at the
# same ones (tests/test_torch_render_floor.py: 0.7532 of every 16th beam
# within 0.5 m at 96 steps, the port's hits and steps identical); the
# floor sits 0.05 below that reference share
RENDER_GOOD_2D = 0.7
# the card's 2D march vs the CPU port's on the same map: the share of rays
# with the same hit and t within CROSS_TOL (relative, to at least 1 m); a
# ray whose |f| lands within rounding of eps at some step may stop a step
# apart
MARCH_AGREE = 0.99
RENDER_HIT_3D = 0.8
RENDER_MEDIAN_3D = 0.01
# an autograd Function's gradient vs autograd through the plain version on
# the same inputs, relative to the gradient's largest magnitude; also the
# correction on the card vs the CPU port
GRAD_TOL = 1e-3
# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): fp32
# outside the tensor cores (every kernel here is fp32 FMAs) and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Wraps module.name to keep the arguments of every call."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    @property
    def args(self):
        return self.calls[-1]

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def bound(flops: float, nbytes: float):
    """The least time the card could take for work of `flops` fp32
    operations that must move `nbytes` (each input read once, each output
    written once): (ms, "operations" or "bytes", whichever bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def unmasked_rows(args, kwargs) -> torch.Tensor:
    """[S] support rows of each cell that the masks keep: the f rows of
    nodes with valid = 1 and the D gradient rows of nodes with gradflag *
    valid = 1 (ops/kernels.py). The others are zero rows of K*, and the
    identity-masked system makes their rows and columns of L^-1 the
    identity's, so no product needs them."""
    gradflag, valid = args[4] > 0.5, args[5] > 0.5
    return (valid.sum(-1) + kwargs["d"] * (gradflag & valid).sum(-1)).double()


def tile_work(args, kwargs):
    """(fp32 operations, bytes) that one tile evaluation needs on these
    inputs: per active tile, with n its cell's unmasked_rows, n(n+1)/2 + n
    multiply-adds per K* column (the variance product over those rows of
    L^-1's lower triangle, and the mean), T(1+D) columns; bytes: that part
    of L^-1 and of alpha and the other inputs of each cell the active
    tiles use, their queries, the tile list and the outputs."""
    tile_seg, _, xt, _, _, _, qt = args
    d = kwargs["d"]
    m, t = xt.shape[-1], qt.shape[-1]
    segs = tile_seg[tile_seg >= 0].long()
    cells = torch.unique(segs)
    n = unmasked_rows(args, kwargs)
    per_col = n * (n + 1) / 2 + n
    flops = 2.0 * t * (1 + d) * float(per_col[segs].sum())
    nbytes = 4.0 * (float(per_col[cells].sum()) + cells.numel() * (d + 2) * m
                    + tile_seg.numel() + segs.numel() * t * (d + 2 + 2 * d))
    return flops, nbytes


def row_shares(args, kwargs) -> str:
    """The mean share of valid support nodes (valid summed over M) and of
    unmasked K* rows (unmasked_rows over MP) of the cells the active tiles
    use, per active tile and per cell."""
    segs = args[0][args[0] >= 0].long()
    cells = torch.unique(segs)
    m, mp = args[5].shape[-1], args[1].shape[-1]
    valid = (args[5] > 0.5).sum(-1).double() / m
    rows = unmasked_rows(args, kwargs) / mp
    return (f"valid support nodes: mean share {float(valid[segs].mean()):.4f} "
            f"over the {segs.numel()} active tiles, "
            f"{float(valid[cells].mean()):.4f} over their {cells.numel()} "
            f"cells (M={m}); unmasked K* rows: {float(rows[segs].mean()):.4f} "
            f"per tile, {float(rows[cells].mean()):.4f} per cell (MP={mp})")


def tile_bound(args, kwargs):
    """bound() of one tile evaluation on these inputs (tile_work)."""
    return bound(*tile_work(args, kwargs))


def tile_rate(tile_ops, args, kwargs, ms):
    """The kernel's rate on tile_work's operation count, and the dynamic
    shared memory of one of its blocks at this M."""
    d, m = kwargs["d"], args[2].shape[-1]
    smem = tile_ops._lib().tile_eval_smem_bytes(d, m)
    return (f"{tile_work(args, kwargs)[0] / ms / 1e9:.2f} TFLOP/s, "
            f"{smem} B of dynamic shared memory per block at M={m}")


def factor_bound(x: torch.Tensor):
    """bound() of chol or linv on [B, n, n]: n^3/6 multiply-adds per
    matrix; the matrix read once and its factor written once."""
    b, n, _ = x.shape
    return bound(b * n ** 3 / 3.0, 8.0 * b * n * n)


def kernel_entry(name, replaces, launches_by_path, err, ms, plain_ms, bnd,
                 library_ms):
    """One kernel of the kernels line: `launches` is its count on the
    update->test path, `launches_by_path` its count on each path, each
    counted from 0 just before that path ran."""
    source = ("gpismap_tpu_torch/csrc/tile_eval.cu"
              if name.startswith("tile_eval")
              else "gpismap_tpu_torch/csrc/chol.cu")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches_by_path["update_test"],
            "launches_by_path": launches_by_path, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms}


def ptxas_lines(name: str, log: str):
    """The register / spill / shared-memory lines of nvcc's -Xptxas -v
    report, each labelled with its kernel (and the tile kernel's
    dimension). Dynamic shared memory is not in it: phases 3 and 6 print
    the tile kernel's."""
    fn = name
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = next((label for key, label in (
                ("ILi2E", "tile_eval d=2"), ("ILi3E", "tile_eval d=3"),
                ("chol_init_kernel", "chol_init_kernel"),
                ("chol_panel_kernel", "chol_panel_kernel"),
                ("chol_update_kernel", "chol_update_kernel"),
                ("linv_diag_kernel", "linv_diag_kernel"),
                ("linv_merge_ca_kernel", "linv_merge_ca_kernel"),
                ("linv_merge_x_kernel", "linv_merge_x_kernel"))
                if key in line), name)
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas ({fn}): {line.strip()}")


def compare_kernel(tile_ops, captured):
    """Kernel vs plain version on captured tile-op arguments, per output
    over the active tiles: (max abs error, max abs error relative to the
    output's largest magnitude, at least 1)."""
    args, kwargs = captured
    out_k = tile_ops.tile_eval(*args, **kwargs)
    out_r = tile_ops.tile_eval_reference(*args, **kwargs)
    torch.cuda.synchronize()
    act = args[0] >= 0
    err, rel = {}, {}
    for name, a, b in zip(("f", "g", "vf", "vg"), out_k, out_r):
        err[name] = float((a[act] - b[act]).abs().max())
        rel[name] = err[name] / max(1.0, float(b[act].abs().max()))
    return err, rel


def spd_batch(b: int, n: int, seed: int) -> torch.Tensor:
    """SPD [b, n, n] on the card as in tests/test_pallas.py, two rows of
    every third matrix identity-masked as ops/kernels.py pads."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((b, n, n), generator=g, device="cuda") / n ** 0.5
    k = a @ a.mT + 2.0 * torch.eye(n, device="cuda")
    for i in range(0, b, 3):
        for j in (3, n - 2):
            k[i, j, :] = 0.0
            k[i, :, j] = 0.0
            k[i, j, j] = 1.0
    return k.contiguous()


def check_factor_kernels(chol_ops, name, k, card):
    """chol on k and linv on the plain factor vs their plain versions:
    errors and CUDA-event times. Returns the row for the summary."""
    l_ref = chol_ops.chol_reference(k).contiguous()
    l_err = float((chol_ops.chol(k) - l_ref).abs().max())
    l_rel = l_err / max(1.0, float(l_ref.abs().max()))
    w_ref = chol_ops.linv_reference(l_ref)
    w_err = float((chol_ops.linv(l_ref) - w_ref).abs().max())
    w_rel = w_err / float(w_ref.abs().max())
    torch.cuda.synchronize()
    b, n, _ = k.shape
    eye = torch.eye(n, device=k.device).expand(k.shape)
    row = dict(
        chol_err=l_err, chol_rel=l_rel, linv_err=w_err, linv_rel=w_rel,
        chol_ms=cuda_ms(lambda: chol_ops.chol(k), 10),
        chol_plain_ms=cuda_ms(lambda: chol_ops.chol_reference(k), 5),
        chol_library_ms=cuda_ms(lambda: torch.linalg.cholesky(k), 5),
        linv_ms=cuda_ms(lambda: chol_ops.linv(l_ref), 10),
        linv_plain_ms=cuda_ms(lambda: chol_ops.linv_reference(l_ref), 5),
        linv_library_ms=cuda_ms(lambda: torch.linalg.solve_triangular(
            l_ref, eye, upper=False), 5),
        bound=factor_bound(k))
    print(f"  {name} B={b} MP={n}: chol max abs err {l_err:.3g} (relative "
          f"{l_rel:.3g}), kernel {row['chol_ms']:.3f} ms in "
          f"{chol_ops.cuda_launches_per_chol(n)} CUDA launches per call, "
          f"plain {row['chol_plain_ms']:.3f} ms, library "
          f"{row['chol_library_ms']:.3f} ms; "
          f"linv max abs err {w_err:.3g} (relative {w_rel:.3g}), kernel "
          f"{row['linv_ms']:.3f} ms in {chol_ops.cuda_launches_per_linv(n)} "
          f"CUDA launches per call, plain {row['linv_plain_ms']:.3f} ms, "
          f"library {row['linv_library_ms']:.3f} ms; "
          f"bound {row['bound'][0]:.3f} ms ({row['bound'][1]}) ({card})",
          flush=True)
    if l_rel > CHOL_TOL:
        fail(f"chol kernel disagrees with the plain version on {name}: "
             f"{l_err} ({l_rel} relative)")
    if w_rel > LINV_REL_TOL:
        fail(f"linv kernel disagrees with the plain version on {name}: "
             f"relative {w_rel}")
    return row


def check_walls(m, torch_scenes):
    """SDF (f + fbias) changes sign across the walls the scanner saw."""
    near, far = torch_scenes.wall_probes(torch_scenes.floor_plan(),
                                         torch_scenes.floor_trajectory(28))
    r_near, r_far = m.test(near), m.test(far)
    conf = (r_near[:, 3] < m.p.test_var_thre) & (r_far[:, 3]
                                                 < m.p.test_var_thre)
    s_near = np.sign(r_near[conf, 0] + m.p.fbias)
    s_far = np.sign(r_far[conf, 0] + m.p.fbias)
    flip = float((s_near != s_far).mean()) if conf.any() else 0.0
    free_pos = float((s_near > 0).mean()) if conf.any() else 0.0
    print(f"  wall probes: {int(conf.sum())} of {len(near)} pairs "
          f"confident; sign differs across the wall in {flip:.3f}; "
          f"scanner side positive in {free_pos:.3f}")
    if flip < SIGN_FLOOR:
        fail(f"SDF sign flips across walls in only {flip} of the probes")


def check_surface(m, torch_scenes):
    """SDF (f + fbias) changes sign between 1 cm outside and 1 cm inside
    the object's surface, along its true normal."""
    out, inside = torch_scenes.surface_probes()
    r_out, r_in = m.test(out), m.test(inside)
    conf = (r_out[:, 4] < m.p.test_var_thre) & (r_in[:, 4]
                                                < m.p.test_var_thre)
    s_out = np.sign(r_out[conf, 0] + m.p.fbias)
    s_in = np.sign(r_in[conf, 0] + m.p.fbias)
    flip = float((s_out != s_in).mean()) if conf.any() else 0.0
    out_pos = float((s_out > 0).mean()) if conf.any() else 0.0
    print(f"  surface probes: {int(conf.sum())} of {len(out)} pairs "
          f"confident; sign differs across the surface in {flip:.4f}; "
          f"outside positive in {out_pos:.4f}")
    if flip < SIGN_FLOOR_3D:
        fail(f"SDF sign flips across the surface in only {flip} of the "
             f"probes")


def run_3d(card, torch_scenes, chol_ops, tile_ops, cluster, convert):
    """Phases 6-8, the 3D path. Returns the numbers of its kernel
    entries."""
    from gpismap_tpu_torch import BIGBIRD_CAMS, GPisMap3D

    frames = torch_scenes.object_frames(40, BIGBIRD_CAMS[0])
    volume = torch_scenes.volume_grid()
    if volume.shape != (15225, 3):
        fail(f"query volume has shape {volume.shape}")
    print("scene 3D: synthetic box and cylinder (tests/torch_scenes.py), "
          "40 frames of 640x480 depth, bigbird camera 1", flush=True)

    # ---- phase 6: the 3D kernels vs their plain versions, on the
    # cluster systems, tile plan and factors of a mapped scene ----
    warm = GPisMap3D()
    warm.set_camera(1, "bigbird")           # the frames' intrinsics
    warm.update_batch(frames[:11])
    with Capture(chol_ops, "chol") as cap_fit:
        warm.update(*frames[11])
    with Capture(tile_ops, "tile_eval") as cap, \
            Capture(chol_ops, "chol") as cap_fill:
        warm.test(volume)
    args, kwargs = cap.args
    nt, mp, t = args[0].shape[0], args[1].shape[1], args[6].shape[-1]
    n_act = int((args[0] >= 0).sum())
    err6, rel6 = compare_kernel(tile_ops, cap.args)
    ms = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs), 5)
    plain_ms = cuda_ms(lambda: tile_ops.tile_eval_reference(*args, **kwargs),
                       2)
    bnd = tile_bound(args, kwargs)
    rate = tile_rate(tile_ops, args, kwargs, ms)
    print(f"phase 6: d=3 NT={nt} ({n_act} active) MP={mp} T={t}: max abs "
          "err " + " ".join(f"{k}={v:.3g}" for k, v in err6.items())
          + " (relative " + " ".join(f"{k}={v:.3g}" for k, v in rel6.items())
          + f"); kernel {ms:.3f} ms ({rate}), plain {plain_ms:.3f} ms, "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}) ({card})", flush=True)
    # masked support rows cost the kernel's variance product as much as
    # real ones, though the function needs none of them (tile_work)
    print(f"  {row_shares(args, kwargs)}", flush=True)
    if max(rel6.values()) > KERNEL_TOL:
        fail(f"d=3 kernel disagrees with the plain version: {rel6}")
    if not cap_fit.calls or not cap_fill.calls:
        fail("the warm 3D map's retrain or fill factored nothing")
    systems = ([("retrain K", c[0][0]) for c in cap_fit.calls]
               + [("fill K", c[0][0]) for c in cap_fill.calls]
               + [("synthetic SPD", spd_batch(64, n, seed=n))
                  for n in (320, 640, 1280)])
    print("phase 6b: chol and linv vs their plain versions at the 3D sizes "
          "(linv on the plain L)", flush=True)
    rows = [check_factor_kernels(chol_ops, name, k, card)
            for name, k in systems]
    out = dict(tile_err=max(err6.values()), tile_ms=ms,
               tile_plain_ms=plain_ms, tile_bound=bnd,
               chol_err=max(r["chol_err"] for r in rows),
               linv_err=max(r["linv_err"] for r in rows),
               headline=rows[-1])                   # B=64 at MP=1280
    del warm, cap, cap_fit, cap_fill, args, kwargs, systems

    # ---- phase 7: the 3D main path at full size, on the default device ----
    m = GPisMap3D()
    if m.device.type != "cuda":
        fail(f"GPisMap3D() runs on {m.device}, not the card")
    m.set_camera(1, "bigbird")
    tile_ops.launches = 0
    chol_ops.chol_launches = chol_ops.linv_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    m.update_batch(frames)
    torch.cuda.synchronize()
    t_update = time.time() - t0
    upd = (tile_ops.launches, chol_ops.chol_launches, chol_ops.linv_launches)
    tile_ops.launches = 0
    chol_ops.chol_launches = chol_ops.linv_launches = 0
    t0 = time.time()
    res = m.test(volume)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    with Capture(tile_ops, "tile_eval") as cap:
        t0 = time.time()
        m.test(volume)
        torch.cuda.synchronize()
        t_warm = time.time() - t0
    tst = (tile_ops.launches, chol_ops.chol_launches, chol_ops.linv_launches)
    n_live = len(m._live_slots())
    print(f"phase 7: {m.num_nodes} nodes, {n_live} live cells after "
          f"{len(frames)} frames; update {len(frames) / t_update:.2f} "
          f"frames/s; test {len(volume) / t_first:.0f} queries/s on the "
          f"first call (factor cache fill included), "
          f"{len(volume) / t_warm:.0f} warm; launches tile/chol/linv "
          f"{upd[0]}/{upd[1]}/{upd[2]} in update, {tst[0]}/{tst[1]}/{tst[2]} "
          f"in the two tests ({card})", flush=True)
    if tst[0] < 1:
        fail("test() did not launch the d=3 tile kernel")
    if upd[1] + tst[1] < 1 or upd[2] + tst[2] < 1:
        fail("the 3D main path did not launch the chol and linv kernels")
    if m._factors is None:
        fail(f"test() did not use the factor cache ({n_live} live cells, "
             f"bound {m.cap.test_active_cells})")
    if res.shape != (len(volume), 8) or not np.isfinite(res).all():
        fail(f"test() output not finite of shape {(len(volume), 8)}")
    mapped = float((res[:, 4] < 1.0 + m.p.map_noise_param).mean())
    confident = float((res[:, 4] < m.p.test_var_thre).mean())
    print(f"  mapped share {mapped:.4f} (floor {MAPPED_FLOOR_3D}), var_f "
          f"below var_thre {confident:.4f}")
    if mapped < MAPPED_FLOOR_3D:
        fail(f"mapped share {mapped} below {MAPPED_FLOOR_3D}")
    check_surface(m, torch_scenes)
    err7, rel7 = compare_kernel(tile_ops, cap.args)
    print("  d=3 kernel vs plain on this map's tile plan: max abs err "
          + " ".join(f"{k}={v:.3g}" for k, v in err7.items())
          + " (relative " + " ".join(f"{k}={v:.3g}" for k, v in rel7.items())
          + ")")
    if max(rel7.values()) > KERNEL_TOL:
        fail(f"d=3 kernel disagrees with the plain version: {rel7}")
    out["tile_err"] = max(out["tile_err"], max(err7.values()))
    out["tile_args"] = cap.args             # phase 10b's tile plan
    del cap

    # the same map on the CPU through the plain versions, at random points
    # of the volume; var_grad is 3/l^2 + 0.001 = 1875 minus a sum of the
    # same size, so it is held to CROSS_TOL of that constant
    cpu = GPisMap3D(camera=m.cam, device="cpu")
    convert.state_from_numpy(
        m.index.serialize(),
        {f"store_{k}": v.cpu().numpy() for k, v in m.store._asdict().items()},
        m.frame, cpu)
    rng = np.random.default_rng(0)
    qr = np.stack([rng.uniform(*torch_scenes.VOLUME_X, 4096),
                   rng.uniform(*torch_scenes.VOLUME_Y, 4096),
                   rng.uniform(*torch_scenes.VOLUME_Z, 4096)],
                  -1).astype(np.float32)
    t0 = time.time()
    d_cross = np.abs(m.test(qr) - cpu.test(qr)).max(0)
    grad_const = m._test_kwargs()["grad_const"]
    print("  GPU vs CPU port at 4096 random points: max abs diff "
          + " ".join(f"{v:.3g}" for v in d_cross)
          + f" (var_grad relative to {grad_const:.1f}: "
          f"{d_cross[5:].max() / grad_const:.3g}; {time.time() - t0:.1f} s)")
    if max(d_cross[:5].max(), d_cross[5:].max() / grad_const) > CROSS_TOL:
        fail(f"GPU and CPU results differ: {d_cross}")
    del cpu

    # ---- phase 8: re-ingest the last frame with a warm factor cache ----
    uniq = m._factors[1]
    chol_ops.chol_launches = chol_ops.linv_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    m.update(*frames[-1])
    torch.cuda.synchronize()
    t_refresh = time.time() - t0
    refresh = (chol_ops.chol_launches, chol_ops.linv_launches)
    if m._factors is None or m._factors[1] is not uniq:
        fail("the re-ingested 3D frame dropped the factor cache instead of "
             "refreshing it")
    if refresh[0] < 1 or refresh[1] < 1:
        fail(f"the 3D refresh launched chol/linv {refresh[0]}/{refresh[1]} "
             f"times")
    live = np.full(m.cap.test_active_cells, -1, np.int32)
    live[:len(m._factors_slots)] = m._factors_slots
    fresh, _ = cluster.factorize_slots(
        m.store, torch.as_tensor(live, device=m.device),
        m.p.map_scale_param, m.cap.test_active_cells)
    d_cache = float((m._factors[0] - fresh).abs().max())
    rel_cache = d_cache / float(fresh.abs().max())
    del fresh
    r_cached = m.test(qr)
    m._factors = None
    d_refresh = np.abs(r_cached - m.test(qr)).max(0)
    print(f"phase 8: re-ingested 3D frame in {t_refresh * 1e3:.1f} ms, "
          f"chol/linv launches {refresh[0]}/{refresh[1]}; refreshed cache vs "
          f"a fresh fill max abs diff {d_cache:.3g} (relative "
          f"{rel_cache:.3g}); test() through it vs a fresh fill at 4096 "
          f"random points: max abs diff "
          + " ".join(f"{v:.3g}" for v in d_refresh) + f" ({card})",
          flush=True)
    if rel_cache > LINV_REL_TOL:
        fail(f"refreshed 3D factor cache differs from a fresh fill by "
             f"{rel_cache} relative")
    if max(d_refresh[:5].max(), d_refresh[5:].max() / grad_const) \
            > KERNEL_TOL:
        fail(f"test() through the refreshed 3D cache differs by "
             f"{d_refresh}")
    out.update(tile_launches=tst[0],
               chol_launches=upd[1] + tst[1] + refresh[0],
               linv_launches=upd[2] + tst[2] + refresh[1],
               map=m, frames=frames, qr=qr)
    return out


def counts(tile_ops, chol_ops, reset: bool = False):
    """(tile, chol, linv) launch counts; reset=True sets them to 0 first."""
    if reset:
        tile_ops.launches = 0
        chol_ops.chol_launches = chol_ops.linv_launches = 0
    return (tile_ops.launches, chol_ops.chol_launches, chol_ops.linv_launches)


def rel_err(a: torch.Tensor, b: torch.Tensor, floor: float = 0.0) -> float:
    """max |a - b| over max(max |b|, floor)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), floor)


def hit_stats(hit: np.ndarray, t: np.ndarray, truth: np.ndarray,
              var: np.ndarray, near: float):
    """(hit share of the rays with a finite true range, share of those
    rays hit within `near` of it, median and p95 of |t - truth| at their
    hits, hits on rays without a true range, and a note of the median
    posterior var_f at the hits within and beyond `near`)."""
    fin = np.isfinite(truth)
    h = hit & fin
    err = np.abs(t - truth)[h]
    v = var[h]
    off = err > near
    note = (f"median var_f at hits within {near:g} m {np.median(v[~off]):.4g}, "
            f"further off {np.median(v[off]) if off.any() else np.nan:.4g}")
    return (float(h.sum() / fin.sum()), float((~off).sum() / fin.sum()),
            float(np.median(err)), float(np.percentile(err, 95)),
            int((hit & ~fin).sum()), note)


def carry_to_cpu(checkpoint, m, cpu, path):
    """The map m moved into the CPU mapper cpu with runtime.checkpoint."""
    checkpoint.save(m, path)
    checkpoint.load(cpu, path)
    if cpu.num_nodes != m.num_nodes:
        fail(f"the CPU copy has {cpu.num_nodes} nodes, the map {m.num_nodes}")
    return cpu


def correction_backward(render, m, o, d, t_hat, cfg, with_var=False):
    """The hit-compacted correction of rays (o, d, t_hat) on map m, with the
    touched cells factored anew (factors=None) so that scale reaches the
    factors too, and its backward: the gradients of sum(t) (+ sum(vf))
    with respect to store.alpha and scale. Returns (t, f, d/d alpha,
    d/d scale, <g, d> per ray)."""
    alpha = m.store.alpha.detach().clone().requires_grad_()
    scale = torch.tensor(m.p.map_scale_param, dtype=torch.float32,
                         device=m.device, requires_grad=True)
    t, f, g, vf = render.implicit_correct(
        m.store._replace(alpha=alpha), m.grid, o, d, t_hat, cfg, None,
        render.hyper_from_scale(scale, m.dim))
    loss = t.sum() + (vf.sum() if with_var else 0.0)
    g_alpha, g_scale = torch.autograd.grad(loss, [alpha, scale])
    return (t.detach(), f.detach(), g_alpha, g_scale,
            torch.sum(g.detach() * d, dim=-1))


def check_grads(name, g_alpha, g_scale):
    if not (torch.isfinite(g_alpha).all() and torch.isfinite(g_scale)):
        fail(f"{name}: non-finite gradient")
    if float(g_alpha.abs().max()) == 0.0 or float(g_scale) == 0.0:
        fail(f"{name}: zero gradient (alpha max "
             f"{float(g_alpha.abs().max())}, scale {float(g_scale)})")


def render_fwd_bwd(card, render, m, o, d, cfg, tile_ops, chol_ops, label):
    """March all rays through the mapper's factor cache, then the
    hit-compacted correction's backward of the summed hit depths (alpha,
    scale); twice, the first call paying the backward's first use of its
    CUDA kernels. Returns the march's output and the launches of the
    second call's correction and backward, counted from 0 just before it."""
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        out = render.sphere_trace(m.store, m.grid, o, d, cfg,
                                  m._get_factors())
        idx = torch.nonzero(out["hit"]).reshape(-1)
        torch.cuda.synchronize()
        t1 = time.time()
        counts(tile_ops, chol_ops, reset=True)
        _, _, g_alpha, g_scale, _ = correction_backward(
            render, m, o[idx], d[idx], out["t_hat"][idx], cfg)
        torch.cuda.synchronize()
        n = np.asarray(counts(tile_ops, chol_ops))
        walls.append((time.time() - t0, time.time() - t1))
        check_grads(label, g_alpha, g_scale)
    print(f"  {label}: forward+backward {len(o) / walls[1][0]:.0f} rays/s "
          f"({walls[1][0]:.3f} s: the march, then {walls[1][1]:.3f} s for the "
          f"correction of the {len(idx)} hit rays with their cells factored "
          f"anew and its backward; the first call {walls[0][0]:.3f} s, "
          f"{walls[0][1]:.3f} s of it in the correction and backward); "
          f"launches tile/chol/linv {n[0]}/{n[1]}/{n[2]} in the correction "
          f"and its backward; d sum(t)/d scale {float(g_scale):.6g}, max "
          f"|d sum(t)/d alpha| {float(g_alpha.abs().max()):.6g} ({card})",
          flush=True)
    if n.min() < 1:
        fail(f"{label}: the correction and its backward launched "
             f"tile/chol/linv {n} times")
    return out, n


def run_render_2d(card, m, cpu, frames, torch_scenes, render, tile_ops,
                  chol_ops):
    """Phase 9: sphere_trace of every beam of the 28 poses on the 2D map,
    against the floor plan's noise-free ranges (a real sequence has no
    floor plan: its beams are marched, not gated), the card's march
    against the CPU port's on every 32nd beam, then the correction's
    backward. Returns the launches of the march and of the correction
    with its backward, each counted from 0 just before it, and the rays."""
    if frames is None:
        o_np, d_np, rng = torch_scenes.beams(
            torch_scenes.floor_plan(), torch_scenes.floor_trajectory(28))
        truth = np.where(rng < torch_scenes.MAX_RANGE, rng, np.inf)
        what = "28 poses x 1081 beams"
    else:
        o_np, d_np, _ = torch_scenes.frame_rays(frames)
        truth = None
        what = f"every beam of the {len(frames)} frames"
    o = torch.as_tensor(o_np, device=m.device)
    d = torch.as_tensor(d_np, device=m.device)
    for n_steps in (48, RENDER_STEPS_2D):
        cfg = render.config_from_mapper(m, n_steps=n_steps)
        m._factors = None           # the render fills the factor cache
        counts(tile_ops, chol_ops, reset=True)
        torch.cuda.synchronize()
        t0 = time.time()
        out = render.sphere_trace(m.store, m.grid, o, d, cfg,
                                  m._get_factors())
        torch.cuda.synchronize()
        wall = time.time() - t0
        n_march = np.asarray(counts(tile_ops, chol_ops))
        hit = out["hit"].cpu().numpy()
        steps = out["steps"].cpu().numpy()
        line = (f"phase 9: 2D render, {len(o)} rays ({what}), {n_steps} "
                f"steps: {len(o) / wall:.0f} rays/s "
                f"forward ({wall:.3f} s, factor-cache fill included); hits "
                f"{hit.mean():.4f} of the rays, "
                f"{int(((~hit) & (steps == n_steps)).sum())} out of steps; "
                f"launches tile/chol/linv {n_march[0]}/{n_march[1]}/"
                f"{n_march[2]} ({card})")
        if truth is None:
            print(line + "; no floor plan: the hit gates are skipped",
                  flush=True)
            continue
        share, good, med, p95, false, note = hit_stats(
            hit, out["t"].detach().cpu().numpy(), truth,
            out["var"].cpu().numpy(), 0.5)
        print(line + f"\n  of the {int(np.isfinite(truth).sum())} beams with "
              f"a true range < {torch_scenes.MAX_RANGE:g} m: hit {share:.4f}, "
              f"hit within 0.5 m of it {good:.4f}; |t - range| at hits median "
              f"{med:.4g} m, p95 {p95:.4g} m ({note}); hits on the "
              f"{int((~np.isfinite(truth)).sum())} beams without a true "
              f"range {false}", flush=True)
    if n_march.min() < 1:
        fail(f"the 2D render launched tile/chol/linv {n_march} times")
    if truth is not None and (share < RENDER_HIT_2D or med > RENDER_MEDIAN_2D
                              or good < RENDER_GOOD_2D or false > 0):
        fail(f"2D render at {RENDER_STEPS_2D} steps: hit share {share} "
             f"(floor {RENDER_HIT_2D}), within 0.5 m {good} (floor "
             f"{RENDER_GOOD_2D}), median error {med} m (limit "
             f"{RENDER_MEDIAN_2D}), {false} hits without a true range")

    # the same march by the CPU port on the same map, every 32nd beam
    t0 = time.time()
    sub = slice(None, None, 32)
    ref = render.sphere_trace(cpu.store, cpu.grid, o[sub].cpu(),
                              d[sub].cpu(), cfg, cpu._get_factors())
    t_card = out["t"][sub].detach().cpu()
    agree = ((out["hit"][sub].cpu() == ref["hit"])
             & ((t_card - ref["t"].detach()).abs()
                <= CROSS_TOL * ref["t"].detach().abs().clamp(min=1.0)))
    share_agree = float(agree.double().mean())
    print(f"  card vs CPU port march on every 32nd beam ({len(agree)} rays, "
          f"{RENDER_STEPS_2D} steps): same hit and t within {CROSS_TOL:g} "
          f"relative on {share_agree:.4f} of them; CPU hits "
          f"{float(ref['hit'].double().mean()):.4f} ({time.time() - t0:.1f} "
          f"s)", flush=True)
    if share_agree < MARCH_AGREE:
        fail(f"the card's 2D march agrees with the CPU port's on "
             f"{share_agree} of the rays (floor {MARCH_AGREE})")

    out, n_corr = render_fwd_bwd(card, render, m, o, d, cfg, tile_ops,
                                 chol_ops, f"2D render at {RENDER_STEPS_2D} "
                                 f"steps")
    return n_march, n_corr, (o, d, out["t_hat"], out["hit"], cfg)


def run_render_3d(card, m, frames, torch_scenes, render, tile_ops, chol_ops):
    """Phase 10: render_depth from the last ring pose at subsample 2 on the
    3D map, against the scene's noise-free ray lengths, then the march
    and the correction's backward. Returns the launches of render_depth
    and of the correction with its backward, each counted from 0 just
    before it, and the rays."""
    pose = frames[-1][1]
    tr, rot = pose[:3], pose[3:12].reshape(3, 3, order="F")
    m._factors = None               # the render fills the factor cache
    counts(tile_ops, chol_ops, reset=True)
    torch.cuda.synchronize()
    t0 = time.time()
    img = render.render_depth(m, tr, rot, subsample=2)
    wall = time.time() - t0
    n_depth = np.asarray(counts(tile_ops, chol_ops))
    truth = torch_scenes.ray_lengths(pose, m.cam, 2)
    share, good, med, p95, false, note = hit_stats(
        img["hit"], img["depth"], truth, img["var"], 0.01)
    n_rays = img["hit"].size
    print(f"phase 10: 3D render_depth from the last ring pose at subsample "
          f"2, {img['hit'].shape[1]}x{img['hit'].shape[0]} = {n_rays} rays: "
          f"{n_rays / wall:.0f} rays/s forward ({wall:.3f} s, factor-cache "
          f"fill included); of the {int(np.isfinite(truth).sum())} pixels "
          f"with a finite true depth: hit {share:.4f}, hit within 0.01 m "
          f"{good:.4f}; |t - ray length| at hits median {med:.4g} m, p95 "
          f"{p95:.4g} m ({note}); hits on the "
          f"{int((~np.isfinite(truth)).sum())} pixels without a true depth "
          f"{false}; launches tile/chol/linv {n_depth[0]}/{n_depth[1]}/"
          f"{n_depth[2]} per render ({card})", flush=True)
    if n_depth.min() < 1:
        fail(f"the 3D render launched tile/chol/linv {n_depth} times")
    if share < RENDER_HIT_3D or med > RENDER_MEDIAN_3D:
        fail(f"3D render: hit share {share} (floor {RENDER_HIT_3D}), median "
             f"error {med} m (limit {RENDER_MEDIAN_3D})")
    o, d, _ = render.camera_rays(tr, rot, m.cam, 2)
    o = torch.as_tensor(o, device=m.device)
    d = torch.as_tensor(d, device=m.device)
    cfg = render.config_from_mapper(m)
    out, n_corr = render_fwd_bwd(card, render, m, o, d, cfg, tile_ops,
                                 chol_ops, "3D render")
    return n_depth, n_corr, (o, d, out["t_hat"], out["hit"], cfg)


def check_factor_functions(card, chol_ops, n):
    """Phase 10b, chol and linv: the Functions' gradients at B=64 and this
    n vs autograd through the plain versions, and their backward times."""
    k = spd_batch(64, n, seed=n)
    gen = torch.Generator(device=k.device).manual_seed(5)
    g_out = torch.randn(k.shape, generator=gen, device=k.device)
    l_ref = chol_ops.chol_reference(k).contiguous()
    for name, fn, ref, x in (("chol", chol_ops.chol, chol_ops.chol_reference,
                              k),
                             ("linv", chol_ops.linv, chol_ops.linv_reference,
                              l_ref)):
        xk = x.clone().requires_grad_()
        yk = fn(xk)
        (gk,) = torch.autograd.grad(yk, xk, g_out, retain_graph=True)
        xr = x.clone().requires_grad_()
        yr = ref(xr)
        (gr,) = torch.autograd.grad(yr, xr, g_out, retain_graph=True)
        rel = rel_err(gk, gr)
        ms = cuda_ms(lambda: torch.autograd.grad(yk, xk, g_out,
                                                 retain_graph=True), 5)
        plain = cuda_ms(lambda: torch.autograd.grad(yr, xr, g_out,
                                                    retain_graph=True), 5)
        print(f"phase 10b: {name} Function B=64 n={n}: gradient vs autograd "
              f"through the plain version max abs err "
              f"{float((gk - gr).abs().max()):.3g} (relative {rel:.3g}, "
              f"max |gradient| {float(gr.abs().max()):.4g}); backward "
              f"{ms:.3f} ms (plain version's autograd {plain:.3f} ms) "
              f"({card})", flush=True)
        if rel > GRAD_TOL or float(gk.abs().max()) == 0.0:
            fail(f"{name} Function gradient: relative error {rel}")
        del xk, yk, xr, yr, gk, gr


def check_tile_function(card, tile_ops, captured, label):
    """Phase 10b, the tile Function on a captured tile plan with random
    upstream gradients (inactive tiles included) vs autograd through the
    plain version, and its backward time."""
    args, kwargs = captured
    d, dev = kwargs["d"], args[1].device
    gen = torch.Generator(device=dev).manual_seed(6)
    hyper0 = [torch.tensor(float(kwargs[k]), device=dev)
              for k in ("scale", "val_const", "grad_const")]
    res = []
    for fn in (tile_ops.tile_eval, tile_ops.tile_eval_reference):
        leaves = [args[i].clone().requires_grad_() for i in (1, 2, 3, 6)]
        hyper = [h.clone().requires_grad_() for h in hyper0]
        out = fn(args[0], leaves[0], leaves[1], leaves[2], args[4], args[5],
                 leaves[3], d, *hyper)
        if not res:
            g_out = [torch.randn(o.shape, generator=gen, device=dev)
                     for o in out]
        grads = torch.autograd.grad(out, leaves + hyper, g_out,
                                    retain_graph=True)
        ms = cuda_ms(lambda: torch.autograd.grad(out, leaves + hyper, g_out,
                                                 retain_graph=True), 2)
        res.append((grads, ms))
        del out, leaves, hyper
    worst = 0.0
    parts = []
    for name, gk, gr in zip(("linv", "xt", "alpha", "qt", "scale",
                             "val_const", "grad_const"), res[0][0],
                            res[1][0]):
        rel = rel_err(gk, gr)
        worst = max(worst, rel)
        parts.append(f"{name}={rel:.3g}")
        if float(gk.abs().max()) == 0.0:
            fail(f"tile Function ({label}): zero gradient of {name}")
    print(f"phase 10b: tile Function, {label}: gradient vs autograd through "
          f"the plain version, relative " + " ".join(parts)
          + f"; backward {res[0][1]:.3f} ms (plain recompute in chunks), "
          f"the plain version's autograd {res[1][1]:.3f} ms ({card})",
          flush=True)
    if worst > GRAD_TOL:
        fail(f"tile Function gradient ({label}): relative error {worst}")


def check_correction_vs_cpu(card, render, m, cpu, rays, label):
    """Phase 10b: the correction on 256 of the render's hit rays (picked
    with a seed) on the card vs the CPU port on the same map (cpu, moved
    across with runtime.checkpoint) and the same t_hat: t, f and the
    gradients of sum(t) + sum(vf) (vf carries the factors, so chol and
    linv get a gradient too) with respect to alpha and scale."""
    o, d, t_hat, hit, cfg = rays
    idx = torch.nonzero(hit).reshape(-1).cpu().numpy()
    pick = np.sort(np.random.default_rng(12).choice(idx, min(256, len(idx)),
                                                    replace=False))
    sel = torch.as_tensor(pick, device=m.device)
    gpu = correction_backward(render, m, o[sel], d[sel], t_hat[sel], cfg,
                              with_var=True)
    ref = correction_backward(render, cpu, o[sel].cpu(), d[sel].cpu(),
                              t_hat[sel].cpu(), cfg, with_var=True)
    # t and f to at least 1 (f is near 0 at a hit), the gradients to their
    # largest magnitude
    names = ("t", "f", "d/d alpha", "d/d scale")
    errs = {name: rel_err(a, b, floor)
            for name, a, b, floor in zip(names, gpu, ref, (1.0, 1.0, 0.0, 0.0))}
    # the correction divides by <g, d> and its gradient by its square, so
    # the kernel's f32 error of g weighs most at grazing rays: t's error
    # over the rays with |<g, d>| >= 0.1 alone, for reading
    denom = ref[4].abs()
    ok = denom >= 0.1
    t_ok = rel_err(gpu[0].cpu()[ok], ref[0][ok], 1.0) if ok.any() else np.nan
    print(f"phase 10b: {label} correction on {len(sel)} hit rays, card vs CPU "
          f"port: " + " ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" relative; min |<g, d>| {float(denom.min()):.3g}; t over the "
          f"{int(ok.sum())} rays with |<g, d>| >= 0.1: {t_ok:.3g} ({card})",
          flush=True)
    if max(errs.values()) > GRAD_TOL:
        fail(f"{label} correction: card and CPU differ: {errs}")
    check_grads(f"{label} correction", gpu[2], gpu[3])


def run_checkpoint_mex(card, m, frames2d, frames3d, qr, grad_const,
                       torch_scenes, checkpoint, tmp):
    """Phase 11: save the 3D map, load it into a fresh GPisMap3D(), compare
    test(); then the mex surface on the card."""
    from gpismap_tpu_torch import GPisMap3D, mex_compat

    path = os.path.join(tmp, "map3d.npz")
    checkpoint.save(m, path)
    m2 = GPisMap3D()
    checkpoint.load(m2, path)
    if m2.device.type != "cuda" or m2.num_nodes != m.num_nodes:
        fail(f"the loaded 3D map has {m2.num_nodes} nodes on {m2.device}")
    d_load = np.abs(m2.test(qr) - m.test(qr)).max(0)
    print(f"phase 11: 3D map saved and loaded into a fresh GPisMap3D() "
          f"({m2.num_nodes} nodes): test() at 4096 random points vs the "
          f"original's max abs diff " + " ".join(f"{v:.3g}" for v in d_load),
          flush=True)
    if max(d_load[:5].max(), d_load[5:].max() / grad_const) > KERNEL_TOL:
        fail(f"the loaded 3D map answers differently: {d_load}")
    del m2

    mex_compat.gpismap("reset")
    for f in frames2d[:3]:
        mex_compat.gpismap("update", *f)
    if mex_compat._gpm2.device.type != "cuda":
        fail("mex_compat.gpismap built its map off the card")
    q2 = torch_scenes.query_grid()[:4096]
    res2, dt2 = mex_compat.gpismap("test", q2.T)
    mex_compat.gpismap("reset")
    mex_compat.gpismap3("reset")
    mex_compat.gpismap3("setCamera", 1, "bigbird")
    for depth, pose in frames3d[:2]:
        mex_compat.gpismap3("update", depth, pose)
    if mex_compat._gpm3.device.type != "cuda":
        fail("mex_compat.gpismap3 built its map off the card")
    res3, dt3 = mex_compat.gpismap3("test", qr.T)
    pts = mex_compat.gpismap3("getAllPoints")
    mex_compat.gpismap3("reset")
    print(f"  mex: gpismap 3 updates, test {res2.shape} in {dt2 * 1e3:.1f} "
          f"ms; gpismap3 setCamera, 2 updates, test {res3.shape} in "
          f"{dt3 * 1e3:.1f} ms, getAllPoints {pts.shape}, reset", flush=True)
    if (res2.shape != (6, len(q2)) or res3.shape != (8, len(qr))
            or pts.ndim != 2 or pts.shape[1] != 3 or len(pts) == 0
            or not (np.isfinite(res2).all() and np.isfinite(res3).all())):
        fail(f"mex shapes: {res2.shape} {res3.shape} {pts.shape}")
    if mex_compat._gpm2 is not None or mex_compat._gpm3 is not None:
        fail("mex reset left a map behind")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_scenes
    from gpismap_tpu_torch import GPisMap2D, GPisMap3D, convert, render
    from gpismap_tpu_torch.models import cluster
    from gpismap_tpu_torch.ops import chol as chol_ops
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
    from gpismap_tpu_torch.runtime import checkpoint
    from gpismap_tpu_torch.runtime import index as index_mod

    # ---- phase 1: the card and the fp32 settings ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest'")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are enabled")

    # ---- phase 2: build from the checkout's sources, all at once ----
    t0 = time.time()
    builds = {"index": index_mod.build_library,
              "tile_eval": tile_ops.build_library,
              "chol": chol_ops.build_library}
    with ThreadPoolExecutor(len(builds)) as ex:
        futures = {name: ex.submit(fn) for name, fn in builds.items()}
        logs = {name: f.result() for name, f in futures.items()}
    print(f"phase 2: built the index, tile and chol kernel libraries in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name in ("tile_eval", "chol"):
        ptxas_lines(name, logs[name])

    dev = torch.device("cuda")
    gazebo = torch_scenes.gazebo_path()
    if gazebo:
        frames = torch_scenes.gazebo_frames(gazebo)
        print(f"scene: the real gazebo sequence, {gazebo}")
    else:
        frames = torch_scenes.floor_frames(28)
        print("scene: synthetic floor plan (tests/torch_scenes.py)")
    grid = torch_scenes.query_grid()
    if grid.shape != (49551, 2):
        fail(f"query grid has shape {grid.shape}")

    # ---- phase 3: kernels vs plain versions at production shapes, on
    # the cluster systems, tile plan and L^-1 factors of a mapped scene ----
    warm = GPisMap2D(device=dev)
    warm.update_batch(frames[:9])
    with Capture(chol_ops, "chol") as cap_fit:
        warm.update(*frames[9])
    with Capture(tile_ops, "tile_eval") as cap, \
            Capture(chol_ops, "chol") as cap_fill:
        warm.test(grid)
    args, kwargs = cap.args
    nt, mp = args[0].shape[0], args[1].shape[1]
    t = args[6].shape[-1]
    n_act = int((args[0] >= 0).sum())
    err3, _ = compare_kernel(tile_ops, cap.args)
    ms = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: tile_ops.tile_eval_reference(*args, **kwargs),
                       5)
    bound2 = tile_bound(args, kwargs)
    rate = tile_rate(tile_ops, args, kwargs, ms)
    print(f"phase 3: NT={nt} ({n_act} active) MP={mp} T={t}: max abs err "
          + " ".join(f"{k}={v:.3g}" for k, v in err3.items())
          + f"; kernel {ms:.3f} ms ({rate}), plain {plain_ms:.3f} ms, "
          f"bound {bound2[0]:.3f} ms ({bound2[1]}) ({card})", flush=True)
    print(f"  {row_shares(args, kwargs)}", flush=True)
    if max(err3.values()) > KERNEL_TOL:
        fail(f"kernel disagrees with the plain version: {err3}")
    # the fill factors what the chol wrapper was given; its L goes to linv
    systems = ([("retrain K", c[0][0]) for c in cap_fit.calls]
               + [("fill K", c[0][0]) for c in cap_fill.calls]
               + [(f"synthetic SPD", spd_batch(64, n, seed=n))
                  for n in (96, 192, 384)])
    if not cap_fit.calls or not cap_fill.calls:
        fail("the warm map's retrain or fill factored nothing")
    print("phase 3b: chol and linv vs their plain versions (linv on the "
          "plain L)", flush=True)
    rows = [check_factor_kernels(chol_ops, name, k, card)
            for name, k in systems]
    chol_err = max(r["chol_err"] for r in rows)
    linv_err = max(r["linv_err"] for r in rows)
    headline = rows[-1]                     # B=64 at MP=384
    del warm, cap, cap_fit, cap_fill, args, kwargs, systems

    # ---- phase 4: the main path at full size ----
    m = GPisMap2D(device=dev)
    with Capture(tile_ops, "tile_eval") as cap:
        tile_ops.launches = 0
        chol_ops.chol_launches = chol_ops.linv_launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        m.update_batch(frames)
        torch.cuda.synchronize()
        t_update = time.time() - t0
        upd = (chol_ops.chol_launches, chol_ops.linv_launches)
        chol_ops.chol_launches = chol_ops.linv_launches = 0
        t0 = time.time()
        res = m.test(grid)
        torch.cuda.synchronize()
        t_test = time.time() - t0
        launches = tile_ops.launches
        first = (chol_ops.chol_launches, chol_ops.linv_launches)
    t0 = time.time()
    m.test(grid)
    torch.cuda.synchronize()
    t_warm = time.time() - t0
    n_live = len(m._live_slots())
    print(f"phase 4: {m.num_nodes} nodes, {n_live} live cells after "
          f"{len(frames)} frames; update {len(frames) / t_update:.2f} "
          f"frames/s; test {len(grid) / t_test:.0f} queries/s on the first "
          f"call (factor cache fill included), {len(grid) / t_warm:.0f} "
          f"warm; tile kernel launches {launches}; chol/linv launches "
          f"{upd[0]}/{upd[1]} in update, {first[0]}/{first[1]} in the first "
          f"test ({card})", flush=True)
    if launches < 1:
        fail("test() did not launch the tile kernel")
    if upd[0] + first[0] < 1 or upd[1] + first[1] < 1:
        fail("the main path did not launch the chol and linv kernels")
    if m._factors is None:
        fail(f"test() did not use the factor cache ({n_live} live cells, "
             f"bound {m.cap.test_active_cells})")
    if res.shape != (len(grid), 6) or not np.isfinite(res).all():
        fail(f"test() output not finite of shape {(len(grid), 6)}")
    mapped = float((res[:, 3] < 1.0 + m.p.map_noise_param).mean())
    # the real sequence maps part of the grid: its floor is a guess, no
    # run has had the data yet
    floor = 0.2 if gazebo else MAPPED_FLOOR
    confident = float((res[:, 3] < m.p.test_var_thre).mean())
    print(f"  mapped share {mapped:.4f} (floor {floor}), var_f below "
          f"var_thre {confident:.4f}")
    if mapped < floor:
        fail(f"mapped share {mapped} below {floor}")

    if gazebo:
        print("  wall probes: skipped (the real scene has no floor plan)")
    else:
        check_walls(m, torch_scenes)

    err4, _ = compare_kernel(tile_ops, cap.args)
    print("  kernel vs plain on this map's tile plan: max abs err "
          + " ".join(f"{k}={v:.3g}" for k, v in err4.items()))
    if max(err4.values()) > KERNEL_TOL:
        fail(f"kernel disagrees with the plain version: {err4}")

    # the same map on the CPU through the plain version, at random points
    cpu = GPisMap2D(device="cpu")
    convert.state_from_numpy(
        m.index.serialize(),
        {f"store_{k}": v.cpu().numpy() for k, v in m.store._asdict().items()},
        m.frame, cpu)
    rng = np.random.default_rng(0)
    qr = np.stack([rng.uniform(*torch_scenes.GRID_X, 4096),
                   rng.uniform(*torch_scenes.GRID_Y, 4096)],
                  -1).astype(np.float32)
    d_cross = np.abs(m.test(qr) - cpu.test(qr)).max(0)
    print("  GPU vs CPU port at 4096 random points: max abs diff "
          + " ".join(f"{v:.3g}" for v in d_cross))
    if d_cross.max() > CROSS_TOL:
        fail(f"GPU and CPU results differ by {d_cross.max()}")

    # ---- phase 5: re-ingest the last frame with a warm factor cache: the
    # retrain refreshes the cache from its fits' L ----
    uniq = m._factors[1]
    chol_ops.chol_launches = chol_ops.linv_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    m.update(*frames[-1])
    torch.cuda.synchronize()
    t_refresh = time.time() - t0
    refresh = (chol_ops.chol_launches, chol_ops.linv_launches)
    if m._factors is None or m._factors[1] is not uniq:
        fail("the re-ingested frame dropped the factor cache instead of "
             "refreshing it")
    if refresh[0] < 1 or refresh[1] < 1:
        fail(f"the refresh launched chol/linv {refresh[0]}/{refresh[1]} "
             f"times")
    live = np.full(m.cap.test_active_cells, -1, np.int32)
    live[:len(m._factors_slots)] = m._factors_slots
    fresh, _ = cluster.factorize_slots(m.store, torch.as_tensor(live,
                                                                device=dev),
                                       m.p.map_scale_param,
                                       m.cap.test_active_cells)
    d_cache = float((m._factors[0] - fresh).abs().max())
    rel_cache = d_cache / float(fresh.abs().max())
    r_cached = m.test(qr)
    m._factors = None
    r_fresh = m.test(qr)
    d_refresh = np.abs(r_cached - r_fresh).max(0)
    print(f"phase 5: re-ingested frame in {t_refresh * 1e3:.1f} ms, "
          f"chol/linv launches {refresh[0]}/{refresh[1]}; refreshed cache "
          f"vs a fresh fill max abs diff {d_cache:.3g} (relative "
          f"{rel_cache:.3g}); test() through it vs a fresh fill at 4096 "
          f"random points: max abs diff "
          + " ".join(f"{v:.3g}" for v in d_refresh) + f" ({card})",
          flush=True)
    if rel_cache > LINV_REL_TOL:
        fail(f"refreshed factor cache differs from a fresh fill by "
             f"{rel_cache} relative")
    if d_refresh.max() > KERNEL_TOL:
        fail(f"test() through the refreshed cache differs by "
             f"{d_refresh.max()}")

    # ---- phases 6-8: the 3D path ----
    r3 = run_3d(card, torch_scenes, chol_ops, tile_ops, cluster, convert)
    m3 = r3["map"]

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phases 9-10: rendering on the maps of phases 4 and 7 ----
        cpu2 = carry_to_cpu(checkpoint, m, GPisMap2D(device="cpu"),
                            os.path.join(tmp, "map2d.npz"))
        m9, c9, rays2 = run_render_2d(card, m, cpu2,
                                      frames if gazebo else None,
                                      torch_scenes, render, tile_ops,
                                      chol_ops)
        m10, c10, rays3 = run_render_3d(card, m3, r3["frames"], torch_scenes,
                                        render, tile_ops, chol_ops)

        # ---- phase 10b: the autograd Functions vs their plain versions ----
        for n in (384, 1280):
            check_factor_functions(card, chol_ops, n)
        check_tile_function(card, tile_ops, r3.pop("tile_args"),
                            "d=3, phase 7's tile plan")
        check_tile_function(card, tile_ops, cap.args,
                            "d=2, phase 4's tile plan")
        check_correction_vs_cpu(card, render, m, cpu2, rays2, "2D")
        cpu3 = carry_to_cpu(checkpoint, m3,
                            GPisMap3D(camera=m3.cam, device="cpu"),
                            os.path.join(tmp, "map3d_cpu.npz"))
        check_correction_vs_cpu(card, render, m3, cpu3, rays3, "3D")

        # ---- phase 11: checkpoint and mex on the card ----
        run_checkpoint_mex(card, m3, frames, r3["frames"], r3["qr"],
                           m3._test_kwargs()["grad_const"], torch_scenes,
                           checkpoint, tmp)

    t2 = "gpismap_tpu/ops/pallas_tile.py:118"
    pc = "gpismap_tpu/ops/pallas_chol.py"
    h3 = r3["headline"]

    def paths(update_test, render_paths, i):
        """Launches of kernel i (0 tile, 1 chol, 2 linv) on each path, the
        update->test path first."""
        return dict([("update_test", int(update_test))]
                    + [(k, int(v[i])) for k, v in render_paths])

    r2d = (("render_2d_march", m9), ("render_2d_correction_backward", c9))
    r3d = (("render_3d_depth", m10), ("render_3d_correction_backward", c10))
    kernels = [
        kernel_entry("tile_eval (d=2)", t2, paths(launches, r2d, 0),
                     max(max(err3.values()), max(err4.values())), ms,
                     plain_ms, bound2, None),
        kernel_entry("tile_eval (d=3)", t2,
                     paths(r3["tile_launches"], r3d, 0), r3["tile_err"],
                     r3["tile_ms"], r3["tile_plain_ms"], r3["tile_bound"],
                     None),
        kernel_entry("chol (n=384)", f"{pc}:167",
                     paths(upd[0] + first[0] + refresh[0], r2d, 1), chol_err,
                     headline["chol_ms"], headline["chol_plain_ms"],
                     headline["bound"], headline["chol_library_ms"]),
        kernel_entry("chol (n=1280)", f"{pc}:167",
                     paths(r3["chol_launches"], r3d, 1), r3["chol_err"],
                     h3["chol_ms"], h3["chol_plain_ms"], h3["bound"],
                     h3["chol_library_ms"]),
        kernel_entry("linv (n=384)", f"{pc}:188",
                     paths(upd[1] + first[1] + refresh[1], r2d, 2), linv_err,
                     headline["linv_ms"], headline["linv_plain_ms"],
                     headline["bound"], headline["linv_library_ms"]),
        kernel_entry("linv (n=1280)", f"{pc}:188",
                     paths(r3["linv_launches"], r3d, 2), r3["linv_err"],
                     h3["linv_ms"], h3["linv_plain_ms"], h3["bound"],
                     h3["linv_library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
