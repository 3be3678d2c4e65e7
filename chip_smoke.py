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
  refresh from the fits' own Cholesky factors. Phase 4b: the 2D frame
  kernel (csrc/obsgp1d_frame.cu, one launch a frame for the re-evaluation
  and the new measurements) against its plain versions on every frame of
  phase 4 (tests/torch_frame_checks.py), timed, and the update's frame
  stage profiled: its torch operations, kernel launches and its one
  device-to-host copy. When $GPISMAP_DATA holds
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
  autograd Functions; the tile backward's own kernels,
  csrc/tile_eval_backward.cu, counted). Then each Function's gradient
  against autograd through its plain version (chol/linv at B=64, n=384
  and 1280; the tile kernel on phases 7's and 4's tile plans, where the
  backward kernels are also held to their twin tile_eval_vjp_reference,
  bitwise in two runs, timed against the autograd recompute
  tile_eval_backward and plain autograd, and run without a cotangent of
  the variances, where the Z and dL kernels must not launch), the
  correction on 256 hit rays
  against the CPU port on the same map, moved across with
  runtime.checkpoint; the 3D map saved and loaded into a fresh
  GPisMap3D(); and the mex front end (mex_compat) on the card.

  The card's branches and the other modes (phases 12-15). On the card
  the 3D update takes the compacted obs fit and sweep by default, so
  phase 7 runs them, and its GPU-vs-CPU check holds them against the
  CPU's dense path; test() takes the window unless GPISMAP_NBR_TABLE=1,
  and the blocked sweep runs only with GPISMAP_OBS_BLOCKED=1.
  Phase 12: frame_compute_3d on each of the 40 frames three ways (the
  dense sweep, the cell-blocked sweep, the compacted fit and sweep):
  insert_ok equal, compacted equal to dense to the last bit; the blocked
  sweep equal to the gather within F64_TOL when both run in float64, its
  float32 normals and noises closer to the gather's than the gather's
  own float32 error, its posteriors within KERNEL_TOL of the gather's,
  its positions and median differences within the JAX package's bounds,
  every probe within one cell of its pixel's cell; 12b, the 3D update
  with each sweep (the compacted map equal to the dense map to the last
  bit). Phase 13: test() through the candidate table
  (GPISMAP_NBR_TABLE=1) vs the window on the maps of phases 4 and 7,
  equal to the last bit, no overflow. Phase 14: map_test(two_phase)
  vs single phase on both maps, equal to the last bit. Phase 15: 2D
  strict_reeval=True and 3D "strict", "fused" and "snapshot" on the same
  frames, each held to the default mode's mapped-share and SDF-sign
  floors, its agreement with the default map printed.

  The mesh (phase 16), each part in child processes of this script
  (`chip_smoke.py --mesh-child ...`; a failed child fails the run):
  16a, one rank of an NCCL process group on the card: GPisMap2D(mesh=)
  on the 28 frames and the grid and GPisMap3D(mesh=) on the 40 frames
  and the volume, each then ingesting its last frame again (the mesh's
  retrain keeps no Cholesky factor, so the factor cache re-factorizes
  through cluster.update_factors, in 3D at n=640 and n=1280), held
  against the single-device maps of phases 4-5 and 7-8 (equal node
  counts, fields within MESH_RTOL/MESH_ATOL; the first test(), before
  any refresh, bitwise equal), and sharded_map_test on
  phase 8's map against map_test; 16b, the same on two gloo ranks
  sharing the card, their collectives staged through host memory, with
  the replicas' digests compared through a collective and each rank's
  peak memory; 16c, in this process, update_factors at the 3D refresh
  bucket (n=640) and at full size (n=1280) against a fresh fill, and the
  3D update with GPISMAP_NODE_MIRROR=0 against phases 7-8 (the first
  test() bitwise equal, after the refresh MESH_RTOL/MESH_ATOL).

  The bf16 variant (phase 17): 17a, the bf16 tile kernel
  (csrc/tile_eval_bf16.cu) on the tile plans of phases 4 (d=2) and 7
  (d=3) against the bf16 plain version and the packed one
  (ops/tile_eval.py:tile_eval_packed_reference), each variance within
  its limit (tests/torch_bf16_checks.variance_limits: KERNEL_TOL of its
  column's f32 summation scale plus a bf16 step of each K* entry that
  two correct f32 evaluations may round to different bf16 values), f and
  g bitwise the f32 kernel's, the variances off the f32 kernel's
  somewhere (their distance printed beside the plain versions'),
  launches counted apart, bitwise deterministic and independent of the
  order of the tiles, the kept-stage share printed; then three synthetic
  d=3 plans (BF16_PLANS: a full cell, 80 kept stages; empty cells;
  cells with gradient-free nodes) against both plain versions; 17b,
  test() with GPISMAP_PALLAS_BF16=1 on the maps of phases 4 and 7: only
  the bf16 kernel launched, the queries whose var_thre blend choice
  flipped counted, the queries that take the nearest cell's result in
  both runs held to f and g bitwise against the default test() (their
  variances' distance printed) and to their variances' limits against
  test() with the bf16 plain version as its tile op, and the warm test()
  timed with the switch on and off.

Usage: python3 chip_smoke.py    (from the repository root; needs CUDA)

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the one
before that lists each kernel at each shape of the two paths with its
launches on the update->test path (`launches`) and on each path apart
(`launches_by_path`: update->test, the gated render march or
render_depth, the correction with its backward, and the paths of phases
12-15; each counted from 0 just before that path ran), its error against
the plain
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
# a mapper on a mesh vs the single-device mapper over the same frames:
# the mesh's retrain keeps no Cholesky factor, so its factor cache is
# refreshed by re-factorizing, which rounds differently from inverting
# the fit's L (the JAX package's tests/test_parallel.py:90-95 tolerances)
MESH_RTOL = 1e-4
MESH_ATOL = 5e-4
# sharded_map_test vs map_test on one store (tests/test_parallel.py:66-69)
SHARDED_TOL = 1e-5
# the bf16 variant (phase 17): the bf16 kernel's variances against the
# bf16 plain version's are held to a limit per variance
# (tests/torch_bf16_checks.variance_limits): KERNEL_TOL of the column's
# f32 summation scale, plus one bf16 step of each K* entry that two
# correct f32 evaluations may round to different bf16 values. The JAX
# package's gate of the bf16 variances against the f32 ones
# (tests/test_pallas.py:76-78) is printed, for the kernel and for the
# plain version: the JAX package set it on a random M=16 case, and on the
# smoke's maps the bf16 function itself (the plain versions) exceeds it
# (PERF.md)
BF16_VF_TOL = 2e-2
BF16_VG_TOL = 5e-2

# peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet): fp32
# outside the tensor cores (every kernel here is fp32 FMAs) and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# dense bf16 on the tensor cores (the bf16 variant's variance product)
PEAK_BF16_FLOPS = 989e12
# fp32 operations the bf16 variant needs beside its product: per (kept
# support node, query) pair the terms its (1 + D)^2 K* entries share, the
# squared distance (3D - 1), sqrt, a r and exp (2), 1 + a r, a^2 e and
# a^3 e / r (4); per K* entry its formula from those terms (about 2: a
# product with a difference), the mean's and the square's multiply-adds
# (2 each)
PAIR_FLOPS = {d: 3 * d + 6 for d in (2, 3)}
ENTRY_FLOPS = 6
# fp32 operations of the tile backward per unmasked K* entry beside its
# products (tile_bwd_work), a lower count of what its formulas need: dK*
# = alpha gF - 2 Y (a product and a multiply-add), the multiply-adds of
# the chain into dx, dq (D each), d a and d alpha (2 flops each), and one
# product per derivative (D + 1)
BWD_ENTRY_FLOPS = {d: 3 + 2 * (2 * d + 2) + d + 1 for d in (2, 3)}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    """The release line of `nvcc --version` of the toolkit the kernels
    build with."""
    from gpismap_tpu_torch import _native
    out = subprocess.run([_native.NVCC[0], "--version"], capture_output=True,
                         text=True, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else out.strip().splitlines()[-1]


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


class BySize:
    """Splits the chol and linv wrappers' own launch counts by the matrix
    size n of each call, while the with block lasts."""

    def __init__(self, chol_ops):
        self.ops = chol_ops
        self.counts = {}

    def _wrap(self, name, counter):
        orig = getattr(self.ops, name)

        def call(x):
            before = getattr(self.ops, counter)
            out = orig(x)
            key = (name, int(x.shape[-1]))
            self.counts[key] = (self.counts.get(key, 0)
                                + getattr(self.ops, counter) - before)
            return out
        return orig, call

    def __enter__(self):
        self.orig = {}
        for name in ("chol", "linv"):
            self.orig[name], call = self._wrap(name, name + "_launches")
            setattr(self.ops, name, call)
        return self

    def __exit__(self, *exc):
        for name, orig in self.orig.items():
            setattr(self.ops, name, orig)

    def at(self, name: str, n: int) -> int:
        return self.counts.get((name, n), 0)


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


def tile_work_bf16(args, kwargs):
    """(bf16 tensor-core operations, fp32 operations, bytes) that the bf16
    variant needs on these inputs: the variance product over each active
    tile's n unmasked rows of L^-1's lower triangle; per kept node and
    query PAIR_FLOPS, per K* entry ENTRY_FLOPS (T(1+D) columns of n
    entries); tile_work's bytes (L^-1 is read as f32 in both)."""
    tile_seg, valid, t = args[0], args[5], args[6].shape[-1]
    d = kwargs["d"]
    segs = tile_seg[tile_seg >= 0].long()
    n = unmasked_rows(args, kwargs)
    nodes = (valid > 0.5).sum(-1).double()
    tensor = 2.0 * t * (1 + d) * float((n * (n + 1) / 2)[segs].sum())
    fp32 = t * (PAIR_FLOPS[d] * float(nodes[segs].sum())
                + ENTRY_FLOPS * (1 + d) * float(n[segs].sum()))
    return tensor, fp32, tile_work(args, kwargs)[1]


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


def tile_bound_bf16(args, kwargs):
    """The bf16 variant's least time on these inputs: the variance
    product at the tensor cores' bf16 rate plus the K* entries, mean and
    squares at the fp32 rate, or the bytes at the memory rate
    (tile_work_bf16): (ms, "operations" or "bytes")."""
    tensor, fp32, nbytes = tile_work_bf16(args, kwargs)
    t_ops = tensor / PEAK_BF16_FLOPS + fp32 / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


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
                 library_ms, main="update_test", **extra):
    """One kernel of the kernels line: `launches` is its count on its main
    path (the update->test path, or the bf16 variant's test() with the
    switch on), `launches_by_path` its count on each path, each counted
    from 0 just before that path ran; `extra` keys are added as given."""
    source = next(src for key, src in (
        ("tile_eval_bf16", "gpismap_tpu_torch/csrc/tile_eval_bf16.cu"),
        ("tile_eval_backward",
         "gpismap_tpu_torch/csrc/tile_eval_backward.cu"),
        ("tile_eval", "gpismap_tpu_torch/csrc/tile_eval.cu"),
        ("obsgp1d_frame", "gpismap_tpu_torch/csrc/obsgp1d_frame.cu"),
        ("", "gpismap_tpu_torch/csrc/chol.cu")) if name.startswith(key))
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches_by_path[main],
            "launches_by_path": launches_by_path, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": library_ms, **extra}


def ptxas_lines(name: str, log: str):
    """The register / spill / shared-memory lines of nvcc's -Xptxas -v
    report, each labelled with its kernel (and the tile kernels'
    dimension), printed and returned. Dynamic shared memory is not in it:
    phases 3, 6 and 17 print the tile kernels'."""
    fn = name
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = next((label for key, label in (
                ("tile_eval_bf16_kernelILi2E", "tile_eval_bf16 d=2"),
                ("tile_eval_bf16_kernelILi3E", "tile_eval_bf16 d=3"),
                ("tile_bwd_z_kernelILi2E", "tile_bwd_z d=2"),
                ("tile_bwd_z_kernelILi3E", "tile_bwd_z d=3"),
                ("tile_bwd_kstar_kernelILi2E", "tile_bwd_kstar d=2"),
                ("tile_bwd_kstar_kernelILi3E", "tile_bwd_kstar d=3"),
                ("tile_bwd_linv_kernelILi2E", "tile_bwd_linv d=2"),
                ("tile_bwd_linv_kernelILi3E", "tile_bwd_linv d=3"),
                ("tile_eval_kernelILi2E", "tile_eval d=2"),
                ("tile_eval_kernelILi3E", "tile_eval d=3"),
                ("chol_init_kernel", "chol_init_kernel"),
                ("chol_panel_kernel", "chol_panel_kernel"),
                ("chol_update_kernel", "chol_update_kernel"),
                ("linv_diag_kernel", "linv_diag_kernel"),
                ("linv_merge_ca_kernel", "linv_merge_ca_kernel"),
                ("linv_merge_x_kernel", "linv_merge_x_kernel"),
                ("obsgp1d_frame_kernel", "obsgp1d_frame_kernel"))
                if key in line), name)
        if "registers" in line or "spill" in line or "smem" in line:
            out.append(f"ptxas ({fn}): {line.strip()}")
            print(f"  {out[-1]}")
    return out


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


def frame_stage_counts(m, frame):
    """The torch operations, kernel launches and device-to-host copies
    that the 2D update's frame stage (span gpismap.update.frame) issues
    on one update(frame), from a torch.profiler trace: (ops, launches,
    d2h), None where the trace shows no such event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.update(*frame)
        torch.cuda.synchronize()
    evs = prof.events()
    spans_ = [e for e in evs if e.name == "gpismap.update.frame"]
    if not spans_:
        return None, None, None
    sp = spans_[0]
    t0, t1 = sp.time_range.start, sp.time_range.end

    def within(e):
        return t0 <= e.time_range.start and e.time_range.end <= t1

    cpu = [e for e in evs if e.device_type == DeviceType.CPU and within(e)]
    ops = sum(1 for e in cpu if e.cpu_parent is sp)
    launches = sum(1 for e in cpu if e.name.startswith(("cudaLaunchKernel",
                                                         "cuLaunchKernel")))
    d2h = sum(1 for e in evs if e.device_type == DeviceType.CUDA
              and "DtoH" in e.name and within(e))
    return ops, launches, d2h


def d2h_copies(fn) -> int:
    """Device-to-host copies on the card while fn() runs, from a
    torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and "DtoH" in e.name)


def run_frame_kernel(card, calls, m, frame, mapper2d, frame_ops):
    """Phase 4b: the 2D frame kernel (csrc/obsgp1d_frame.cu) against the
    plain versions (reeval_2d_reference, newmeas_2d_reference) on the
    card, on the arguments of every frame_update_2d of phase 4 (1,081
    beams padded to 2,048, g_max 104, nodes padded to a power of two),
    held to tests/torch_frame_checks.check_frame; timed at the last
    frame's shapes; then the frame stage of one more update() of m
    profiled: its torch operations, kernel launches and device-to-host
    copies, one for the results beside the obs-GP fit's own. Returns the
    kernels line's numbers."""
    import torch_frame_checks as fc
    from gpismap_tpu_torch.models import obsgp

    worst = {}
    for args, kwargs in calls:
        got = mapper2d.frame_update_2d(*args, g_max=kwargs["g_max"])
        want = fc.plain_frame(args, kwargs["g_max"])
        c = fc.compare_frame(got, want, args[8].cpu().numpy())
        try:
            fc.check_frame(c)
        except AssertionError:
            fail(f"phase 4b: the frame kernel disagrees with the plain "
                 f"versions: {c}")
        for k, v in c.items():
            if isinstance(v, float):
                worst[k] = (min if "agree" in k else max)(worst.get(k, v), v)
    th, rg, tr, rot, pos, grad, ps, gs, valid, mp, op = calls[-1][0]
    prep = mapper2d.preprocess_2d(th, rg, tr, rot, mp)
    obs = obsgp.fit_obsgp1d(prep.theta, prep.f, prep.valid, op,
                            g_max=calls[-1][1]["g_max"])
    nodes = (pos, grad, ps, gs, valid)
    beams = mapper2d._beams(prep)
    ms = cuda_ms(lambda: mapper2d._frame_kernel(obs, nodes, beams, tr, rot,
                                                 mp, op), 200)
    plain_ms = cuda_ms(lambda: (
        mapper2d.reeval_2d_reference(obs, *nodes, tr, rot, mp, op),
        mapper2d.newmeas_2d_reference(obs, prep, rot, mp, op)), 10)
    k, n = pos.shape[0], th.shape[0]
    g, mm = obs.x.shape[0], obs.x.shape[1]
    rv, _ = mapper2d.frame_update_2d(*calls[-1][0],
                                     g_max=calls[-1][1]["g_max"])
    # posteriors: 1 + steps + 4 a node, 5 a beam; each m K* entries
    # (difference, square, sqrt, scale, exp), the mean (2 m), L^-1 K*
    # (2 m^2) and its squared norm (2 m)
    evals = 5 * (k + n) + int(rv.steps.sum())
    flops = evals * (2 * mm * mm + 9 * mm)
    # read once: the groups' x, valid, alpha, L^-1, trained, bounds, the
    # nodes' and beams' inputs; written once: the packed frame
    nbytes = (g * mm * 9 + g * mm * mm * 4 + g + (g + 1) * 4
              + k * (25 + 4 * frame_ops.NODE_WORDS)
              + n * (25 + 4 * frame_ops.BEAM_WORDS))
    bnd = bound(flops, nbytes)
    ops, launches, d2h = frame_stage_counts(m, frame)
    print(f"phase 4b: 2D frame kernel vs the plain versions on {len(calls)} "
          f"frames: action agreement {worst['action_agree']:.4f} (steps "
          f"{worst['steps_agree']:.4f}), insert agreement "
          f"{worst['insert_agree']:.4f}; on the re-inserted nodes max abs "
          f"pos {worst['pos']:.3g} grad {worst['grad']:.3g}, relative noise "
          f"{worst['noise']:.3g} grad_noise {worst['grad_noise']:.3g}; on "
          f"the inserted beams grad {worst['new_grad']:.3g} noise "
          f"{worst['new_noise']:.3g} grad_noise {worst['new_grad_noise']:.3g}"
          f"; at K={k} N={n} G={g} M={mm}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}); the update's "
          f"frame stage: {ops} torch ops, {launches} kernel launches, {d2h} "
          f"device-to-host copies ({card})", flush=True)
    # the obs-GP fit's own copies (torch.linalg.cholesky's error check)
    # apart, the frame stage reads its results back in one copy
    fit_d2h = d2h_copies(lambda: obsgp.fit_obsgp1d(
        prep.theta, prep.f, prep.valid, op, g_max=calls[-1][1]["g_max"]))
    print(f"  the obs-GP fit alone: {fit_d2h} device-to-host copies",
          flush=True)
    if d2h is not None and d2h - fit_d2h != 1:
        fail(f"phase 4b: the frame stage made {d2h} device-to-host copies, "
             f"the obs-GP fit {fit_d2h}")
    err = max(worst[k] for k in ("pos", "grad", "new_pos", "new_grad"))
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=bnd,
                stage_ops=ops, stage_launches=launches, stage_d2h=d2h,
                fit_d2h=fit_d2h,
                action_agree=worst["action_agree"],
                insert_agree=worst["insert_agree"])


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
               headline=rows[-1],                   # B=64 at MP=1280
               row640=rows[-2])                     # B=64 at MP=640
    del warm, cap, cap_fit, cap_fill, args, kwargs, systems

    # ---- phase 7: the 3D main path at full size, on the default device ----
    m = GPisMap3D()
    if m.device.type != "cuda":
        fail(f"GPisMap3D() runs on {m.device}, not the card")
    m.set_camera(1, "bigbird")
    tile_ops.launches = tile_ops.launches_bf16 = 0
    chol_ops.chol_launches = chol_ops.linv_launches = 0
    by_size = BySize(chol_ops).__enter__()    # to phase 8's update
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
    tst16 = tile_ops.launches_bf16
    if tst16:
        fail("the default 3D path launched the bf16 tile kernel")
    if upd[1] + tst[1] < 1 or upd[2] + tst[2] < 1:
        fail("the 3D main path did not launch the chol and linv kernels")
    if m._factors is None:
        fail(f"test() did not use the factor cache ({n_live} live cells, "
             f"bound {m.cap.test_active_cells})")
    if not m._obs_compact() or m._obs_blocked() or m._nbrs is not None:
        fail("the 3D map did not take the card's defaults (the compacted "
             "obs fit and sweep, test() through the window)")
    print("  the card's defaults: the compacted obs fit and sweep, test() "
          "through the window")
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
    by_size.__exit__()
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
    out.update(tile_launches=tst[0], tile_bf16_launches=tst16,
               chol_launches=upd[1] + tst[1] + refresh[0],
               linv_launches=upd[2] + tst[2] + refresh[1],
               chol640_launches=by_size.at("chol", 640),
               linv640_launches=by_size.at("linv", 640),
               map=m, frames=frames, qr=qr, res=res)
    return out


def counts(tile_ops, chol_ops, reset: bool = False):
    """(tile, chol, linv) launch counts; reset=True sets them to 0 first."""
    if reset:
        tile_ops.launches = 0
        chol_ops.chol_launches = chol_ops.linv_launches = 0
    return (tile_ops.launches, chol_ops.chol_launches, chol_ops.linv_launches)


def bwd_counts(tile_ops, reset: bool = False):
    """The tile backward kernels' launches (z, kstar, linv); reset=True
    sets them to 0 first."""
    if reset:
        tile_ops.launches_backward = 0
        for k in tile_ops.launches_backward_by_kernel:
            tile_ops.launches_backward_by_kernel[k] = 0
    by = tile_ops.launches_backward_by_kernel
    return np.asarray([by["z"], by["kstar"], by["linv"]])


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
    CUDA kernels. Returns the march's output, the launches of the second
    call's correction and backward (tile/chol/linv) and its tile backward
    kernels' (z/kstar/linv), each counted from 0 just before it."""
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
        bwd_counts(tile_ops, reset=True)
        _, _, g_alpha, g_scale, _ = correction_backward(
            render, m, o[idx], d[idx], out["t_hat"][idx], cfg)
        torch.cuda.synchronize()
        n = np.asarray(counts(tile_ops, chol_ops))
        nb = bwd_counts(tile_ops)
        walls.append((time.time() - t0, time.time() - t1))
        check_grads(label, g_alpha, g_scale)
    print(f"  {label}: forward+backward {len(o) / walls[1][0]:.0f} rays/s "
          f"({walls[1][0]:.3f} s: the march, then {walls[1][1]:.3f} s for the "
          f"correction of the {len(idx)} hit rays with their cells factored "
          f"anew and its backward; the first call {walls[0][0]:.3f} s, "
          f"{walls[0][1]:.3f} s of it in the correction and backward); "
          f"launches tile/chol/linv {n[0]}/{n[1]}/{n[2]} in the correction "
          f"and its backward, of the tile backward kernels z/kstar/linv "
          f"{nb[0]}/{nb[1]}/{nb[2]}; d sum(t)/d scale {float(g_scale):.6g}, "
          f"max |d sum(t)/d alpha| {float(g_alpha.abs().max()):.6g} "
          f"({card})",
          flush=True)
    if n.min() < 1 or nb[1] < 1:
        fail(f"{label}: the correction and its backward launched "
             f"tile/chol/linv {n} times, the tile backward kernels "
             f"z/kstar/linv {nb}")
    return out, n, nb


def run_render_2d(card, m, cpu, frames, torch_scenes, render, tile_ops,
                  chol_ops):
    """Phase 9: sphere_trace of every beam of the 28 poses on the 2D map,
    against the floor plan's noise-free ranges (a real sequence has no
    floor plan: its beams are marched, not gated), the card's march
    against the CPU port's on every 32nd beam, then the correction's
    backward. Returns the launches of the march and of the correction
    with its backward, and of the tile backward kernels there, each
    counted from 0 just before it, and the rays."""
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

    out, n_corr, n_bwd = render_fwd_bwd(card, render, m, o, d, cfg, tile_ops,
                                        chol_ops, f"2D render at "
                                        f"{RENDER_STEPS_2D} steps")
    return n_march, n_corr, n_bwd, (o, d, out["t_hat"], out["hit"], cfg)


def run_render_3d(card, m, frames, torch_scenes, render, tile_ops, chol_ops):
    """Phase 10: render_depth from the last ring pose at subsample 2 on the
    3D map, against the scene's noise-free ray lengths, then the march
    and the correction's backward. Returns the launches of render_depth
    and of the correction with its backward, and of the tile backward
    kernels there, each counted from 0 just before it, and the rays."""
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
    out, n_corr, n_bwd = render_fwd_bwd(card, render, m, o, d, cfg, tile_ops,
                                        chol_ops, "3D render")
    return n_depth, n_corr, n_bwd, (o, d, out["t_hat"], out["hit"], cfg)


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


def tile_bwd_work(args, kwargs):
    """(fp32 operations, bytes) that the tile evaluation's VJP needs on
    these inputs with every cotangent nonzero: per active tile, with n its
    cell's unmasked_rows and T(1+D) K* columns, per column V and Y =
    L^-T Z over those rows of L^-1's lower triangle (n(n+1)/2
    multiply-adds each), dL over all n^2 pairs of them and d alpha (n);
    per unmasked K* entry BWD_ENTRY_FLOPS (its derivatives and their
    chain); bytes: tile_work's inputs, the cotangents of the outputs
    (tile_work's outputs), and the gradients written: dL over each used
    cell's n^2 entries, dx, d alpha and dq."""
    tile_seg, _, xt, _, _, _, qt = args
    d = kwargs["d"]
    m, t = xt.shape[-1], qt.shape[-1]
    segs = tile_seg[tile_seg >= 0].long()
    cells = torch.unique(segs)
    n = unmasked_rows(args, kwargs)
    per_col = n * (n + 1) + n * n + n
    flops = (2.0 * t * (1 + d) * float(per_col[segs].sum())
             + BWD_ENTRY_FLOPS[d] * t * (1 + d) * float(n[segs].sum()))
    nbytes = (tile_work(args, kwargs)[1]
              + 4.0 * (float((n * n)[cells].sum())
                       + cells.numel() * (d + 1 + d) * m
                       + segs.numel() * t * d))
    return flops, nbytes


def device_breakdown(fn, reps: int):
    """{kernel name: (device ms per call, launches per call)} of fn() over
    reps calls from a torch.profiler (CUPTI) trace, the largest first;
    empty, with the reason printed, if the profiler does not trace the
    card."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3 / reps,
                 e.count / reps) for e in prof.key_averages()]
    except RuntimeError as e:
        print(f"  the profiler did not trace the card: {e}", flush=True)
        return {}
    return {k: (ms, n) for k, ms, n in sorted(rows, key=lambda r: -r[1])
            if ms > 0}


def check_tile_function(card, tile_ops, captured, label):
    """Phase 10b, the tile Function on a captured tile plan with random
    upstream gradients (inactive tiles included): its gradients (the
    backward kernels) vs autograd through the plain version (GRAD_TOL);
    the kernels (_launch_backward) vs their plain twin
    tile_eval_vjp_reference (KERNEL_TOL of each gradient's largest
    magnitude) and bitwise in two runs; the backward timed three ways in
    turns: the kernels (through the Function), the autograd recompute
    tile_eval_backward (the card's backward before the kernels) and plain
    autograd through tile_eval_reference; then the gradient of (f, g)
    alone (no cotangent of the variances), where the Z and dL kernels must
    not launch and dL is exactly zero. Returns the numbers of the kernels
    line's row."""
    args, kwargs = captured
    d, dev = kwargs["d"], args[1].device
    gen = torch.Generator(device=dev).manual_seed(6)
    hyper0 = [torch.tensor(float(kwargs[k]), device=dev)
              for k in ("scale", "val_const", "grad_const")]
    names = ("linv", "xt", "alpha", "qt", "scale", "val_const", "grad_const")
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
        res.append(dict(grads=grads, out=out, wrt=leaves + hyper))
    worst = 0.0
    parts = []
    for name, gk, gr in zip(names, res[0]["grads"], res[1]["grads"]):
        rel = rel_err(gk, gr)
        worst = max(worst, rel)
        parts.append(f"{name}={rel:.3g}")
        if float(gk.abs().max()) == 0.0:
            fail(f"tile Function ({label}): zero gradient of {name}")

    # the kernels against their twin, twice
    hyper = [h.clone() for h in hyper0]
    bwd_counts(tile_ops, reset=True)
    k1 = tile_ops._launch_backward(*args, d, *hyper, g_out)
    k2 = tile_ops._launch_backward(*args, d, *hyper, g_out)
    torch.cuda.synchronize()
    n_bwd = bwd_counts(tile_ops) // 2
    twin = tile_ops.tile_eval_vjp_reference(*args, d, *hyper, g_out)
    torch.cuda.synchronize()
    twin_rel = {n: rel_err(a, b) for n, a, b in zip(names, k1, twin)}
    twin_abs = max(float((a - b).abs().max()) for a, b in zip(k1, twin))
    same = all(torch.equal(a, b) for a, b in zip(k1, k2))

    # the three backwards in turns
    fwd, ref = res
    def recompute():
        return tile_ops.tile_eval_backward(*args, d, *hyper, g_out)

    ms = {}
    for key, fn in (("kernels", lambda: torch.autograd.grad(
                        fwd["out"], fwd["wrt"], g_out, retain_graph=True)),
                    ("recompute", recompute),
                    ("autograd", lambda: torch.autograd.grad(
                        ref["out"], ref["wrt"], g_out, retain_graph=True)),
                    ("kernels again", lambda: torch.autograd.grad(
                        fwd["out"], fwd["wrt"], g_out, retain_graph=True))):
        ms[key] = cuda_ms(fn, 2)
    parts_ms = device_breakdown(lambda: torch.autograd.grad(
        fwd["out"], fwd["wrt"], g_out, retain_graph=True), 2)
    del res, fwd, ref, k1, k2, twin

    # no cotangent of the variances: (f, g) alone
    leaves = [args[i].clone().requires_grad_() for i in (1, 2, 3, 6)]
    hl = [h.clone().requires_grad_() for h in hyper0]
    out = tile_ops.tile_eval(args[0], leaves[0], leaves[1], leaves[2],
                             args[4], args[5], leaves[3], d, *hl)
    bwd_counts(tile_ops, reset=True)
    g_fg = torch.autograd.grad(out[:2], leaves + hl, g_out[:2])
    torch.cuda.synchronize()
    n_fg = bwd_counts(tile_ops)
    leaves_r = [args[i].clone().requires_grad_() for i in (2, 3, 6)]
    sc_r = hyper0[0].clone().requires_grad_()
    out_r = tile_ops.tile_eval_reference(args[0], args[1], leaves_r[0],
                                         leaves_r[1], args[4], args[5],
                                         leaves_r[2], d, sc_r, *hyper0[1:])
    want_fg = torch.autograd.grad(out_r[:2], leaves_r + [sc_r], g_out[:2])
    fg_rel = max(rel_err(a, b) for a, b in zip(
        [g_fg[i] for i in (1, 2, 3, 4)], want_fg))
    fg_zero = (float(g_fg[0].abs().max()) == 0.0
               and float(g_fg[5]) == 0.0 and float(g_fg[6]) == 0.0)

    print(f"phase 10b: tile Function, {label}: gradient vs autograd through "
          f"the plain version, relative " + " ".join(parts)
          + f"; the backward kernels vs tile_eval_vjp_reference, relative "
          + " ".join(f"{k}={v:.3g}" for k, v in twin_rel.items())
          + f" (max abs {twin_abs:.3g}), two runs "
          f"{'bitwise equal' if same else 'DIFFER'}, launches per backward "
          f"z/kstar/linv {n_bwd[0]}/{n_bwd[1]}/{n_bwd[2]}; backward ms: the "
          f"kernels {ms['kernels']:.3f} and {ms['kernels again']:.3f}, the "
          f"recompute (tile_eval_backward) {ms['recompute']:.3f}, plain "
          f"autograd {ms['autograd']:.3f} ({card})", flush=True)
    print("  the kernels' backward by device time (profiler, ms per "
          "backward, launches): " + "; ".join(
              f"{k[:60]} {v[0]:.3f} ({v[1]:g})"
              for k, v in list(parts_ms.items())[:8]), flush=True)
    print(f"  (f, g) alone: launches z/kstar/linv {n_fg[0]}/{n_fg[1]}/"
          f"{n_fg[2]}; dL and the constants' gradients exactly zero: "
          f"{fg_zero}; xt, alpha, qt, scale vs autograd through the plain "
          f"version, relative {fg_rel:.3g}", flush=True)
    if worst > GRAD_TOL:
        fail(f"tile Function gradient ({label}): relative error {worst}")
    if max(twin_rel.values()) > KERNEL_TOL or not same:
        fail(f"tile backward kernels ({label}) vs their twin: {twin_rel}, "
             f"bitwise in two runs: {same}")
    if n_bwd.min() < 1:
        fail(f"tile backward ({label}): launches z/kstar/linv {n_bwd}")
    if n_fg[0] or n_fg[2] or n_fg[1] < 1 or not fg_zero or fg_rel > GRAD_TOL:
        fail(f"tile backward ({label}) of (f, g) alone: launches "
             f"z/kstar/linv {n_fg}, zero dL and constants {fg_zero}, "
             f"relative error {fg_rel}")
    if ms["kernels"] >= ms["recompute"]:
        fail(f"tile backward ({label}): the kernels ({ms['kernels']} ms) "
             f"are not faster than the recompute ({ms['recompute']} ms)")
    return dict(err=twin_abs, rel=max(twin_rel.values()),
                ms=ms["kernels"], ms_again=ms["kernels again"],
                recompute_ms=ms["recompute"], plain_ms=ms["autograd"],
                bound=bound(*tile_bwd_work(args, kwargs)))


def recompute_backward(tile_ops):
    """A stand-in for ops.tile_eval._launch_backward that runs the
    autograd recompute tile_eval_backward (the card's tile backward
    before the kernels; undefined cotangents as zeros), for the readings
    that set the kernels beside it."""
    def run(*args):
        *inputs, grads, needs = args
        qt, d = inputs[6], inputs[7]
        nt, _, t = qt.shape
        grads = [g if g is not None else qt.new_zeros(
            (nt, t) if i % 2 == 0 else (nt, d, t))
                 for i, g in enumerate(grads)]
        return tile_ops.tile_eval_backward(*inputs, grads, needs)
    return run


def check_correction_vs_cpu(card, render, m, cpu, rays, label, tile_ops):
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
    # where the error lies: the rays with |<g, d>| >= 0.1 alone (their
    # own correction and backward), and all the rays with the card's
    # tile backward by the autograd recompute in place of the kernels
    sub = sel[ok.to(sel.device)]
    gpu_ok = correction_backward(render, m, o[sub], d[sub], t_hat[sub], cfg,
                                 with_var=True)
    ref_ok = correction_backward(render, cpu, o[sub].cpu(), d[sub].cpu(),
                                 t_hat[sub].cpu(), cfg, with_var=True)
    orig = tile_ops._launch_backward
    tile_ops._launch_backward = recompute_backward(tile_ops)
    try:
        gpu_rc = correction_backward(render, m, o[sel], d[sel], t_hat[sel],
                                     cfg, with_var=True)
    finally:
        tile_ops._launch_backward = orig
    floors = (1.0, 1.0, 0.0, 0.0)
    print(f"  the {len(sub)} rays with |<g, d>| >= 0.1 alone: "
          + " ".join(f"{k} {rel_err(a, b, fl):.3g}" for k, a, b, fl in zip(
              names, gpu_ok, ref_ok, floors))
          + f"; all {len(sel)} with the recompute as the card's tile "
          f"backward: " + " ".join(f"{k} {rel_err(a, b, fl):.3g}" for
                                    k, a, b, fl in zip(names, gpu_rc, ref,
                                                       floors))
          + f"; kernels vs recompute on the card: " + " ".join(
              f"{k} {rel_err(a, b, fl):.3g}" for k, a, b, fl in zip(
                  names, gpu, gpu_rc, floors)), flush=True)
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


def event_ms(fn):
    """(fn(), the device ms between CUDA events recorded around it)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


class Env:
    """Sets environment variables (None: unset) for a with block and puts
    the old values back after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in self.values}
        for k, v in self.values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the branch settings of the 3D update: the dense sweep, the cell-blocked
# sweep (compaction forced off, the blocked sweep forced on), and the
# card's default (the compacted fit and sweep)
SWEEPS = (("dense", dict(GPISMAP_OBS_COMPACT="0", GPISMAP_OBS_BLOCKED="0")),
          ("blocked", dict(GPISMAP_OBS_COMPACT="0", GPISMAP_OBS_BLOCKED="1")),
          ("compacted", dict(GPISMAP_OBS_COMPACT=None,
                             GPISMAP_OBS_BLOCKED=None)))
# the blocked sweep against the gather, both in float64: one function
F64_TOL = 1e-9


def field_agreement(a: np.ndarray, b: np.ndarray, var_col: int,
                    unmapped: float) -> str:
    """Two test() outputs on the same queries: the share whose mapped
    status (var_f < 1 + map_noise) agrees, and |f_a - f_b| over the
    points both map."""
    ma, mb = a[:, var_col] < unmapped, b[:, var_col] < unmapped
    both = ma & mb
    df = np.abs(a[both, 0] - b[both, 0])
    return (f"mapped agreement {float((ma == mb).mean()):.6f}, |f| diff "
            f"over the {int(both.sum())} points both map: median "
            f"{float(np.median(df)) if both.any() else np.nan:.3g}, max "
            f"{float(df.max()) if both.any() else np.nan:.3g}")


def run_obs_branches(card, frames, volume, torch_scenes, tile_ops, chol_ops):
    """Phase 12: the 3D obs branches on each of the 40 frames,
    frame_compute_3d three ways (dense, blocked, compacted); then 12b,
    the 3D update with each sweep. Returns the launches of each update
    (update->test) and the compacted (default) map's test() of the
    volume."""
    from gpismap_tpu_torch import GPisMap3D
    from gpismap_tpu_torch.models import mapper3d, obsgp

    t_phase = time.time()
    m = GPisMap3D()
    m.set_camera(1, "bigbird")
    cam, mp, op, dev = m.cam, m.p, m.op, m.device
    row_idx, col_idx = mapper3d._grid_ownership(cam, mp, op)
    a_of_row = np.full(cam.height // mp.obs_skip, -1)
    for a, rows in enumerate(row_idx):
        a_of_row[rows[rows >= 0]] = a
    b_of_col = np.full(cam.width // mp.obs_skip, -1)
    for b, cols in enumerate(col_idx):
        b_of_col[cols[cols >= 0]] = b
    a_of_row = torch.as_tensor(a_of_row, device=dev)
    b_of_col = torch.as_tensor(b_of_col, device=dev)
    fields = ("pos", "grad", "noise", "grad_noise")
    ms = {k: [] for k in ("frame dense", "frame blocked", "frame compacted",
                          "sweep dense", "sweep blocked", "sweep compacted")}
    nvs, cells, caps = [], [], set()
    bad = []
    worst_b = {k: 0.0 for k in fields}
    worst_med = {k: 0.0 for k in fields[1:]}
    worst_post = {k: 0.0 for k in ("gate var", "probe mean", "probe var")}
    worst64 = {k: 0.0 for k in fields}
    # per field: the largest float32 blocked-vs-gather difference over the
    # gather's own largest float32 error (against float64), worst frame;
    # and that error's largest value
    worst_ratio = {k: 0.0 for k in fields[1:]}
    worst_own = {k: 0.0 for k in fields[1:]}
    n_ok = 0
    hop = 0
    for depth, pose in frames:
        nv, _ = m._host_gate(depth)
        nv_cap, c_cap = m._obs_nv_cap(nv), m._obs_cell_cap(m._last_valid_mask)
        if nv_cap is None or c_cap is None:
            fail("the card's default did not compact the 3D obs sweep")
        caps.add((nv_cap, c_cap))
        tr = pose[:3]
        rot = pose[3:12].reshape(3, 3, order="F")
        args = (torch.as_tensor(depth, device=dev),
                torch.as_tensor(tr, device=dev),
                torch.as_tensor(rot, device=dev), cam, mp, op,
                m._obs_chunk)
        kws = dict(dense=dict(blocked=False), blocked=dict(blocked=True),
                   compacted=dict(nv_cap=nv_cap, obs_c_cap=c_cap))
        out = {}
        for name, kw in kws.items():
            out[name], t = event_ms(lambda: mapper3d.frame_compute_3d(
                *args, **kw))
            ms[f"frame {name}"].append(t)
            prep, obs, _ = out[name]
            sweep_kw = {k: v for k, v in kw.items() if k != "obs_c_cap"}
            _, t = event_ms(lambda: mapper3d.newmeas_3d(
                obs, prep, args[2], mp, op, m._obs_chunk, cam=cam,
                **sweep_kw))
            ms[f"sweep {name}"].append(t)
        prep, obs_d, nd = out["dense"]
        _, obs_c, nc = out["compacted"]
        nb = out["blocked"][2]
        # the same frame in float64 through the gather and the blocked
        # sweep: they compute one function, and the float32 gather's own
        # rounding is the yardstick of the float32 blocked sweep's
        args64 = tuple(a.double() for a in args[:3]) + args[3:]
        d64 = mapper3d.frame_compute_3d(*args64, blocked=False)[2]
        b64 = mapper3d.frame_compute_3d(*args64, blocked=True)[2]
        ok64 = d64.insert_ok
        if not torch.equal(b64.insert_ok, ok64):
            bad.append(f"float64: insert_ok differs on "
                       f"{int((b64.insert_ok != ok64).sum())} pixels")
            continue
        both = ok64 & nd.insert_ok
        for k in fields:
            if ok64.any():
                worst64[k] = max(worst64[k], float(
                    (getattr(b64, k) - getattr(d64, k))[ok64].abs().max()))
            if k in worst_ratio and both.any():
                exact = getattr(d64, k)[both]
                own = float((getattr(nd, k)[both].double() - exact)
                            .abs().max())
                gap = float((getattr(nb, k)[both] - getattr(nd, k)[both])
                            .abs().max())
                worst_own[k] = max(worst_own[k], own)
                worst_ratio[k] = max(worst_ratio[k],
                                     gap / own if own else (np.inf if gap else 0.0))
        nvs.append(nv)
        trained = obs_d.trained
        cells.append(int(trained.sum()))
        ok = nd.insert_ok
        n_ok += int(ok.sum())
        if not (torch.equal(nb.insert_ok, ok) and torch.equal(nc.insert_ok,
                                                              ok)):
            bad.append(f"insert_ok differs (blocked "
                       f"{int((nb.insert_ok != ok).sum())}, compacted "
                       f"{int((nc.insert_ok != ok).sum())} pixels)")
            continue
        if not (torch.equal(obs_c.trained, trained)
                and torch.equal(obs_c.alpha[trained], obs_d.alpha[trained])
                and torch.equal(obs_c.linv[trained], obs_d.linv[trained])):
            bad.append("compacted fit differs from the full fit: alpha "
                       f"{float((obs_c.alpha - obs_d.alpha)[trained].abs().max()):.3g}"
                       f", L^-1 {float((obs_c.linv - obs_d.linv)[trained].abs().max()):.3g}")
        for k in fields:
            a, b = getattr(nc, k)[ok], getattr(nd, k)[ok]
            if not torch.equal(a, b):
                bad.append(f"compacted {k} differs from dense: max "
                           f"{float((a - b).abs().max()):.3g} on "
                           f"{int((a != b).reshape(len(a), -1).any(-1).sum())} "
                           f"pixels")
            diff = (getattr(nb, k)[ok] - b).abs()
            if diff.numel():
                worst_b[k] = max(worst_b[k], float(diff.max()))
                if k in worst_med:
                    worst_med[k] = max(worst_med[k], float(diff.median()))
        # the blocked evaluator's own outputs, the posteriors, against the
        # gather's at the valid pixels: f32 rounding of the products'
        # summation order (the normals above are their finite
        # differences over delx, which multiply that rounding by ~3e4)
        vu0, ppos, pz, pvu = mapper3d.probe_queries(prep, mp)
        v = prep.valid
        post_b = mapper3d._blocked_obs_sweep(obs_d, vu0, pvu, cam, mp, op)
        _, var0_g = obsgp.obsgp2d_test(obs_d, vu0.reshape(-1, 2), op,
                                       m._obs_chunk)
        pr_g, pv_g = obsgp.obsgp2d_test(obs_d, pvu.reshape(-1, 2), op,
                                        m._obs_chunk)
        post_g = (var0_g.reshape(v.shape), pr_g.reshape(pvu.shape[:-1]),
                  pv_g.reshape(pvu.shape[:-1]))
        for k, a, b in zip(worst_post, post_b, post_g):
            a, b = a[v], b[v]
            sent = b >= 1e6
            if not torch.equal(a >= 1e6, sent):
                bad.append(f"blocked {k}: the sentinel differs")
                continue
            if (~sent).any():
                worst_post[k] = max(worst_post[k], float(
                    (a - b)[~sent].abs().max()) / max(
                        1.0, float(b[~sent].abs().max())))
        # roff=1 coverage: each valid pixel's probes within one cell of
        # its pixel's static owning cell
        a_t = torch.clamp(torch.searchsorted(
            obs_d.val_i[1:].contiguous(), (ppos[..., 1] / pz).contiguous(),
            right=True), 0, len(obs_d.val_i) - 2)
        b_t = torch.clamp(torch.searchsorted(
            obs_d.val_j[1:].contiguous(), (ppos[..., 0] / pz).contiguous(),
            right=True), 0, len(obs_d.val_j) - 2)
        da = (a_t - a_of_row[:, None, None]).abs()[prep.valid]
        db = (b_t - b_of_col[None, :, None]).abs()[prep.valid]
        hop = max(hop, int(da.max()), int(db.max()))
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    print(f"phase 12: the 3D obs branches on {len(frames)} frames of "
          f"{cam.width}x{cam.height} ({len(nvs)} evaluated): valid pixels nv min "
          f"{min(nvs)} median {int(np.median(nvs))} max {max(nvs)} of "
          f"{prep.valid.numel()}; nonempty obs cells min {min(cells)} median "
          f"{int(np.median(cells))} max {max(cells)} of {trained.numel()}; "
          f"(nv_cap, c_cap) buckets {sorted(caps)}; {n_ok} insertable "
          f"pixels in all; CUDA-event ms per frame, frame_compute_3d / "
          f"newmeas_3d alone: "
          + ", ".join(f"{k} {mean['frame ' + k]:.3f} / "
                      f"{mean['sweep ' + k]:.3f}"
                      for k in ("dense", "blocked", "compacted"))
          + f" ({card})", flush=True)
    print(f"  compacted vs dense: {'equal to the last bit' if not bad else bad[:4]}"
          f"; blocked vs gather posteriors at the valid pixels, max abs "
          f"diff relative to the largest magnitude (at least 1) "
          + " ".join(f"{k} {v:.3g}" for k, v in worst_post.items())
          + "; blocked vs dense over the insertable pixels, max abs diff "
          + " ".join(f"{k} {v:.3g}" for k, v in worst_b.items())
          + ", largest per-frame median " + " ".join(
              f"{k} {v:.3g}" for k, v in worst_med.items())
          + f"; probes at most {hop} cell(s) from their pixel's cell",
          flush=True)
    print("  in float64, blocked vs gather over the insertable pixels, max "
          "abs diff " + " ".join(f"{k} {v:.3g}" for k, v in worst64.items())
          + f" (gate {F64_TOL:g}); the float32 gather's own largest error "
          "against float64 " + " ".join(f"{k} {v:.3g}"
                                        for k, v in worst_own.items())
          + "; float32 blocked-vs-gather max over that error, worst frame "
          + " ".join(f"{k} {v:.3g}" for k, v in worst_ratio.items())
          + " (gate < 1)", flush=True)
    if bad:
        fail(f"phase 12: {bad[:4]}")
    # the blocked sweep is the gather's function (float64), its float32
    # normals and noises differ from the gather's by less than the
    # gather's own float32 error (finite differences over delx of the
    # posteriors, which the products' summation order rounds), and the
    # JAX package's bounds (tests/test_obsgp.py) hold on its posteriors,
    # positions and medians
    if max(worst64.values()) > F64_TOL or max(worst_ratio.values()) >= 1 \
            or max(worst_post.values()) > KERNEL_TOL \
            or worst_b["pos"] > 1e-6 or max(worst_med.values()) >= 1e-4 \
            or hop > 1:
        fail(f"phase 12: the blocked sweep is off the gather's bounds: "
             f"float64 {worst64}, float32 over the gather's own error "
             f"{worst_ratio}, posteriors {worst_post}, {worst_b}, medians "
             f"{worst_med}, hop {hop}")
    print(f"  phase 12 wall {time.time() - t_phase:.1f} s", flush=True)

    # ---- 12b: the 3D update with each sweep ----
    t_phase = time.time()
    res, maps, n_upd = {}, {}, {}
    for name, env in SWEEPS:
        with Env(**env):
            mm = GPisMap3D()
            mm.set_camera(1, "bigbird")
            counts(tile_ops, chol_ops, reset=True)
            torch.cuda.synchronize()
            t0 = time.time()
            mm.update_batch(frames)
            torch.cuda.synchronize()
            t_upd = time.time() - t0
            t0 = time.time()
            res[name] = mm.test(volume)
            t_test = time.time() - t0
            n_upd[name] = np.asarray(counts(tile_ops, chol_ops))
        maps[name] = mm
        print(f"phase 12b: 3D update with the {name} sweep: "
              f"{len(frames) / t_upd:.2f} frames/s, {mm.num_nodes} nodes; "
              f"first test {len(volume) / t_test:.0f} queries/s; launches "
              f"tile/chol/linv {n_upd[name][0]}/{n_upd[name][1]}/"
              f"{n_upd[name][2]} ({card})", flush=True)
    unmapped = 1.0 + maps["dense"].p.map_noise_param
    same = (np.array_equal(res["compacted"], res["dense"])
            and maps["compacted"].num_nodes == maps["dense"].num_nodes)
    print(f"  compacted map vs dense map: test() on the volume "
          f"{'equal to the last bit' if same else 'DIFFERS'}; blocked map "
          f"vs dense map: "
          + field_agreement(res["blocked"], res["dense"], 4, unmapped),
          flush=True)
    if not same:
        fail("the compacted 3D map differs from the dense map")
    mapped = float((res["blocked"][:, 4] < unmapped).mean())
    if mapped < MAPPED_FLOOR_3D:
        fail(f"the blocked-sweep map's mapped share {mapped}")
    check_surface(maps["blocked"], torch_scenes)
    print(f"  phase 12b wall {time.time() - t_phase:.1f} s", flush=True)
    return n_upd, res["compacted"]


def run_table(card, maps, tile_ops, chol_ops):
    """Phase 13: test() through the candidate table vs the window, on
    phases 4's and 7's maps. Returns the table test's launches per map."""
    t_phase = time.time()
    n_tab = {}
    for label, m, q in maps:
        m.test(q)
        torch.cuda.synchronize()
        t0 = time.time()
        r_win = m.test(q)
        t_win = time.time() - t0
        if m._nbrs is not None:
            fail(f"{label}: the card's default built a candidate table")
        with Env(GPISMAP_NBR_TABLE="1"):
            _, t_build = event_ms(m._build_nbrs)
            if m._nbrs is None:
                fail(f"{label}: GPISMAP_NBR_TABLE=1 built no table")
            m.test(q)
            counts(tile_ops, chol_ops, reset=True)
            torch.cuda.synchronize()
            t0 = time.time()
            r_tab = m.test(q)
            t_tab = time.time() - t0
            n_tab[label] = np.asarray(counts(tile_ops, chol_ops))
        ovf = int(m._nbrs.n_overflow)
        same = np.array_equal(r_tab, r_win)
        print(f"phase 13: {label} test() through the "
              f"{'dense' if m._nbr_dense else 'sorted-key'} candidate table "
              f"{tuple(m._nbrs.packed.shape)} vs the window: "
              f"{'equal to the last bit' if same else 'DIFFERS'}; "
              f"nbr_overflow {ovf}; table build {t_build:.3f} ms (CUDA "
              f"events); warm test {len(q) / t_tab:.0f} queries/s with the "
              f"table, {len(q) / t_win:.0f} through the window; the first "
              f"test after a retrain {t_build + 1e3 * t_tab:.3f} ms with the "
              f"table (its build included), {1e3 * t_win:.3f} through the "
              f"window; launches "
              f"tile/chol/linv {n_tab[label][0]}/{n_tab[label][1]}/"
              f"{n_tab[label][2]} ({card})", flush=True)
        if not same or ovf or m.stats.get("nbr_overflow", 0):
            fail(f"{label}: the table's test() differs from the window's "
                 f"or overflowed ({ovf})")
    print(f"  phase 13 wall {time.time() - t_phase:.1f} s", flush=True)
    return n_tab


def run_two_phase(card, maps, cluster, tile_ops, chol_ops):
    """Phase 14: map_test(two_phase=True) vs single-phase on phases 4's
    and 7's maps, through the window and the table. Returns the
    two-phase call's launches per map."""
    t_phase = time.time()
    n_two = {}
    for label, m, q in maps:
        qt = torch.as_tensor(q, device=m.device)
        kw = dict(m._test_kwargs(), factors=m._get_factors())
        if m._nbrs is None:
            fail(f"{label}: phase 13 left no candidate table")
        tab = dict(nbrs=m._nbrs, nbr_dense=m._nbr_dense)
        one = cluster.map_test(m.store, m.grid, qt, **kw)
        counts(tile_ops, chol_ops, reset=True)
        two = cluster.map_test(m.store, m.grid, qt, two_phase=True, **kw)
        torch.cuda.synchronize()
        n_two[label] = np.asarray(counts(tile_ops, chol_ops))
        others = (two, cluster.map_test(m.store, m.grid, qt, **tab, **kw),
                  cluster.map_test(m.store, m.grid, qt, two_phase=True,
                                   **tab, **kw))
        same = all(torch.equal(a, b) for o in others
                   for a, b in zip(one[:4], o[:4]))
        ms1 = cuda_ms(lambda: cluster.map_test(m.store, m.grid, qt, **kw), 3)
        ms2 = cuda_ms(lambda: cluster.map_test(m.store, m.grid, qt,
                                               two_phase=True, **kw), 3)
        print(f"phase 14: {label} map_test on {len(q)} queries, two-phase vs "
              f"single-phase (window and table): "
              f"{'equal to the last bit' if same else 'DIFFERS'}; n_phase2 "
              f"{int(two[4].n_phase2)}; pairs {int(one[4].n_pairs)} in one "
              f"phase, {int(two[4].n_pairs)} in two; tile launches per call "
              f"{n_two[label][0]} (single phase: 1); CUDA-event ms per call "
              f"{ms1:.3f} single, {ms2:.3f} two-phase ({card})", flush=True)
        if not same:
            fail(f"{label}: two-phase differs from single-phase")
        if n_two[label][0] < 1:
            fail(f"{label}: two-phase launched no tile kernel")
    print(f"  phase 14 wall {time.time() - t_phase:.1f} s", flush=True)
    return n_two


def run_modes(card, frames2d, grid, gazebo, frames3d, volume, res3d,
              torch_scenes, tile_ops, chol_ops):
    """Phase 15: 2D strict_reeval=True on the 2D frames, 3D "strict",
    "fused" and "snapshot" on the 40 frames, each against the default
    mode's map (in 3D phase 12b's, whose test() of the volume is res3d).
    Returns each mode's update->test launches, and the strict 2D mode's
    frame kernel launches (strict_2d_frame)."""
    from gpismap_tpu_torch import GPisMap2D, GPisMap3D
    from gpismap_tpu_torch.ops import obsgp1d_frame as frame_ops

    t_phase = time.time()
    n_mode = {}
    runs = [("2D default", None, GPisMap2D, {}, frames2d, grid),
            ("2D strict_reeval=True", "strict_2d", GPisMap2D,
             dict(strict_reeval=True), frames2d, grid),
            ("3D reeval_mode='strict'", "strict_3d", GPisMap3D,
             dict(reeval_mode="strict"), frames3d, volume),
            ("3D reeval_mode='fused'", "fused_3d", GPisMap3D,
             dict(reeval_mode="fused"), frames3d, volume),
            ("3D reeval_mode='snapshot'", "snapshot_3d", GPisMap3D,
             dict(reeval_mode="snapshot"), frames3d, volume)]
    default2d = None
    for label, key, cls, kw, frames, q in runs:
        m = cls(**kw)
        if m.dim == 3:
            m.set_camera(1, "bigbird")
        counts(tile_ops, chol_ops, reset=True)
        frames0 = frame_ops.launches
        torch.cuda.synchronize()
        t0 = time.time()
        m.update_batch(frames)
        torch.cuda.synchronize()
        t_upd = time.time() - t0
        if key == "strict_2d":
            n_mode["strict_2d_frame"] = frame_ops.launches - frames0
        res = m.test(q)
        n = np.asarray(counts(tile_ops, chol_ops))
        var_col = 3 if m.dim == 2 else 4
        unmapped = 1.0 + m.p.map_noise_param
        mapped = float((res[:, var_col] < unmapped).mean())
        if m.dim == 2 and key is None:
            default2d = res
        ref = default2d if m.dim == 2 else res3d
        dropped = (f", {m.stats.get('reeval_dropped', 0)} re-evaluations "
                   f"dropped" if m.dim == 3 else "")
        print(f"phase 15: {label}: {len(frames) / t_upd:.2f} update "
              f"frames/s over {len(frames)} frames, {m.num_nodes} nodes"
              f"{dropped}; mapped share {mapped:.4f}; vs the default mode's "
              f"map: "
              + field_agreement(res, ref, var_col, unmapped)
              + f"; launches tile/chol/linv {n[0]}/{n[1]}/{n[2]} ({card})",
              flush=True)
        if key is None:
            continue
        n_mode[key] = n
        floor = (0.2 if gazebo else MAPPED_FLOOR) if m.dim == 2 \
            else MAPPED_FLOOR_3D
        if mapped < floor or not np.isfinite(res).all():
            fail(f"{label}: mapped share {mapped} (floor {floor})")
        if n.min() < 1:
            fail(f"{label}: launched tile/chol/linv {n} times")
        if m.dim == 3:
            check_surface(m, torch_scenes)
        elif not gazebo:
            check_walls(m, torch_scenes)
    print(f"  phase 15 wall {time.time() - t_phase:.1f} s", flush=True)
    return n_mode


def mesh_err(a: np.ndarray, b: np.ndarray, rtol: float, atol: float):
    """(largest |a - b| / (atol + rtol |b|), per-column max |a - b|): the
    first at most 1 means np.allclose(a, b, rtol, atol)."""
    d = np.abs(a - b)
    return float((d / (atol + rtol * np.abs(b))).max()), d.max(0)


def mesh_child(argv) -> int:
    """One rank of phase 16a (part "nccl") or 16b (part "gloo"): both
    mappers on the mesh over the frames of phases 4 and 7, each with its
    last frame ingested again, against the single-device results the
    parent left in workdir/ref.npz; sharded_map_test on phase 8's map.
    Writes workdir/<part>_<rank>.json; fails (exit 1) on any mismatch."""
    import datetime

    import torch.distributed as dist

    part, rank, world, port, work = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_scenes
    from gpismap_tpu_torch import BIGBIRD_CAMS, GPisMap2D, GPisMap3D
    from gpismap_tpu_torch.models import cluster
    from gpismap_tpu_torch.ops import chol as chol_ops
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
    from gpismap_tpu_torch.parallel import data_mesh, sharded_map_test
    from gpismap_tpu_torch.runtime import checkpoint

    tag = f"phase 16{'a' if part == 'nccl' else 'b'} rank {rank}/{world}"
    backend = "nccl" if part == "nccl" else "gloo"
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    mesh = data_mesh(device="cuda:0")
    want_comm = "cuda" if backend == "nccl" else "cpu"
    if (mesh.size, mesh.rank) != (world, rank) \
            or mesh.comm_device.type != want_comm:
        fail(f"{tag}: {mesh}")
    ref = np.load(os.path.join(work, "ref.npz"))
    gazebo = torch_scenes.gazebo_path()
    frames2d = (torch_scenes.gazebo_frames(gazebo) if gazebo
                else torch_scenes.floor_frames(28))
    frames3d = torch_scenes.object_frames(40, BIGBIRD_CAMS[0])
    out = dict(backend=backend, comm_device=str(mesh.comm_device))

    def plain_rate(m, frames):
        """Update frames/s of a mapper without a mesh in this process,
        after its first frame (the mesh run's baseline)."""
        m.update(*frames[0])
        torch.cuda.synchronize()
        t0 = time.time()
        m.update_batch(frames[1:])
        torch.cuda.synchronize()
        return (len(frames) - 1) / (time.time() - t0)

    def drive(label, m, frames, q1, want1, q2, want2, nodes, base):
        counts(tile_ops, chol_ops, reset=True)
        with BySize(chol_ops) as bs:
            torch.cuda.synchronize()
            t0 = time.time()
            m.update(*frames[0])        # the first collectives set up
            torch.cuda.synchronize()
            t_first = time.time() - t0
            m.update_batch(frames[1:])
            torch.cuda.synchronize()
            t_upd = time.time() - t0
            r1 = m.test(q1)
            if m._factors is None:
                fail(f"{tag} {label}: test() filled no factor cache")
            m.update(*frames[-1])
            if m._factors is None:
                fail(f"{tag} {label}: the re-ingested frame dropped the "
                     f"factor cache instead of refreshing it")
            r2 = m.test(q2)
            torch.cuda.synchronize()
        n = counts(tile_ops, chol_ops)
        digest = m.check_replicas()
        e1, d1 = mesh_err(r1, want1, MESH_RTOL, MESH_ATOL)
        e2, d2 = mesh_err(r2, want2, MESH_RTOL, MESH_ATOL)
        bitwise = bool(np.array_equal(r1, want1))
        print(f"{tag} {label}: {m.num_nodes} nodes (single device "
              f"{int(nodes)}), update {len(frames) / t_upd:.2f} frames/s "
              f"({(len(frames) - 1) / (t_upd - t_first):.2f} after the "
              f"first frame's {t_first * 1e3:.0f} ms; without a mesh in "
              f"this process {base:.2f}); "
              f"test() of the {len(q1)} points vs the single-device map: "
              f"max abs diff " + " ".join(f"{v:.3g}" for v in d1)
              + f" (bitwise equal: {bitwise}); after the re-ingest "
              f"(update_factors refresh) at {len(q2)} random points: "
              + " ".join(f"{v:.3g}" for v in d2)
              + f"; worst diff / (atol + rtol |ref|) {max(e1, e2):.3g}; "
              f"launches tile/chol/linv {n[0]}/{n[1]}/{n[2]}, chol/linv "
              f"at n=640 {bs.at('chol', 640)}/{bs.at('linv', 640)}; "
              f"digest {digest[:16]}", flush=True)
        if m.num_nodes != int(nodes):
            fail(f"{tag} {label}: {m.num_nodes} nodes, the single-device "
                 f"map has {int(nodes)}")
        if max(e1, e2) > 1.0:
            fail(f"{tag} {label}: the mesh map differs from the "
                 f"single-device map beyond rtol {MESH_RTOL} atol "
                 f"{MESH_ATOL}")
        if world == 1 and not bitwise:
            fail(f"{tag} {label}: one rank's first test() is not bitwise "
                 f"equal to the single-device map's (it runs the same "
                 f"fits and a fresh factor fill)")
        if n[0] < 1 or n[1] < 1 or n[2] < 1:
            fail(f"{tag} {label}: launches tile/chol/linv {n}")
        out[label] = dict(launches=list(n), chol640=bs.at("chol", 640),
                          linv640=bs.at("linv", 640), digest=digest,
                          bitwise=bitwise, err=max(e1, e2),
                          frames_per_s=len(frames) / t_upd,
                          first_frame_s=t_first, plain_frames_per_s=base)

    base = plain_rate(GPisMap2D(device=mesh.device), frames2d)
    m2 = GPisMap2D(mesh=mesh)
    if m2.device != torch.device("cuda", 0):
        fail(f"{tag}: GPisMap2D(mesh=) runs on {m2.device}")
    drive("2d", m2, frames2d, ref["grid"], ref["res2d"], ref["qr2"],
          ref["res2d_after"], ref["nodes2d"], base)
    del m2
    m3 = GPisMap3D(device=mesh.device)
    m3.set_camera(1, "bigbird")
    base = plain_rate(m3, frames3d)
    m3 = GPisMap3D(mesh=mesh)
    m3.set_camera(1, "bigbird")
    drive("3d", m3, frames3d, ref["volume"], ref["res3d"], ref["qr3"],
          ref["res3d_after"], ref["nodes3d"], base)
    del m3

    # sharded_map_test on phase 8's map vs map_test, on the volume
    m8 = GPisMap3D(mesh=mesh)
    checkpoint.load(m8, os.path.join(work, "map3d.npz"))
    vol = ref["volume"]
    qv = np.full((1 << (len(vol) - 1).bit_length(), 3), 1e6, np.float32)
    qv[:len(vol)] = vol
    qv = torch.as_tensor(qv, device=m8.device)
    kw = dict(m8._test_kwargs(), factors=m8._get_factors())
    one = cluster.map_test(m8.store, m8.grid, qv, **kw)
    shd = sharded_map_test(m8.store, m8.grid, qv, mesh, **kw)
    worst = max(mesh_err(b.cpu().numpy(), a.cpu().numpy(), SHARDED_TOL,
                         SHARDED_TOL)[0] for a, b in zip(one[:4], shd[:4]))
    bitwise = all(torch.equal(a, b) for a, b in zip(one[:4], shd[:4]))
    info_ok = all(int(a) == int(b) for a, b in zip(one[4], shd[4]))
    print(f"{tag}: sharded_map_test on phase 8's map, {len(qv)} padded "
          f"queries in shards of {len(qv) // world}: bitwise equal to "
          f"map_test: {bitwise}; worst diff / (atol + rtol |ref|) at "
          f"{SHARDED_TOL}: {worst:.3g}; TestInfo equal: {info_ok}",
          flush=True)
    if worst > 1.0 or not info_ok:
        fail(f"{tag}: sharded_map_test differs from map_test")
    out["sharded_bitwise"] = bitwise
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{tag}: peak memory allocated by this rank "
          f"{out['peak_gib']:.2f} GiB", flush=True)
    del m8
    with open(os.path.join(work, f"{part}_{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_mesh(part: str, world: int, work: str):
    """Runs `world` ranks of mesh_child for part, prints their output,
    fails on any child's failure. Returns each rank's JSON record."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = str(sk.getsockname()[1])
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-child", part,
         str(r), str(world), port, work], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=420)[0])
    except subprocess.TimeoutExpired:
        outs.append("(timed out)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for o in outs:
        print("".join("  " + line for line in o.splitlines(True)),
              end="", flush=True)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        fail(f"phase 16 {part}: ranks {bad} of {world} failed")
    recs = []
    for r in range(world):
        with open(os.path.join(work, f"{part}_{r}.json")) as fh:
            recs.append(json.load(fh))
    return recs


def run_mesh(card, m2, res2d, qr2, grid, m3, r3, volume, cluster,
             checkpoint, tile_ops, chol_ops):
    """Phase 16: the mesh. Returns the launches of each mesh path as
    (tile, chol, linv, chol at n=640, linv at n=640)."""
    from gpismap_tpu_torch import GPisMap3D

    t_phase = time.time()
    paths = {}
    with tempfile.TemporaryDirectory() as work:
        checkpoint.save(m3, os.path.join(work, "map3d.npz"))
        np.savez(os.path.join(work, "ref.npz"), grid=grid, res2d=res2d,
                 qr2=qr2, res2d_after=m2.test(qr2), nodes2d=m2.num_nodes,
                 volume=volume, res3d=r3["res"], qr3=r3["qr"],
                 res3d_after=m3.test(r3["qr"]), nodes3d=m3.num_nodes)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print("phase 16a: one rank of an NCCL process group on the card",
              flush=True)
        t0 = time.time()
        (a,) = spawn_mesh("nccl", 1, work)
        print(f"  phase 16a wall {time.time() - t0:.1f} s", flush=True)
        print("phase 16b: two gloo ranks on the one card, collectives "
              "through host memory", flush=True)
        t0 = time.time()
        b = spawn_mesh("gloo", 2, work)
        print(f"  phase 16b wall {time.time() - t0:.1f} s", flush=True)
    if a["backend"] != "nccl" or a["comm_device"] != "cuda:0":
        fail(f"phase 16a ran {a['backend']} on {a['comm_device']}")
    for key in ("2d", "3d"):
        if b[0][key]["digest"] != b[1][key]["digest"]:
            fail(f"phase 16b: the ranks' {key} digests differ")

    def entry(rec):
        return tuple(rec["launches"]) + (rec["chol640"], rec["linv640"])

    paths["mesh_2d_update_test"] = entry(a["2d"])
    paths["mesh_3d_update_test"] = entry(a["3d"])
    paths["mesh_2rank_2d_update_test"] = tuple(
        x + y for x, y in zip(entry(b[0]["2d"]), entry(b[1]["2d"])))
    paths["mesh_2rank_3d_update_test"] = tuple(
        x + y for x, y in zip(entry(b[0]["3d"]), entry(b[1]["3d"])))
    peak = max(r["peak_gib"] for r in b)

    # ---- 16c: update_factors at the 3D refresh bucket and at full size,
    # on phase 8's map, against a fresh fill ----
    store, scale = m3.store, m3.p.map_scale_param
    if m3._refresh_buckets() != (160, None):
        fail(f"3D refresh buckets {m3._refresh_buckets()}, not (160, None)")
    mb = 160
    live = m3._live_slots()
    lt = torch.as_tensor(live, device=m3.device).long()
    small = ~store.valid[lt][:, mb:].any(1).cpu().numpy()
    pad = np.full(m3.cap.test_active_cells, -1, np.int32)
    pad[:len(live)] = live
    fresh, uniq = cluster.factorize_slots(
        store, torch.as_tensor(pad, device=m3.device), scale,
        m3.cap.test_active_cells)
    top = float(fresh.abs().max())
    for label, bucket, sl in (("n=640", mb, live[small][:64]),
                              ("n=1280", None, live[~small][:64])):
        if len(sl) < 8:
            fail(f"phase 16c: only {len(sl)} live cells for {label}")
        slt = torch.as_tensor(sl, device=m3.device)
        rows = torch.searchsorted(uniq, slt)
        buf = fresh.clone()
        buf[rows] = 0.0
        with BySize(chol_ops) as bs:
            cluster.update_factors(store, buf, uniq, slt, scale, mb=bucket)
        rel = float((buf - fresh).abs().max()) / top
        n = int(label[2:])
        ms = cuda_ms(lambda: cluster.update_factors(
            store, buf, uniq, slt, scale, mb=bucket), 3)
        print(f"phase 16c: update_factors of {len(sl)} cells at {label} "
              f"(mb={bucket}) vs a fresh fill: max abs diff relative to "
              f"max |L^-1| {rel:.3g}; chol/linv launches at n={n} "
              f"{bs.at('chol', n)}/{bs.at('linv', n)}; CUDA-event ms per "
              f"call {ms:.3f} ({card})", flush=True)
        if rel > LINV_REL_TOL:
            fail(f"phase 16c: update_factors at {label} differs by {rel}")
        if bs.at("chol", n) < 1 or bs.at("linv", n) < 1:
            fail(f"phase 16c: update_factors at {label} launched no chol "
                 f"or linv at n={n}")
    del fresh, buf

    # ---- 16c: the 3D update with the node mirror off ----
    with Env(GPISMAP_NODE_MIRROR="0"):
        mo = GPisMap3D()
        mo.set_camera(1, "bigbird")
        frames = r3["frames"]
        counts(tile_ops, chol_ops, reset=True)
        with BySize(chol_ops) as bs:
            torch.cuda.synchronize()
            t0 = time.time()
            mo.update_batch(frames)
            torch.cuda.synchronize()
            t_upd = time.time() - t0
            r1 = mo.test(volume)
            mo.update(*frames[-1])
            if mo._factors is None or mo._mirror is not None:
                fail("phase 16c: the mirror-off update kept a mirror or "
                     "dropped the factor cache")
            r2 = mo.test(r3["qr"])
            torch.cuda.synchronize()
        n = counts(tile_ops, chol_ops)
    e1, d1 = mesh_err(r1, r3["res"], MESH_RTOL, MESH_ATOL)
    e2, d2 = mesh_err(r2, m3.test(r3["qr"]), MESH_RTOL, MESH_ATOL)
    print(f"phase 16c: 3D update with GPISMAP_NODE_MIRROR=0: "
          f"{mo.num_nodes} nodes (default {m3.num_nodes}), "
          f"{len(frames) / t_upd:.2f} frames/s; test() vs phase 7: max abs "
          f"diff " + " ".join(f"{v:.3g}" for v in d1)
          + f" (bitwise equal: {bool(np.array_equal(r1, r3['res']))}); "
          f"after the re-ingest vs phase 8: "
          + " ".join(f"{v:.3g}" for v in d2)
          + f"; worst diff / (atol + rtol |ref|) {max(e1, e2):.3g}; "
          f"launches tile/chol/linv {n[0]}/{n[1]}/{n[2]}, chol/linv at "
          f"n=640 {bs.at('chol', 640)}/{bs.at('linv', 640)} ({card})",
          flush=True)
    if mo.num_nodes != m3.num_nodes or max(e1, e2) > 1.0:
        fail("phase 16c: the mirror-off 3D map differs from the default")
    if not np.array_equal(r1, r3["res"]):
        fail("phase 16c: the mirror-off first test() is not bitwise equal "
             "to phase 7's (the same fits on the same support, a fresh "
             "factor fill)")
    paths["mirror_off_3d_update_test"] = tuple(n) + (bs.at("chol", 640),
                                                     bs.at("linv", 640))
    del mo
    print(f"  phase 16 wall {time.time() - t_phase:.1f} s; two-rank peak "
          f"memory {peak:.2f} GiB per rank", flush=True)
    return paths

class Returns(Capture):
    """Wraps module.name to keep the return value of every call."""

    def __call__(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        self.calls.append(out)
        return out


def bf16_gate(out, ref, act):
    """(var_f, var_grad) largest absolute differences of a bf16 evaluation
    from an f32 one on the rows `act`, and whether they are within the
    JAX package's bf16 gate, BF16_VF_TOL and BF16_VG_TOL (absolute)."""
    dv = [float((a[act] - b[act]).abs().max()) if bool(act.any()) else 0.0
          for a, b in zip(out, ref)]
    return dv, dv[0] <= BF16_VF_TOL and dv[1] <= BF16_VG_TOL


def kept_share(tile_ops, args, d):
    """(the kept stages' mean share of all ceil(MP / 16) stages over the
    active tiles and over their cells, the largest count: the bf16
    kernel's nk_cap) of a tile plan (ops/tile_eval.py:kept_stages)."""
    _, count = tile_ops.kept_stages(args[5], args[4], d)
    ns = -(-args[1].shape[-1] // 16)
    segs = args[0][args[0] >= 0].long()
    cells = torch.unique(segs)
    share = count.double() / ns
    return (float(share[segs].mean()) if segs.numel() else 0.0,
            float(share[cells].mean()) if cells.numel() else 0.0,
            int(count.max()) if count.numel() else 0)


def kernel_alone_ms(fn, kernel: str, reps: int):
    """Mean device time per call of fn() of the CUDA kernel whose name
    holds `kernel`, over reps calls, from a torch.profiler (CUPTI) trace
    (device_breakdown): the kernel without the work around it in fn.
    None, and the reason printed, when the trace does not show that
    kernel once a call."""
    rows = [v for k, v in device_breakdown(fn, reps).items() if kernel in k]
    ms, n = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if n != 1 or ms <= 0:
        print(f"  the profiler shows {n:g} launches of {kernel} a call, "
              f"{ms * 1e3:g} us of device time: not measured", flush=True)
        return None
    return ms


def check_bf16_kernel(card, tile_ops, label, captured):
    """Phase 17a: the bf16 kernel on a captured tile plan against the bf16
    plain version and the packed one (within
    torch_bf16_checks.variance_limits), the f32 kernel and itself. Returns
    its kernel-line numbers."""
    import torch_bf16_checks as bc
    args, kwargs = captured
    kwargs = {k: v for k, v in kwargs.items() if k != "bf16"}
    d = kwargs["d"]
    act = args[0] >= 0
    before = (tile_ops.launches, tile_ops.launches_bf16)
    out = tile_ops.tile_eval(*args, **kwargs, bf16=True)
    torch.cuda.synchronize()
    counted = (tile_ops.launches - before[0],
               tile_ops.launches_bf16 - before[1])
    f32 = tile_ops.tile_eval(*args, **kwargs)
    ref = tile_ops.tile_eval_reference(*args, **kwargs, bf16=True)
    ref32 = tile_ops.tile_eval_reference(*args, **kwargs)
    lims = bc.variance_limits(args, kwargs, KERNEL_TOL)
    packed = tile_ops.tile_eval_packed_reference(*args, **kwargs)
    over_packed = [float(x[act].max()) if bool(act.any()) else 0.0
                   for x in bc.shares(out, packed, lims)]
    del packed
    model = bc.kstar_model_ratio(args, d, kwargs["scale"])
    amb = lims[2] & act[:, None, None]
    clean = (~lims[2]) & act[:, None, None]
    cols = ((act, clean[:, 0]), (act, clean[:, 1:]))

    def most(x, mask):
        return float(x[mask].max()) if bool(mask.any()) else 0.0
    over = [most(x, c[0]) for x, c in zip(bc.shares(out, ref, lims), cols)]
    over_clean = [most(x, c[1])
                  for x, c in zip(bc.shares(out, ref, lims), cols)]
    f32_over = [most(x, c[0])
                for x, c in zip(bc.shares(f32, ref, lims), cols)]
    gaps = [(a - b).abs() for a, b in zip(out[2:], ref[2:])]
    err = [most(x, c[0]) for x, c in zip(gaps, cols)]
    err_clean = [most(x, c[1]) for x, c in zip(gaps, cols)]
    same_fg = all(torch.equal(a[act], b[act])
                  for a, b in zip(out[:2], f32[:2]))
    dv, gate_ok = bf16_gate(out[2:], f32[2:], act)
    dv_plain, plain_ok = bf16_gate(ref[2:], ref32[2:], act)
    del ref32
    moved = bool((out[2][act] != f32[2][act]).any())
    again = tile_ops.tile_eval(*args, **kwargs, bf16=True)
    perm = torch.randperm(args[0].shape[0], generator=torch.Generator()
                          .manual_seed(17)).to(args[0].device)
    shuf = (args[0][perm],) + args[1:6] + (args[6][perm].contiguous(),)
    moved_tiles = tile_ops.tile_eval(*shuf, **kwargs, bf16=True)
    pa = act[perm]
    determ = all(torch.equal(a[act], b[act]) for a, b in zip(out, again))
    order_free = all(torch.equal(a[perm][pa], b[pa])
                     for a, b in zip(out, moved_tiles))
    per_tile, per_cell, nk_cap = kept_share(tile_ops, args, d)
    # f32 and bf16 in turns through tile_eval (the bf16 call's kept_stages
    # and its one read back included): f32, bf16, bf16, f32; the bf16
    # kernel alone is read after 17b (kernel_alone_ms)
    ms32a = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs), 5)
    ms16 = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs, bf16=True), 5)
    ms16b = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs, bf16=True),
                    5)
    ms32b = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs), 5)
    plain_ms = cuda_ms(lambda: tile_ops.tile_eval_reference(
        *args, **kwargs, bf16=True), 2)
    bnd = tile_bound_bf16(args, kwargs)
    smem = tile_ops._lib_bf16().tile_eval_bf16_smem_bytes(
        d, args[2].shape[-1], nk_cap)
    tensor, fp32, _ = tile_work_bf16(args, kwargs)
    nt, mp, t = args[0].shape[0], args[1].shape[1], args[6].shape[-1]
    n_cols = max(1, int(act.sum()) * (1 + d) * t)
    print(f"phase 17a: bf16 kernel, {label} (NT={nt}, {int(act.sum())} "
          f"active, MP={mp}, T={t}): vs the bf16 plain version max abs err "
          f"vf={err[0]:.3g} vg={err[1]:.3g}, largest share of its "
          f"limit {over[0]:.3g} {over[1]:.3g} (the f32 kernel's "
          f"{f32_over[0]:.3g} {f32_over[1]:.3g}); "
          f"{float(amb.sum()) / n_cols:.4f} of the columns have a K* entry "
          f"two f32 evaluations may round to other bf16 values (the plain "
          f"version's f32 K* uses {model:.3g} of the error bound that "
          f"decides it), on the others max abs err vf={err_clean[0]:.3g}"
          f" vg={err_clean[1]:.3g}, share of the limit {over_clean[0]:.3g} "
          f"{over_clean[1]:.3g}; vs the packed plain version largest "
          f"share {over_packed[0]:.3g} {over_packed[1]:.3g}; kept stages "
          f"{per_tile:.4f} of all per active tile, {per_cell:.4f} per cell, "
          f"at most {nk_cap}; f and g vs the "
          f"f32 kernel: {'bitwise equal' if same_fg else 'DIFFER'} (nvcc "
          f"{nvcc_version()}); vf, vg "
          f"vs the f32 kernel max abs diff {dv[0]:.3g} {dv[1]:.3g} "
          f"({'within' if gate_ok else 'outside'} the JAX bf16 gate), the "
          f"bf16 plain version vs the f32 one {dv_plain[0]:.3g} "
          f"{dv_plain[1]:.3g} ({'within' if plain_ok else 'outside'}); "
          f"launches "
          f"f32/bf16 {counted[0]}/{counted[1]}; deterministic {determ}, "
          f"tile order free {order_free}; through tile_eval {ms16:.3f} / "
          f"{ms16b:.3f} ms (f32 kernel {ms32a:.3f} / {ms32b:.3f} in turns; "
          f"{tensor / ms16 / 1e9:.2f} TFLOP/s bf16 + {fp32 / ms16 / 1e9:.2f}"
          f" TFLOP/s fp32 on tile_work_bf16's count), plain "
          f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), {smem} B "
          f"of dynamic shared memory per block ({card})", flush=True)
    if max(over) > 1.0 or max(over_packed) > 1.0:
        fail(f"bf16 kernel, {label}: off the bf16 plain version beyond "
             f"its limits (largest share {over}; vs the packed one "
             f"{over_packed})")
    if model > 1.0:
        fail(f"bf16 kernel, {label}: the plain version's f32 K* is off its "
             f"float64 value by {model:.3g} of the error bound that decides "
             f"which entries may round to other bf16 values")
    if not same_fg:
        fail(f"bf16 kernel, {label}: f and g differ from the f32 kernel's")
    if not moved:
        fail(f"bf16 kernel, {label}: no variance differs from the f32 "
             f"kernel's")
    if counted != (0, 1):
        fail(f"bf16 kernel, {label}: launches f32/bf16 {counted}, not 0/1")
    if not determ or not order_free:
        fail(f"bf16 kernel, {label}: not bitwise deterministic "
             f"({determ}) or tile order free ({order_free})")
    return dict(err=max(err), ms=ms16, plain_ms=plain_ms,
                bound=bnd, gap=dv, plain_gap=dv_plain)


# phase 17a's synthetic d=3 plans (torch_bf16_checks.masked_plan, M=320,
# T=128): label, cells as (valid nodes, share of them with gradient
# rows), tiles
BF16_PLANS = (("full cell", ((320, 1.0), (320, 1.0)), 24),
              ("empty cell", ((0, 1.0), (0, 1.0)), 8),
              ("gradflag 0 on some nodes", ((320, 0.6), (200, 0.5),
                                            (97, 0.0)), 24))


def check_bf16_synthetic(card, tile_ops):
    """Phase 17a on BF16_PLANS: a full cell (80 kept stages, the shared
    memory's worst case), empty cells (no kept stage: the outputs are the
    constants) and cells with gradient-free nodes (masked rows inside kept
    stages). Each against the bf16 plain version and the packed one on
    the card (torch_bf16_checks.variance_limits), f and g bitwise the f32
    kernel's, one bf16 launch and no f32 one."""
    import torch_bf16_checks as bc
    kwargs = dict(d=3, scale=1.2, val_const=1.01, grad_const=3.0 / 1.44 + 0.1)
    for i, (label, cells, nt) in enumerate(BF16_PLANS):
        args = bc.masked_plan(np.random.default_rng(170 + i), 3, 320, 128,
                              nt, cells, kwargs["scale"], device="cuda")
        act = args[0] >= 0
        before = (tile_ops.launches, tile_ops.launches_bf16)
        out = tile_ops.tile_eval(*args, **kwargs, bf16=True)
        torch.cuda.synchronize()
        counted = (tile_ops.launches - before[0],
                   tile_ops.launches_bf16 - before[1])
        f32 = tile_ops.tile_eval(*args, **kwargs)
        lims = bc.variance_limits(args, kwargs, KERNEL_TOL)
        over = {}
        for name, ref in (
                ("plain", tile_ops.tile_eval_reference(*args, **kwargs,
                                                       bf16=True)),
                ("packed", tile_ops.tile_eval_packed_reference(*args,
                                                               **kwargs))):
            over[name] = [float(x[act].max())
                          for x in bc.shares(out, ref, lims)]
        same_fg = all(torch.equal(a[act], b[act])
                      for a, b in zip(out[:2], f32[:2]))
        per_tile, _, nk_cap = kept_share(tile_ops, args, 3)
        ms = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs, bf16=True),
                     5)
        print(f"phase 17a: bf16 kernel, synthetic d=3 plan, {label} (NT="
              f"{nt}, {int(act.sum())} active, M=320, T=128): kept stages "
              f"{per_tile:.4f} of all per active tile, at most {nk_cap}; "
              f"largest share of its variance limit vs the bf16 plain "
              f"version {over['plain'][0]:.3g} {over['plain'][1]:.3g}, vs "
              f"the packed one {over['packed'][0]:.3g} "
              f"{over['packed'][1]:.3g}; f and g vs the f32 kernel: "
              f"{'bitwise equal' if same_fg else 'DIFFER'}; launches "
              f"f32/bf16 {counted[0]}/{counted[1]}; {ms:.3f} ms through "
              f"tile_eval ({card})", flush=True)
        if max(over["plain"] + over["packed"]) > 1.0 or not same_fg:
            fail(f"bf16 kernel, synthetic plan {label}: variances beyond "
                 f"their limits ({over}) or f and g differ from the f32 "
                 f"kernel's ({same_fg})")
        if counted != (0, 1):
            fail(f"bf16 kernel, synthetic plan {label}: launches f32/bf16 "
                 f"{counted}, not 0/1")
        if not all(bool(torch.isfinite(x[act]).all()) for x in out):
            fail(f"bf16 kernel, synthetic plan {label}: outputs not finite")
        if label == "empty cell" and not (
                bool((out[0][act] == 0).all())
                and bool((out[2][act] == kwargs["val_const"]).all())
                and bool((out[3][act] == kwargs["grad_const"]).all())):
            fail("bf16 kernel, empty cells: outputs are not 0 and the "
                 "prior variances")
        if label == "full cell" and nk_cap != 80:
            fail(f"bf16 kernel, full cells: {nk_cap} kept stages, not 80")


def blend_choice(top, pairs, nq, var_thre):
    """Per query of a map_test call (its _top3 and _eval_pairs returns):
    (n_cand, use_near, best_lt, the indices of the two smallest
    variances in map_test's tie order)."""
    _, top_ok, n_cand = top
    vf3 = torch.where(top_ok, pairs[2].reshape(-1, 3), torch.inf)[:nq]
    order = torch.sort(vf3, dim=1, stable=True).indices[:, :2]
    n_cand = n_cand[:nq]
    use_near = (n_cand == 1) | (vf3[:, 0] <= var_thre)
    best_lt = vf3.min(dim=1).values < var_thre
    return n_cand, use_near, best_lt, order


def bf16_test(m, q, tile_ops, cluster, setting, tile_fn=None):
    """One test() of m at q with GPISMAP_PALLAS_BF16=setting after a warm
    one, its tile op replaced by tile_fn if given: (its output, the tile
    kernel's launches f32/bf16, the _top3 and _eval_pairs returns)."""
    with Env(GPISMAP_PALLAS_BF16=setting):
        m.test(q)
        torch.cuda.synchronize()
        orig = tile_ops.tile_eval
        tile_ops.launches = tile_ops.launches_bf16 = 0
        try:
            if tile_fn is not None:
                tile_ops.tile_eval = tile_fn
            with Returns(cluster, "_top3") as top, \
                    Returns(cluster, "_eval_pairs") as pairs:
                res = m.test(q)
                torch.cuda.synchronize()
        finally:
            tile_ops.tile_eval = orig
    return dict(res=res, n=(tile_ops.launches, tile_ops.launches_bf16),
                top=top.args, pairs=pairs.args)


def run_bf16(card, tile_ops, cluster, plans, maps):
    """Phase 17: the tile kernel's bf16 variant. 17a on the tile plans of
    phases 4 and 7; 17b test() with GPISMAP_PALLAS_BF16=1 on those maps,
    against the default test() and against test() with the bf16 plain
    version in the kernel's place. Returns the kernel-line numbers and the
    bf16 test() launches."""
    import torch_bf16_checks as bc
    t_phase = time.time()
    kern = {label: check_bf16_kernel(card, tile_ops, label, captured)
            for label, captured in plans}
    check_bf16_synthetic(card, tile_ops)
    n_bf16 = {}

    def plain_tile(*args, **kwargs):
        return tile_ops.tile_eval_reference(*args, **kwargs)

    def limit_tile(*args, **kwargs):
        """The tile op's outputs with the bf16 variances' limits in place
        of var_f and var_grad (the same scatter carries them to pairs)."""
        kwargs = {k: v for k, v in kwargs.items() if k != "bf16"}
        lf, lg, _ = bc.variance_limits(args, kwargs, KERNEL_TOL)
        out = tile_ops.tile_eval_reference(*args, **kwargs, bf16=True)
        return out[0], out[1], lf.float(), lg.float()

    for label, m, q in maps:
        d = m.dim
        var_thre = m._test_kwargs()["var_thre"]
        nq = len(q)
        runs = {}
        for setting in (None, "1"):
            runs[setting] = bf16_test(m, q, tile_ops, cluster, setting)
            walls, evs = [], []
            with Env(GPISMAP_PALLAS_BF16=setting):
                for _ in range(3):
                    t0 = time.time()
                    _, ev = event_ms(lambda: m.test(q))
                    walls.append(time.time() - t0)
                    evs.append(ev)
            runs[setting].update(walls=walls, evs=evs)
        plain = bf16_test(m, q, tile_ops, cluster, "1", plain_tile)
        lim = bf16_test(m, q, tile_ops, cluster, "1", limit_tile)["pairs"]
        off, on = runs[None], runs["1"]
        n_bf16[label] = on["n"][1]
        if off["n"] != (1, 0) or on["n"][0] != 0 or on["n"][1] < 1:
            fail(f"phase 17b {label}: tile launches f32/bf16 {off['n']} "
                 f"with the switch off, {on['n']} on")
        c_off = blend_choice(off["top"], off["pairs"], nq, var_thre)
        c_on = blend_choice(on["top"], on["pairs"], nq, var_thre)
        c_plain = blend_choice(plain["top"], plain["pairs"], nq, var_thre)
        if not torch.equal(c_off[0], c_on[0]):
            fail(f"phase 17b {label}: candidate counts differ")
        has = c_off[0] >= 1
        near_both = (c_off[1] & c_on[1] & has).cpu().numpy()
        near_plain = (c_plain[1] & c_on[1] & has).cpu().numpy()
        blend_both = (~c_off[1] & ~c_on[1] & has)
        flip = has & ((c_off[1] != c_on[1]) | (blend_both & (
            (c_off[2] != c_on[2]) | (c_off[3] != c_on[3]).any(1))))
        flip = flip.cpu().numpy()
        stay = (blend_both.cpu().numpy() & ~flip)
        r0, r1, rp = off["res"], on["res"], plain["res"]
        dcol = np.abs(r1 - r0)
        vf_col = 1 + d
        g_cols = slice(1, 1 + d)
        vg_cols = slice(2 + d, 2 + 2 * d)

        def mx(rows, cols):
            return float(dcol[rows][:, cols].max()) if rows.any() else 0.0
        same_near = (np.array_equal(r1[near_both][:, :1 + d],
                                    r0[near_both][:, :1 + d]))
        dv_near, ok_near = bf16_gate(
            (torch.as_tensor(r1[:, vf_col]), torch.as_tensor(r1[:, vg_cols])),
            (torch.as_tensor(r0[:, vf_col]), torch.as_tensor(r0[:, vg_cols])),
            torch.as_tensor(near_both))
        # the nearest candidate's limits (pair 3 q of query q)
        lim_vf = lim[2].reshape(-1, 3)[:nq, 0].double().cpu().numpy()
        lim_vg = lim[3].reshape(-1, 3, d)[:nq, 0].double().cpu().numpy()
        gap_vf = np.abs(r1[:, vf_col].astype(np.float64)
                        - rp[:, vf_col].astype(np.float64))
        gap_vg = np.abs(r1[:, vg_cols].astype(np.float64)
                        - rp[:, vg_cols].astype(np.float64))
        share = [float((gap / np.maximum(lm, 1e-300))[near_plain].max())
                 if near_plain.any() else 0.0
                 for gap, lm in ((gap_vf, lim_vf), (gap_vg, lim_vg))]
        print(f"phase 17b: {label} test() of {nq} queries with "
              f"GPISMAP_PALLAS_BF16=1: tile launches f32/bf16 "
              f"{on['n'][0]}/{on['n'][1]} (switch off: {off['n'][0]}/"
              f"{off['n'][1]}); {int(has.sum().item())} queries with a "
              f"candidate, {int(near_both.sum())} take the nearest result in "
              f"both runs: f, g {'bitwise equal' if same_near else 'DIFFER'}"
              f", vf / vg max abs diff {dv_near[0]:.3g} / {dv_near[1]:.3g} "
              f"({'within' if ok_near else 'outside'} the JAX bf16 gate); "
              f"against test() with the bf16 plain version as its tile op, "
              f"at the {int(near_plain.sum())} queries that take the nearest "
              f"result in both: vf / vg max abs diff "
              f"{float(gap_vf[near_plain].max()) if near_plain.any() else 0:.3g}"
              f" / {float(gap_vg[near_plain].max()) if near_plain.any() else 0:.3g}"
              f", largest share of its limit {share[0]:.3g} / {share[1]:.3g}; "
              f"var_thre blend choice flipped at {int(flip.sum())} queries "
              f"(share {flip.sum() / nq:.3g} of all, "
              f"{flip.sum() / max(1, int(has.sum().item())):.3g} of those "
              f"with a candidate), max |df| {mx(flip, slice(0, 1)):.3g} "
              f"|dg| {mx(flip, g_cols):.3g} there; blended in both without "
              f"a flip ({int(stay.sum())}): max |df| "
              f"{mx(stay, slice(0, 1)):.3g} |dg| {mx(stay, g_cols):.3g} "
              f"|dvf| {mx(stay, slice(vf_col, vf_col + 1)):.3g} |dvg| "
              f"{mx(stay, vg_cols):.3g} ({card})", flush=True)
        for key, name in ((None, "off"), ("1", "on")):
            r = runs[key]
            print(f"  warm test() with the switch {name}: "
                  + ", ".join(f"{nq / w:.0f}" for w in r["walls"])
                  + " queries/s (host wall); "
                  + ", ".join(f"{e:.3f}" for e in r["evs"])
                  + " ms (CUDA events)", flush=True)
        if not same_near:
            fail(f"phase 17b {label}: f and g of the nearest-cell results "
                 f"differ from the f32 run's")
        if plain["n"] != (0, 0) or not near_plain.any():
            fail(f"phase 17b {label}: the plain version's test() launched "
                 f"a tile kernel ({plain['n']}) or has no nearest-cell "
                 f"query in common with the kernel's")
        if max(share) > 1.0:
            fail(f"phase 17b {label}: nearest-cell variances off the bf16 "
                 f"plain version's test() beyond their limits ({share})")
        if not np.isfinite(r1).all() or r1.shape != r0.shape:
            fail(f"phase 17b {label}: bf16 test() output not finite")
    # ---- 17c: the bf16 kernel alone on phase 4's and 7's plans, from
    # a profiler trace, last, so that CUPTI runs beside no other timing
    for label, (args, kwargs) in plans:
        kwargs = {k: v for k, v in kwargs.items() if k != "bf16"}
        kern[label]["kernel_ms"] = alone = kernel_alone_ms(
            lambda: tile_ops.tile_eval(*args, **kwargs, bf16=True),
            "tile_eval_bf16_kernel", 5)
        print(f"phase 17c: bf16 kernel, {label}: the kernel alone "
              f"{'not measured' if alone is None else f'{alone:.3f} ms'} "
              f"(profiler, 5 calls), through tile_eval "
              f"{kern[label]['ms']:.3f} ms (CUDA events) ({card})",
              flush=True)
    print(f"  phase 17 wall {time.time() - t_phase:.1f} s", flush=True)
    return dict(kernel=kern, launches=n_bf16)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_scenes
    from gpismap_tpu_torch import GPisMap2D, GPisMap3D, convert, render
    from gpismap_tpu_torch.models import cluster, mapper2d
    from gpismap_tpu_torch.ops import chol as chol_ops
    from gpismap_tpu_torch.ops import obsgp1d_frame as frame_ops
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
              "tile_eval_bf16": tile_ops.build_library_bf16,
              "tile_eval_backward": tile_ops.build_library_backward,
              "chol": chol_ops.build_library,
              "obsgp1d_frame": frame_ops.build_library}
    with ThreadPoolExecutor(len(builds)) as ex:
        futures = {name: ex.submit(fn) for name, fn in builds.items()}
        logs = {name: f.result() for name, f in futures.items()}
    print(f"phase 2: built the index, tile, bf16 tile, tile backward, "
          f"chol and 2D frame kernel libraries in {time.time() - t0:.1f} s "
          f"with nvcc ({nvcc_version()})", flush=True)
    ptx = {name: ptxas_lines(name, logs[name])
           for name in ("tile_eval", "tile_eval_bf16", "tile_eval_backward",
                        "chol", "obsgp1d_frame")}

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
    bucket_rows = rows[-3:-1]               # B=64 at MP=96 and 192
    del warm, cap, cap_fit, cap_fill, args, kwargs, systems

    # ---- phase 4: the main path at full size ----
    m = GPisMap2D(device=dev)
    by_size = BySize(chol_ops).__enter__()    # to phase 5's update
    with Capture(tile_ops, "tile_eval") as cap, \
            Capture(mapper2d, "frame_update_2d") as cap_frame:
        tile_ops.launches = tile_ops.launches_bf16 = 0
        chol_ops.chol_launches = chol_ops.linv_launches = 0
        frame_ops.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        m.update_batch(frames)
        torch.cuda.synchronize()
        t_update = time.time() - t0
        upd = (chol_ops.chol_launches, chol_ops.linv_launches)
        frame_launches = frame_ops.launches
        chol_ops.chol_launches = chol_ops.linv_launches = 0
        t0 = time.time()
        res = m.test(grid)
        torch.cuda.synchronize()
        t_test = time.time() - t0
        launches = tile_ops.launches
        launches_bf16 = tile_ops.launches_bf16
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
    if frame_launches != len(frames):
        fail(f"the 2D update launched the frame kernel {frame_launches} "
             f"times on {len(frames)} frames")
    if tile_ops.launches_bf16:
        fail("the default 2D path launched the bf16 tile kernel")
    if upd[0] + first[0] < 1 or upd[1] + first[1] < 1:
        fail("the main path did not launch the chol and linv kernels")
    if m._factors is None:
        fail(f"test() did not use the factor cache ({n_live} live cells, "
             f"bound {m.cap.test_active_cells})")
    if m._nbrs is not None:
        fail("the 2D map's test() built the candidate table, which is "
             "opt-in (GPISMAP_NBR_TABLE=1)")
    print("  the card's default: test() through the window (the candidate "
          "table is opt-in)")
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
    by_size.__exit__()
    bucket2 = {n: (by_size.at("chol", n), by_size.at("linv", n))
               for n in (96, 192, 384)}
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
    print("  chol/linv calls by size on phases 4-5: "
          + ", ".join(f"n={n} {c}/{w}" for n, (c, w) in bucket2.items()),
          flush=True)
    if rel_cache > LINV_REL_TOL:
        fail(f"refreshed factor cache differs from a fresh fill by "
             f"{rel_cache} relative")
    if d_refresh.max() > KERNEL_TOL:
        fail(f"test() through the refreshed cache differs by "
             f"{d_refresh.max()}")

    # ---- phase 4b: the frame kernel on phase 4's frames; the frame
    # stage's launches and copies on a mapper of its own ----
    m4b = GPisMap2D(device=dev)
    m4b.update_batch(frames[:-1])
    r4b = run_frame_kernel(card, cap_frame.calls, m4b, frames[-1], mapper2d,
                           frame_ops)
    del m4b, cap_frame

    # ---- phases 6-8: the 3D path ----
    r3 = run_3d(card, torch_scenes, chol_ops, tile_ops, cluster, convert)
    m3 = r3["map"]

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phases 9-10: rendering on the maps of phases 4 and 7 ----
        cpu2 = carry_to_cpu(checkpoint, m, GPisMap2D(device="cpu"),
                            os.path.join(tmp, "map2d.npz"))
        m9, c9, b9, rays2 = run_render_2d(card, m, cpu2,
                                          frames if gazebo else None,
                                          torch_scenes, render, tile_ops,
                                          chol_ops)
        m10, c10, b10, rays3 = run_render_3d(card, m3, r3["frames"],
                                             torch_scenes, render, tile_ops,
                                             chol_ops)

        # ---- phase 10b: the autograd Functions vs their plain versions ----
        for n in (384, 1280):
            check_factor_functions(card, chol_ops, n)
        bwd = {3: check_tile_function(card, tile_ops, r3["tile_args"],
                                      "d=3, phase 7's tile plan"),
               2: check_tile_function(card, tile_ops, cap.args,
                                      "d=2, phase 4's tile plan")}
        check_correction_vs_cpu(card, render, m, cpu2, rays2, "2D",
                                tile_ops)
        cpu3 = carry_to_cpu(checkpoint, m3,
                            GPisMap3D(camera=m3.cam, device="cpu"),
                            os.path.join(tmp, "map3d_cpu.npz"))
        check_correction_vs_cpu(card, render, m3, cpu3, rays3, "3D",
                                tile_ops)

        # ---- phase 11: checkpoint and mex on the card ----
        run_checkpoint_mex(card, m3, frames, r3["frames"], r3["qr"],
                           m3._test_kwargs()["grad_const"], torch_scenes,
                           checkpoint, tmp)

    # ---- phases 12-15: the card's branches and the other modes ----
    volume = torch_scenes.volume_grid()
    n12, res3d = run_obs_branches(card, r3["frames"], volume, torch_scenes,
                                  tile_ops, chol_ops)
    both = (("2D", m, grid), ("3D", m3, volume))
    n13 = run_table(card, both, tile_ops, chol_ops)
    n14 = run_two_phase(card, both, cluster, tile_ops, chol_ops)
    n15 = run_modes(card, frames, grid, gazebo, r3["frames"], volume,
                    res3d, torch_scenes, tile_ops, chol_ops)

    # ---- phase 16: the mesh ----
    n16 = run_mesh(card, m, res, qr, grid, m3, r3, volume, cluster,
                   checkpoint, tile_ops, chol_ops)

    # ---- phase 17: the bf16 variant ----
    b17 = run_bf16(card, tile_ops, cluster,
                   (("d=2", cap.args), ("d=3", r3.pop("tile_args"))),
                   (("2D", m, grid), ("3D", m3, volume)))

    t2 = "gpismap_tpu/ops/pallas_tile.py:118"
    pc = "gpismap_tpu/ops/pallas_chol.py"
    h3 = r3["headline"]

    def paths(update_test, other_paths, i):
        """Launches of kernel i (0 tile, 1 chol, 2 linv) on each path, the
        update->test path first."""
        return dict([("update_test", int(update_test))]
                    + [(k, int(v[i])) for k, v in other_paths])

    r2d = (("render_2d_march", m9), ("render_2d_correction_backward", c9),
           ("table_test_2d", n13["2D"]), ("two_phase_map_test_2d", n14["2D"]),
           ("strict_2d_update_test", n15["strict_2d"]))
    r3d = (("render_3d_depth", m10), ("render_3d_correction_backward", c10),
           ("obs_dense_3d_update_test", n12["dense"]),
           ("obs_blocked_3d_update_test", n12["blocked"]),
           ("obs_compacted_3d_update_test", n12["compacted"]),
           ("table_test_3d", n13["3D"]), ("two_phase_map_test_3d", n14["3D"]),
           ("strict_3d_update_test", n15["strict_3d"]),
           ("fused_3d_update_test", n15["fused_3d"]),
           ("snapshot_3d_update_test", n15["snapshot_3d"]))
    r2d += tuple((k, n16[k]) for k in ("mesh_2d_update_test",
                                       "mesh_2rank_2d_update_test"))
    r3d += tuple((k, n16[k]) for k in ("mesh_3d_update_test",
                                       "mesh_2rank_3d_update_test",
                                       "mirror_off_3d_update_test"))
    # the n=640 rows count the chol/linv calls at that size only: the 3D
    # retrain's middle bucket (mb=160) and the bucketed refresh
    r640 = tuple((k, v[3:]) for k, v in r3d if len(v) == 5)
    h640 = r3["row640"]
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
                     h3["linv_library_ms"]),
        kernel_entry("chol (n=640)", f"{pc}:167",
                     paths(r3["chol640_launches"], r640, 0),
                     h640["chol_err"], h640["chol_ms"],
                     h640["chol_plain_ms"], h640["bound"],
                     h640["chol_library_ms"]),
        kernel_entry("linv (n=640)", f"{pc}:188",
                     paths(r3["linv640_launches"], r640, 1),
                     h640["linv_err"],
                     h640["linv_ms"], h640["linv_plain_ms"], h640["bound"],
                     h640["linv_library_ms"])]
    # the 2D retrain's smaller buckets: phase 3b's synthetic B=64 rows,
    # the calls at that size on phases 4-5
    for (n, (n_chol, n_linv)), row in zip(list(bucket2.items())[:2],
                                          bucket_rows):
        kernels += [
            kernel_entry(f"chol (n={n})", f"{pc}:167",
                         {"update_test": n_chol}, row["chol_err"],
                         row["chol_ms"], row["chol_plain_ms"], row["bound"],
                         row["chol_library_ms"]),
            kernel_entry(f"linv (n={n})", f"{pc}:188",
                         {"update_test": n_linv}, row["linv_err"],
                         row["linv_ms"], row["linv_plain_ms"], row["bound"],
                         row["linv_library_ms"])]
    tb = ("gpismap_tpu/ops/pallas_tile.py:118 (bf16=True; _make_kernel :36, "
          "branch :95-104)")
    for dd, path, key in ((2, "2D", "d=2"), (3, "3D", "d=3")):
        k = b17["kernel"][key]
        kernels.append(kernel_entry(
            f"tile_eval_bf16 (d={dd})", tb,
            {"update_test": r3["tile_bf16_launches"] if dd == 3
             else launches_bf16, f"bf16_test_{dd}d": b17["launches"][path]},
            k["err"], k["ms"], k["plain_ms"], k["bound"], None,
            main=f"bf16_test_{dd}d", library="none",
            kernel_alone_ms=k["kernel_ms"],
            ptxas=[ln for ln in ptx["tile_eval_bf16"]
                   if f"d={dd})" in ln]))
    rb = ("none: the JAX package differentiates its XLA twin "
          "_ongpis_eval_tile, gpismap_tpu/models/cluster.py:329 (the "
          "Pallas kernel pallas_tile.py:118 has no VJP)")
    for dd, nb_path in ((2, (("render_2d_correction_backward", b9),)),
                        (3, (("render_3d_correction_backward", b10),))):
        k = bwd[dd]
        path = nb_path[0][0]
        kernels.append(kernel_entry(
            f"tile_eval_backward (d={dd})", rb,
            {"update_test": 0, path: int(nb_path[0][1].sum())}, k["err"],
            k["ms"], k["plain_ms"], k["bound"], None, main=path,
            launches_by_kernel={path: dict(zip(
                ("z", "kstar", "linv"), map(int, nb_path[0][1])))},
            max_rel_err=k["rel"], ms_again=k["ms_again"],
            recompute_ms=k["recompute_ms"],
            plain="autograd through tile_eval_reference",
            ptxas=[ln for ln in ptx["tile_eval_backward"]
                   if f"d={dd})" in ln]))
    kernels.append(kernel_entry(
        "obsgp1d_frame (2D frame)",
        "none: the JAX package computes this stage in XLA "
        "(gpismap_tpu/models/mapper2d.py: reeval_2d, newmeas_2d)",
        {"update_test": frame_launches,
         "strict_2d_update_test": n15["strict_2d_frame"]},
        r4b["err"], r4b["ms"], r4b["plain_ms"], r4b["bound"], None,
        plain="reeval_2d_reference + newmeas_2d_reference",
        action_agree=r4b["action_agree"], insert_agree=r4b["insert_agree"],
        frame_stage={"torch_ops": r4b["stage_ops"],
                     "launches": r4b["stage_launches"],
                     "d2h_copies": r4b["stage_d2h"],
                     "fit_d2h_copies": r4b["fit_d2h"]},
        ptxas=ptx["obsgp1d_frame"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2:]))
    sys.exit(main())
