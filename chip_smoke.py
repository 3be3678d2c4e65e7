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

Usage: python3 chip_smoke.py    (from the repository root; needs CUDA)

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the one
before that lists each kernel at each shape of the two paths with its
launches on that main path, its error against the plain version, its
time, the plain version's, the bound (the least time the card could take
for the same work) and the time of the PyTorch call that computes the
same function, where there is one. Any failed phase exits non-zero
before that.
"""
import json
import os
import subprocess
import sys
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


def kernel_entry(name, replaces, launches, err, ms, plain_ms, bnd,
                 library_ms):
    source = ("gpismap_tpu_torch/csrc/tile_eval.cu"
              if name.startswith("tile_eval")
              else "gpismap_tpu_torch/csrc/chol.cu")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
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
               linv_launches=upd[2] + tst[2] + refresh[1])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_scenes
    from gpismap_tpu_torch import GPisMap2D, convert
    from gpismap_tpu_torch.models import cluster
    from gpismap_tpu_torch.ops import chol as chol_ops
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
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

    t2 = "gpismap_tpu/ops/pallas_tile.py:118"
    pc = "gpismap_tpu/ops/pallas_chol.py"
    h3 = r3["headline"]
    kernels = [
        kernel_entry("tile_eval (d=2)", t2, launches,
                     max(max(err3.values()), max(err4.values())), ms,
                     plain_ms, bound2, None),
        kernel_entry("tile_eval (d=3)", t2, r3["tile_launches"],
                     r3["tile_err"], r3["tile_ms"], r3["tile_plain_ms"],
                     r3["tile_bound"], None),
        kernel_entry("chol (n=384)", f"{pc}:167",
                     upd[0] + first[0] + refresh[0], chol_err,
                     headline["chol_ms"], headline["chol_plain_ms"],
                     headline["bound"], headline["chol_library_ms"]),
        kernel_entry("chol (n=1280)", f"{pc}:167", r3["chol_launches"],
                     r3["chol_err"], h3["chol_ms"], h3["chol_plain_ms"],
                     h3["bound"], h3["chol_library_ms"]),
        kernel_entry("linv (n=384)", f"{pc}:188",
                     upd[1] + first[1] + refresh[1], linv_err,
                     headline["linv_ms"], headline["linv_plain_ms"],
                     headline["bound"], headline["linv_library_ms"]),
        kernel_entry("linv (n=1280)", f"{pc}:188", r3["linv_launches"],
                     r3["linv_err"], h3["linv_ms"], h3["linv_plain_ms"],
                     h3["bound"], h3["linv_library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
