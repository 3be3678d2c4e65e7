#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (gpismap_tpu_torch) on one NVIDIA GPU.

Builds the native libraries from the checkout (all at once), checks each
CUDA kernel of the 2D path against its plain PyTorch version at the
production shapes (the tile evaluation; the Cholesky and L^-1 of the
cluster GPs), then drives the 2D mapper's main path through its public
entry points (GPisMap2D(device="cuda").update on 28 synthetic 1081-beam
LiDAR frames, then test() on the 49,551-point 0.1 m demo grid), checks
the result, and re-ingests the last frame to drive the factor-cache
refresh from the fits' own Cholesky factors. When $GPISMAP_DATA holds
the bundled gazebo sequence (2D/gazebo1.mat), the 28 demo frames of the
real sequence replace the synthetic ones, and the run says so.

Usage: python3 chip_smoke.py    (from the repository root; needs CUDA)

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}};
the line before it is the card's name and power limit, and the one
before that lists each kernel of the path with its launches on the main
path (phase 4 and the refresh phase), its error against the plain
version and both times (the tile kernel at the warm map's tile plan,
chol and linv at B=64, MP=384). Any failed phase exits non-zero before
that.
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
# kernel vs plain version, per output; fp32 throughout, see PERF.md
KERNEL_TOL = 1e-4
# Cholesky factor vs the plain version: the synthetic SPD tolerance of
# tests/test_pallas.py (f32, rounding order only)
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


def compare_kernel(tile_ops, captured):
    """Kernel vs plain version on captured tile-op arguments: max abs
    error per output over the active tiles."""
    args, kwargs = captured
    out_k = tile_ops.tile_eval(*args, **kwargs)
    out_r = tile_ops.tile_eval_reference(*args, **kwargs)
    torch.cuda.synchronize()
    act = args[0] >= 0
    return {name: float((a[act] - b[act]).abs().max())
            for name, a, b in zip(("f", "g", "vf", "vg"), out_k, out_r)}


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
    w_ref = chol_ops.linv_reference(l_ref)
    w_err = float((chol_ops.linv(l_ref) - w_ref).abs().max())
    w_rel = w_err / float(w_ref.abs().max())
    torch.cuda.synchronize()
    row = dict(
        chol_err=l_err, linv_err=w_err, linv_rel=w_rel,
        chol_ms=cuda_ms(lambda: chol_ops.chol(k), 10),
        chol_plain_ms=cuda_ms(lambda: chol_ops.chol_reference(k), 5),
        linv_ms=cuda_ms(lambda: chol_ops.linv(l_ref), 10),
        linv_plain_ms=cuda_ms(lambda: chol_ops.linv_reference(l_ref), 5))
    b, n, _ = k.shape
    print(f"  {name} B={b} MP={n}: chol max abs err {l_err:.3g}, kernel "
          f"{row['chol_ms']:.3f} ms, plain {row['chol_plain_ms']:.3f} ms; "
          f"linv max abs err {w_err:.3g} (relative {w_rel:.3g}), kernel "
          f"{row['linv_ms']:.3f} ms, plain {row['linv_plain_ms']:.3f} ms "
          f"({card})", flush=True)
    if l_err > CHOL_TOL:
        fail(f"chol kernel disagrees with the plain version on {name}: "
             f"{l_err}")
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
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({name}): {line.strip()}")

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
    err3 = compare_kernel(tile_ops, cap.args)
    ms = cuda_ms(lambda: tile_ops.tile_eval(*args, **kwargs), 20)
    plain_ms = cuda_ms(lambda: tile_ops.tile_eval_reference(*args, **kwargs),
                       5)
    print(f"phase 3: NT={nt} ({n_act} active) MP={mp} T={t}: max abs err "
          + " ".join(f"{k}={v:.3g}" for k, v in err3.items())
          + f"; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})",
          flush=True)
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

    err4 = compare_kernel(tile_ops, cap.args)
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

    kernels = [
        {"name": "tile_eval", "route": "cuda",
         "source": "gpismap_tpu_torch/csrc/tile_eval.cu",
         "replaces": "gpismap_tpu/ops/pallas_tile.py:118",
         "launches": launches,
         "max_abs_err": max(max(err3.values()), max(err4.values())),
         "ms": ms, "plain_ms": plain_ms},
        {"name": "chol", "route": "cuda",
         "source": "gpismap_tpu_torch/csrc/chol.cu",
         "replaces": "gpismap_tpu/ops/pallas_chol.py:167",
         "launches": upd[0] + first[0] + refresh[0],
         "max_abs_err": chol_err, "ms": headline["chol_ms"],
         "plain_ms": headline["chol_plain_ms"]},
        {"name": "linv", "route": "cuda",
         "source": "gpismap_tpu_torch/csrc/chol.cu",
         "replaces": "gpismap_tpu/ops/pallas_chol.py:188",
         "launches": upd[1] + first[1] + refresh[1],
         "max_abs_err": linv_err, "ms": headline["linv_ms"],
         "plain_ms": headline["linv_plain_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
