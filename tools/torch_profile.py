#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main paths, on one GPU.

Runs one of chip_smoke.py's scenes under torch.profiler: 2D (28 synthetic
1081-beam frames, then test() on the 49,551-point demo grid) or, with
--3d, 3D (40 synthetic 640x480 depth frames, then test() on the
15,225-point demo volume), then its render as chip_smoke.py's phases 9-10
run it (2D: the 30,268 beams marched 96 steps; 3D: the last ring pose at
subsample 2, 48 steps). Prints, for the update loop, the first test()
(factor cache fill included), a warm test(), the render's march (factor
cache fill included) and the hit rays' correction with its backward
(alpha and scale, the cells factored anew): host wall time, summed
device kernel time, the device's busy share (kernel time / wall; overlap
ignored), the host milliseconds of each of the mapper's stage spans
(gpismap_tpu_torch/runtime/spans.py, live under the profiler), and the
top kernels and host ops.

Usage: python3 tools/torch_profile.py [--3d]    (needs CUDA)
"""
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from gpismap_tpu_torch.runtime.spans import PREFIX  # noqa: E402

TOP = 10          # kernels and host ops listed per phase


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def report(name: str, prof, wall_s: float) -> None:
    events = prof.key_averages()
    # device-side events only: host ops also carry their kernels' time;
    # the stage spans' mirrors on the device's timeline are not kernels
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith(PREFIX)]
    dev_ms = sum(_dev_us(e) for e in kernels) / 1e3
    print(f"{name}: wall {wall_s * 1e3:.1f} ms, device kernels "
          f"{dev_ms:.1f} ms, busy share {dev_ms / (wall_s * 1e3):.3f}")
    stages = [e for e in events if e.device_type == DeviceType.CPU
              and e.key.startswith(PREFIX)]
    for e in sorted(stages, key=lambda e: e.cpu_time_total, reverse=True):
        print(f"  span {e.cpu_time_total / 1e3:7.2f} ms  x{e.count:<5d} "
              f"{e.key}")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:TOP]:
        print(f"  dev {_dev_us(e) / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    host = [e for e in events if e.key.startswith("aten::")]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:TOP]:
        print(f"  host {e.self_cpu_time_total / 1e3:7.2f} ms  x{e.count:<5d} "
              f"{e.key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_scenes
    from chip_smoke import correction_backward
    from gpismap_tpu_torch import BIGBIRD_CAMS, GPisMap2D, GPisMap3D, render

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    if "--3d" in sys.argv[1:]:
        frames = torch_scenes.object_frames(40, BIGBIRD_CAMS[0])
        grid = torch_scenes.volume_grid()
        m = GPisMap3D(device="cuda")
        m.set_camera(1, "bigbird")        # the frames' intrinsics
    else:
        frames = torch_scenes.floor_frames(28)
        grid = torch_scenes.query_grid()
        m = GPisMap2D(device="cuda")
    m.update_batch(frames[:4])            # warm-up: builds, handles
    m.test(grid)
    m.reset()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for f in frames:
            m.update(*f)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report(f"update x{len(frames)} ({m.num_nodes} nodes)", prof, wall)
    for name in ("test (first: factor cache fill)", "test (warm)"):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.time()
            m.test(grid)
            torch.cuda.synchronize()
            wall = time.time() - t0
        report(f"{name}, {len(grid)} queries", prof, wall)

    if isinstance(m, GPisMap3D):
        pose = frames[-1][1]
        o, d, _ = render.camera_rays(
            pose[:3], pose[3:12].reshape(3, 3, order="F"), m.cam, 2)
        cfg = render.config_from_mapper(m)
    else:
        o, d, _ = torch_scenes.beams(torch_scenes.floor_plan(),
                                     torch_scenes.floor_trajectory(28))
        cfg = render.config_from_mapper(m, n_steps=96)
    o, d = (torch.as_tensor(a, device="cuda") for a in (o, d))

    def correct_backward(out):
        idx = torch.nonzero(out["hit"]).reshape(-1)
        correction_backward(render, m, o[idx], d[idx], out["t_hat"][idx],
                            cfg)
        return len(idx)

    # warm-up: the backward's first use of its kernels
    correct_backward(render.sphere_trace(m.store, m.grid, o, d, cfg,
                                         m._get_factors()))
    m._factors = None
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        out = render.sphere_trace(m.store, m.grid, o, d, cfg,
                                  m._get_factors())
        torch.cuda.synchronize()
        wall = time.time() - t0
    report(f"render march, {len(o)} rays x {cfg.n_steps} steps (factor "
           f"cache fill included)", prof, wall)
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        n_hit = correct_backward(out)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report(f"render correction + backward, {n_hit} hit rays", prof, wall)
    return 0


if __name__ == "__main__":
    sys.exit(main())
