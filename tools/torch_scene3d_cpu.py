#!/usr/bin/env python3
"""The 3D smoke scene through the PyTorch port on the CPU, at 320x240.

chip_smoke.py's 3D phases run GPisMap3D on 40 synthetic 640x480 depth
frames of a box and a cylinder (tests/torch_scenes.py). This runs the
same scene and poses at half the resolution and focal length on the CPU
(no card needed, a few minutes) and prints what the smoke's floors are
set from: the mapped share of the 15,225-point demo volume and the SDF
sign check across the object's surface.

Usage: python3 tools/torch_scene3d_cpu.py
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import torch_scenes
    from gpismap_tpu_torch import BIGBIRD_CAMS, CameraParam, GPisMap3D

    c = BIGBIRD_CAMS[0]
    cam = CameraParam(fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2,
                      width=c.width // 2, height=c.height // 2)
    m = GPisMap3D(camera=cam, device="cpu")
    t0 = time.time()
    m.update_batch(torch_scenes.object_frames(40, cam))
    print(f"40 frames at {cam.width}x{cam.height} on the CPU: "
          f"{m.num_nodes} nodes, {len(m._live_slots())} live cells "
          f"({time.time() - t0:.1f} s)")
    res = m.test(torch_scenes.volume_grid())
    mapped = float((res[:, 4] < 1.0 + m.p.map_noise_param).mean())
    print(f"mapped share of the demo volume: {mapped:.4f}")
    out, inside = torch_scenes.surface_probes()
    r_out, r_in = m.test(out), m.test(inside)
    conf = (r_out[:, 4] < m.p.test_var_thre) & (r_in[:, 4]
                                                < m.p.test_var_thre)
    s_out = np.sign(r_out[conf, 0] + m.p.fbias)
    s_in = np.sign(r_in[conf, 0] + m.p.fbias)
    print(f"surface probes: {int(conf.sum())} of {len(out)} confident; "
          f"sign differs across the surface in {(s_out != s_in).mean():.4f}"
          f"; outside positive in {(s_out > 0).mean():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
