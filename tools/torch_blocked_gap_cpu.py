"""The cell-blocked 3D probe sweep against the gather sweep, in both
packages, on the CPU: per frame of the smoke's synthetic 3D scene
(tests/torch_scenes.py, bigbird camera 1 at half its focal length and
size, 320x240), the largest difference of the normals and position
noises of the insertable pixels, the PyTorch port's (newmeas_3d
blocked=True vs False) beside the JAX package's.

The normals are finite differences over delx = 1e-3 m of the posterior
means, so the products' summation order, which is all the two sweeps
differ in, shows there multiplied; the JAX package bounds the largest
difference at 2e-3 on one bigbird frame (tests/test_obsgp.py).

Usage: python tools/torch_blocked_gap_cpu.py [STRIDE]   (every STRIDE-th
of the 40 frames, default 4; from the repository root)
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_scenes  # noqa: E402
from gpismap_tpu import config as jcfg  # noqa: E402
from gpismap_tpu.models import mapper3d as jm  # noqa: E402
from gpismap_tpu_torch import config as tcfg  # noqa: E402
from gpismap_tpu_torch.models import mapper3d as tm  # noqa: E402


def gaps(ok, dense, blocked):
    """(largest normal component difference, largest noise difference)
    over the insertable pixels."""
    return tuple(float(np.abs(np.asarray(getattr(dense, k))[ok]
                              - np.asarray(getattr(blocked, k))[ok]).max())
                 for k in ("grad", "noise"))


def main() -> int:
    stride = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    c = tcfg.BIGBIRD_CAMS[0]
    cam = dict(fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2,
               width=c.width // 2, height=c.height // 2)
    frames = torch_scenes.object_frames(40, tcfg.CameraParam(**cam))
    worst = np.zeros(4)
    for i in range(0, len(frames), stride):
        depth, pose = frames[i]
        tr = pose[:3].astype(np.float32)
        rot = pose[3:12].reshape(3, 3, order="F").astype(np.float32)
        ta = (torch.as_tensor(depth), torch.as_tensor(tr),
              torch.as_tensor(rot), tcfg.CameraParam(**cam), tcfg.MAPPER_3D,
              tcfg.OBSGP_2D)
        td = tm.frame_compute_3d(*ta, blocked=False)[2]
        tb = tm.frame_compute_3d(*ta, blocked=True)[2]
        ja = (jnp.asarray(depth), jnp.asarray(tr), jnp.asarray(rot),
              jcfg.CameraParam(**cam), jcfg.MAPPER_3D, jcfg.OBSGP_2D)
        jd = jm.frame_compute_3d(*ja, blocked=False)[2]
        jb = jm.frame_compute_3d(*ja, blocked=True)[2]
        ok_t, ok_j = td.insert_ok.numpy(), np.asarray(jd.insert_ok)
        row = np.array(gaps(ok_t, td, tb) + gaps(ok_j, jd, jb))
        worst = np.maximum(worst, row)
        print(f"frame {i}: {int(ok_t.sum())} insertable pixels; blocked vs "
              f"gather, largest difference: port normal {row[0]:.3g} noise "
              f"{row[1]:.3g}; JAX package normal {row[2]:.3g} noise "
              f"{row[3]:.3g}", flush=True)
    print(f"worst: port normal {worst[0]:.3g} noise {worst[1]:.3g}; JAX "
          f"package normal {worst[2]:.3g} noise {worst[3]:.3g} (CPU, "
          f"{cam['width']}x{cam['height']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
