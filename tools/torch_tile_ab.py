#!/usr/bin/env python3
"""A/B timing of variants of the tile-evaluation kernel on one GPU.

Builds gpismap_tpu_torch/csrc/tile_eval.cu as it is and variants of it,
each into a library of its own under gpismap_tpu_torch/build/, and times
each in one process on the tile plans of chip_smoke.py's phase 3 (2D: 10
synthetic floor frames, the 49,551-point grid) and phase 6 (3D: 12
synthetic depth frames, the 15,225-point volume), the source as it is
timed first and last:

  kconst    every K* entry is a constant: the kernel without the cost of
            computing K* (its outputs are wrong; the time is the reading)
  fastmath  nvcc --use_fast_math (__expf, approximate sqrt and division)
  FILE      any other tile_eval.cu with the same C interface, given on the
            command line (for example an earlier commit's)

Prints the card, each build's ptxas register and spill lines, and per
dimension and variant the CUDA-event mean time and the largest output
error against the plain version (relative to each output's largest
magnitude, at least 1).

Usage: python3 tools/torch_tile_ab.py [FILE ...]    (needs CUDA)
"""
import ctypes as ct
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the K* entry of the kernel's stage loop, and what kconst puts there
KSTAR_CALL = "kstar<D>(rb, k, cblk, q, xsm, vms, gms, m, a, a2)"
KCONST = "(1e-3f * (float)(k + 1))"


def variants(extra):
    """[(label, source text, extra nvcc flags)]."""
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
    src = open(tile_ops._SRC).read()
    if src.count(KSTAR_CALL) != 1:
        raise RuntimeError(f"tile_eval.cu has {src.count(KSTAR_CALL)} "
                           f"K* calls to replace, expected 1")
    out = [("kconst", src.replace(KSTAR_CALL, KCONST), []),
           ("fastmath", src, ["--use_fast_math"])]
    for path in extra:
        label = os.path.relpath(os.path.abspath(path), ROOT)
        out.append((label, open(path).read(), []))
    return out


def build(label, text, flags, i):
    """Library path and ptxas lines of one variant."""
    from gpismap_tpu_torch import _native
    os.makedirs(_native.BUILD_DIR, exist_ok=True)
    src = os.path.join(_native.BUILD_DIR, f"tile_eval_ab{i}.cu")
    with open(src, "w") as f:
        f.write(text)
    path, log = _native.build(src, f"libtile_eval_ab{i}.so",
                              _native.NVCC + flags)
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return label, path, lines


def load(path):
    lib = ct.CDLL(path)
    lib.tile_eval_launch.restype = ct.c_int
    lib.tile_eval_launch.argtypes = (
        [ct.c_void_p] * 11 + [ct.c_int] * 5 + [ct.c_float] * 3
        + [ct.c_void_p])
    lib.tile_eval_smem_bytes.restype = ct.c_longlong
    lib.tile_eval_smem_bytes.argtypes = [ct.c_int, ct.c_int]
    lib.tile_eval_error_string.restype = ct.c_char_p
    lib.tile_eval_error_string.argtypes = [ct.c_int]
    return lib


def plans(chip_smoke, torch_scenes, tile_ops):
    """{d: (args, kwargs)} of the tile op on chip_smoke's warm maps."""
    from gpismap_tpu_torch import BIGBIRD_CAMS, GPisMap2D, GPisMap3D
    out = {}
    frames = torch_scenes.floor_frames(28)
    m = GPisMap2D(device="cuda")
    m.update_batch(frames[:9])
    m.update(*frames[9])
    with chip_smoke.Capture(tile_ops, "tile_eval") as cap:
        m.test(torch_scenes.query_grid())
    out[2] = cap.args
    frames = torch_scenes.object_frames(40, BIGBIRD_CAMS[0])
    m = GPisMap3D(device="cuda")
    m.set_camera(1, "bigbird")
    m.update_batch(frames[:11])
    m.update(*frames[11])
    with chip_smoke.Capture(tile_ops, "tile_eval") as cap:
        m.test(torch_scenes.volume_grid())
    out[3] = cap.args
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tile_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import chip_smoke
    import torch_scenes
    from gpismap_tpu_torch.ops import tile_eval as tile_ops

    print(f"card: {chip_smoke.card_line()}; torch {torch.__version__}",
          flush=True)
    todo = variants(sys.argv[1:])
    with ThreadPoolExecutor(len(todo) + 1) as ex:
        own = ex.submit(tile_ops.build_library)
        built = [ex.submit(build, label, text, flags, i)
                 for i, (label, text, flags) in enumerate(todo)]
        print("as it is: " + " | ".join(
            ln.strip() for ln in own.result().splitlines()
            if "registers" in ln or "spill" in ln))
        built = [f.result() for f in built]
    for label, _, lines in built:
        print(f"{label}: " + " | ".join(lines))
    libs = ([("as it is", tile_ops._lib())]
            + [(label, load(path)) for label, path, _ in built]
            + [("as it is", tile_ops._lib())])
    own_lib = tile_ops._lib()
    for d, (args, kwargs) in plans(chip_smoke, torch_scenes,
                                   tile_ops).items():
        reps = 20 if d == 2 else 10
        for label, lib in libs:
            tile_ops._LIB = lib
            _, rel = chip_smoke.compare_kernel(tile_ops, (args, kwargs))
            ms = chip_smoke.cuda_ms(
                lambda: tile_ops.tile_eval(*args, **kwargs), reps)
            print(f"d={d} {label}: {ms:.3f} ms, max relative err vs plain "
                  + " ".join(f"{k}={v:.3g}" for k, v in rel.items()),
                  flush=True)
        tile_ops._LIB = own_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
