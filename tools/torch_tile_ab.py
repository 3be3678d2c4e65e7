#!/usr/bin/env python3
"""A/B timing of variants of the tile-evaluation kernels on one GPU.

Builds gpismap_tpu_torch/csrc/tile_eval.cu (with --bf16: tile_eval_bf16.cu)
as it is and variants of it, each into a library of its own under
gpismap_tpu_torch/build/, and times each in one process on the tile plans
of chip_smoke.py's phase 3 (2D: 10 synthetic floor frames, the
49,551-point grid) and phase 6 (3D: 12 synthetic depth frames, the
15,225-point volume), the source as it is timed first and last. The f32
kernel's variants:

  kconst    every K* entry is a constant: the kernel without the cost of
            computing K* (its outputs are wrong; the time is the reading)
  fastmath  nvcc --use_fast_math (__expf, approximate sqrt and division)
  FILE      any other tile_eval.cu with the same C interface, given on the
            command line (for example an earlier commit's)

The bf16 kernel's (--bf16), two readings of where its time goes and
earlier sources:

  kconst    every K* entry a constant (outputs wrong; the time is the
            reading without the cost of computing K*)
  noproduct no product issued: the L^-1 ring and K* without it (outputs
            wrong)
  FILE      an earlier tile_eval.cu whose bf16 instance has the entry
            tile_eval_bf16_launch without the kept-stage arguments (for
            example commit 25d0d1c's), or another tile_eval_bf16.cu (for
            example an earlier commit's design)

Prints the card, each build's ptxas register and spill lines, and per
dimension and variant the CUDA-event mean time and the largest output
error against the plain version (relative to each output's largest
magnitude, at least 1; with --bf16 against the bf16 plain version, whose
variances a bf16 kernel meets only within torch_bf16_checks' limits).
Every time is of one tile_eval call (with --bf16 its kept_stages and the
one read back of their largest count included).

Usage: python3 tools/torch_tile_ab.py [--bf16] [FILE ...]    (needs CUDA)
"""
import ctypes as ct
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the K* entries of each kernel's K* build (one per rounding of 1 + a r,
# tile_kstar.cuh), and what kconst puts there
KSTAR_CALL = re.compile(r"kstar<D, (?:SPLIT|FUSED)_1AR>\([^;]*?a2\)")
KCONST = "(1e-3f * (float)(k + 1))"
# the bf16 kernel's k-step
PRODUCT_CALL = "mma_step<BN>(acc, af, kb, lane);"


def variants(extra, bf16: bool):
    """[(label, source text, extra nvcc flags)]."""
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
    if bf16:
        src = open(tile_ops._SRC_BF16).read()
        if (len(KSTAR_CALL.findall(src)) != 2
                or src.count(PRODUCT_CALL) != 1):
            raise RuntimeError("tile_eval_bf16.cu: the two K* calls or the "
                               "k-step to replace are not found")
        return ([("kconst", KSTAR_CALL.sub(KCONST, src), []),
                 ("noproduct", src.replace(PRODUCT_CALL, ";"), [])]
                + [(os.path.relpath(os.path.abspath(p), ROOT),
                    open(p).read(), []) for p in extra])
    src = open(tile_ops._SRC).read()
    n = len(KSTAR_CALL.findall(src))
    if n != 2:
        raise RuntimeError(f"tile_eval.cu has {n} K* calls to replace, "
                           f"expected 2")
    out = [("kconst", KSTAR_CALL.sub(KCONST, src), []),
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
    path, log = _native.build(
        src, f"libtile_eval_ab{i}.so",
        _native.NVCC + ["-I", os.path.join(_native.PKG_DIR, "csrc")] + flags)
    lines = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    return label, path, lines


class LegacyBf16:
    """An earlier library's bf16 instance (tile_eval_bf16_launch with the
    f32 kernel's arguments, no kept stages) behind the bf16 library's C
    interface, so that tile_eval(bf16=True) launches it."""

    def __init__(self, lib):
        self.lib = lib

    def tile_eval_bf16_launch(self, *args):
        # drop stages, counts (after the 7 inputs) and nk_cap (after t)
        return self.lib.tile_eval_bf16_launch(*args[:7], *args[9:18],
                                              *args[19:])

    def tile_eval_bf16_smem_bytes(self, d, m, nk_cap):
        return self.lib.tile_eval_bf16_smem_bytes(d, m)

    def tile_eval_bf16_error_string(self, err):
        return self.lib.tile_eval_error_string(err)


def load(path, bf16: bool):
    from gpismap_tpu_torch.ops import tile_eval as tile_ops
    lib = ct.CDLL(path)
    if not bf16 or hasattr(lib, "tile_eval_bf16_error_string"):
        return tile_ops.bind(path, bf16)
    lib.tile_eval_bf16_launch.restype = ct.c_int
    lib.tile_eval_bf16_launch.argtypes = (
        [ct.c_void_p] * 11 + [ct.c_int] * 5 + [ct.c_float] * 3
        + [ct.c_void_p])
    lib.tile_eval_bf16_smem_bytes.restype = ct.c_longlong
    lib.tile_eval_bf16_smem_bytes.argtypes = [ct.c_int, ct.c_int]
    lib.tile_eval_error_string.restype = ct.c_char_p
    lib.tile_eval_error_string.argtypes = [ct.c_int]
    return LegacyBf16(lib)


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
    bf16 = "--bf16" in sys.argv[1:]
    todo = variants([a for a in sys.argv[1:] if a != "--bf16"], bf16)
    attr = "_LIB_BF16" if bf16 else "_LIB"
    with ThreadPoolExecutor(len(todo) + 1) as ex:
        own = ex.submit(tile_ops.build_library_bf16 if bf16
                        else tile_ops.build_library)
        built = [ex.submit(build, label, text, flags, i)
                 for i, (label, text, flags) in enumerate(todo)]
        print("as it is: " + " | ".join(
            ln.strip() for ln in own.result().splitlines()
            if "registers" in ln or "spill" in ln))
        built = [f.result() for f in built]
    for label, _, lines in built:
        print(f"{label}: " + " | ".join(lines))
    own_lib = tile_ops._lib_bf16() if bf16 else tile_ops._lib()
    libs = ([("as it is", own_lib)]
            + [(label, load(path, bf16)) for label, path, _ in built]
            + [("as it is", own_lib)])
    for d, (args, kwargs) in plans(chip_smoke, torch_scenes,
                                   tile_ops).items():
        reps = 20 if d == 2 else 10
        kw = dict(kwargs, bf16=bf16)
        for label, lib in libs:
            setattr(tile_ops, attr, lib)
            _, rel = chip_smoke.compare_kernel(tile_ops, (args, kw))
            ms = chip_smoke.cuda_ms(lambda: tile_ops.tile_eval(*args, **kw),
                                    reps)
            print(f"d={d} {label}: {ms:.3f} ms, max relative err vs plain "
                  + " ".join(f"{k}={v:.3g}" for k, v in rel.items()),
                  flush=True)
        setattr(tile_ops, attr, own_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
