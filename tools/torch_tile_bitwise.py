#!/usr/bin/env python3
"""Whether the f32 tile kernel built from another tree's sources gives
bitwise this tree's outputs, on random plans at the 2D and 3D production
shapes and a ragged one (on the card).

DIR holds that tree's `tile_eval.cu` and the `tile_kstar.cuh` it
includes, e.g. from `git archive <commit> gpismap_tpu_torch/csrc | tar -x
-C DIR --strip-components=2`. Prints, per shape and output (f, g, vf,
vg), "bitwise equal" or the largest difference.

Usage: python3 tools/torch_tile_bitwise.py DIR    (needs CUDA)
"""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (d, M, T, NT): phase 4's and phase 7's shapes and MP = 160 (two row
# panels, the second ragged)
SHAPES = ((2, 128, 256, 40), (3, 320, 128, 24), (3, 40, 100, 9))


def main(other: str) -> int:
    if not torch.cuda.is_available():
        print("torch_tile_bitwise: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_tile_eval import _tile_case

    from gpismap_tpu_torch import _native
    from gpismap_tpu_torch.ops import tile_eval as tile_ops

    src = os.path.join(os.path.abspath(other), "tile_eval.cu")
    path, _ = _native.build(src, "libtile_eval_other.so", _native.NVCC,
                            (os.path.join(os.path.dirname(src),
                                          "tile_kstar.cuh"),))
    libs = {"this tree": tile_ops._lib(),
            other: tile_ops.bind(path, bf16=False)}
    for d, m, t, nt in SHAPES:
        _, args, _ = _tile_case(np.random.default_rng(m + d), 6, m, t, nt,
                                d=d)
        args = tuple(a.cuda() for a in args)
        outs = []
        for lib in libs.values():
            tile_ops._LIB = lib
            outs.append(tile_ops._launch(*args, d, 1.2, 1.01, 2.2, False))
        tile_ops._LIB = libs["this tree"]
        torch.cuda.synchronize()
        act = args[0] >= 0
        parts = []
        for name, a, b in zip(("f", "g", "vf", "vg"), *outs):
            diff = float((a[act] - b[act]).abs().max())
            parts.append(f"{name} " + ("bitwise equal"
                                       if torch.equal(a[act], b[act])
                                       else f"differs by {diff:.3g}"))
        print(f"d={d} M={m} T={t} NT={nt}: {other} vs this tree: "
              + ", ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
