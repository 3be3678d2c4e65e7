"""Builds the port's native libraries from the sources in the checkout.

Each library is compiled on first use into ``gpismap_tpu_torch/build/``
(listed in .gitignore, never committed) and rebuilt when its source is
newer. The compiler writes a per-process temporary file that is renamed
into place, so concurrent test workers never load a half-written library.
Different libraries may build at the same time (one lock per library).
"""
from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, List, Sequence, Tuple

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "build")
# argv of nvcc for the CUDA kernels (plain C interface, loaded by ctypes);
# -Xptxas -v reports registers, shared memory and spills
NVCC = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def build(src: str, name: str, compiler: List[str],
          deps: Sequence[str] = ()) -> Tuple[str, str]:
    """Compile `src` into BUILD_DIR/name with `compiler` (argv without the
    output and source); `deps` are the headers it includes, which make
    the library stale too. Returns (library path, compiler output; ""
    when the library was already up to date)."""
    out = os.path.join(BUILD_DIR, name)
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if (os.path.exists(out) and all(
                os.path.getmtime(out) >= os.path.getmtime(f)
                for f in (src, *deps))):
            return out, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(compiler + ["-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(compiler)}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr
