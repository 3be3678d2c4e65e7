"""gpismap_tpu_torch — the GPIS mapper ported to PyTorch and CUDA.

A second package beside the JAX reference `gpismap_tpu`, with the same
module layout. It imports torch and never jax, nor anything of
`gpismap_tpu`: the 2D (GPisMap2D) and 3D (GPisMap3D) online loops
(update -> test) run on one torch device, a CUDA card unless the caller
asks for the CPU, with the map query's tile evaluation and the cluster
GPs' Cholesky and L^-1 as hand-written CUDA kernels for NVIDIA Hopper
(ops/tile_eval.py, ops/chol.py, csrc/), which autograd differentiates
through on the card. Rendering (render), checkpoints (runtime.checkpoint)
and the mex command front end (mex_compat) are imported by their module
paths, as in the JAX package.
"""

from .api import GPisMap2D  # noqa: F401
from .api3d import GPisMap3D  # noqa: F401
from .config import (  # noqa: F401
    BIGBIRD_CAMS,
    CAPACITY_2D,
    CAPACITY_3D,
    MAPPER_2D,
    MAPPER_3D,
    OBSGP_1D,
    OBSGP_2D,
    TREE_2D,
    TREE_3D,
    YCB_CAMS,
    CameraParam,
    CapacityParam,
    MapperParam,
    ObsGPParam,
    TreeParam,
)
