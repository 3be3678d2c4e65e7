"""Carry a map from the JAX package into the port.

The state is the one gpismap_tpu/runtime/checkpoint.py saves: the native
index's serialize() blob and the cluster store's fields as numpy arrays
(`store_<field>`). Both packages then answer test() on the same map.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import cluster


def state_from_numpy(index_blob: np.ndarray, store_arrays, frame: int,
                     mapper):
    """Load a saved 2D map into `mapper` (a gpismap_tpu_torch.GPisMap2D
    with the same tree parameters and capacities). store_arrays maps
    `store_<field>` to the ClusterStore field's numpy array (an np.load
    of a checkpoint .npz works as is). Returns the mapper."""
    fields = {}
    for name in cluster.ClusterStore._fields:
        ref = getattr(mapper.store, name)
        arr = np.asarray(store_arrays[f"store_{name}"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"store field {name}: capacity mismatch "
                             f"{tuple(ref.shape)} vs {arr.shape}")
        fields[name] = torch.tensor(arr, dtype=ref.dtype,
                                    device=mapper.device)
    mapper.index.deserialize(index_blob)
    mapper.store = cluster.ClusterStore(**fields)
    mapper.frame = int(frame)
    # the next update seeds the node mirror from the loaded index
    mapper._mirror = None
    mapper._factors = None
    mapper._factors_slots = None
    mapper._rebuild_grid()
    return mapper
