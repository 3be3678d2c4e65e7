"""Multi-process bring-up and helpers for sharded runs.

Port of gpismap_tpu/parallel/multihost.py on torch.distributed. The
reference is single-process; scaling follows the multi-controller
recipe, one process per GPU:

  * every process runs the same program and calls initialize() first
    (or is started by torchrun, which initializes the group itself);
  * the mesh spans every process (global_data_mesh); query batches are
    split along the data axis, one contiguous shard per rank;
  * the cluster-GP store and the dense grid are replicated;
  * the host tree replay runs identically in every process (the same
    inputs give the same native-index state), so no process sends its
    tree to another; the mappers' check_replicas() proves it through a
    collective on a digest of the index and the store.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, data_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> None:
    """torch.distributed bring-up over TCP (no-op when single-process).

    coordinator_address: "host:port" of process 0; device: this
    process's compute device; backend: "nccl" (the default, unless
    device is the CPU; it sets the process's card to device, by default
    cuda:process_id modulo the cards) or "gloo" (the default for a CPU
    device, and the backend for several processes on one card). A
    failed initialization raises; nothing falls back to another backend
    or device."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    if backend is None:
        cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if cpu else "nccl"
    if backend == "nccl":
        dev = torch.device(device) if device is not None else torch.device(
            "cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_data_mesh(device=None, backend: Optional[str] = None) -> Mesh:
    """One-axis mesh over every process (call after initialize)."""
    return data_mesh(device=device, backend=backend)


def global_query_array(mesh: Mesh, local_queries) -> torch.Tensor:
    """The global query batch on every rank: each process's rows (the
    same count on each), concatenated in rank order, on mesh.device."""
    return mesh.all_gather(torch.as_tensor(np.asarray(local_queries),
                                           device=mesh.device))


def replicate(mesh: Mesh, tree):
    """Rank 0's values of a tensor, an array, or a (named) tuple of them
    (e.g. the ClusterStore and the grid), on every rank's mesh.device.
    Each rank passes the same shapes and dtypes; the host tree replay
    makes the values equal too, so this only makes sure of it."""
    if isinstance(tree, tuple):
        out = [replicate(mesh, x) for x in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    x = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
        np.asarray(tree))
    return mesh.broadcast(x.to(mesh.device))


def local_rows(mesh: Mesh, global_array) -> np.ndarray:
    """This process's rows of a batch split over the mesh, in order."""
    x = mesh.shard(global_array)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
