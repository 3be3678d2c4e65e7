"""Multi-GPU execution of the GPIS pipeline on torch.distributed.

Port of gpismap_tpu/parallel/mesh.py. The reference's only parallelism
is a std::thread fan-out over query chunks and cluster cells
(GPisMap.cpp:596-663, 765-810); the JAX package runs the same loops SPMD
over a one-axis jax.sharding.Mesh. Here the mesh is a process group with
one process per GPU (multi-controller, PyTorch's usual form), and each
rank keeps a full replica of the map:

  * test(): every rank evaluates a contiguous shard of the query batch
    against its replicated store, grid and factor cache; the shards are
    all-gathered;
  * update(): batches whose rows are independent (the 2D beams and
    re-evaluated nodes, the 3D nodes of the strict and snapshot modes,
    the retrain's cells) are split the same way and all-gathered, so
    every rank replays the same host index from the same results.

A Mesh holds the process group, the rank, the size, the device the rank
computes on and the device its collectives run on (comm_device). NCCL
collectives run on the compute device; gloo has no all_gather of CUDA
tensors, so a gloo mesh over CUDA compute stages its collectives through
host memory (comm_device "cpu"). That is how several ranks share one
card, which NCCL refuses. Nothing falls back: a failed collective
raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


class Mesh:
    """One axis of ranks: process group, rank, size, compute device and
    collective device. A mesh without a process group (group None) is a
    size-1 mesh in one process and runs no collective; a mesh of a group
    runs every collective, a one-rank group's too."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 comm_device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.comm_device = torch.device(comm_device)

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, comm_device={self.comm_device})")

    def local_rows(self, n: int) -> slice:
        """This rank's contiguous rows of a batch of n (n divisible by
        the size)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x):
        """This rank's rows of x (axis 0; a tensor or an array)."""
        return x[self.local_rows(x.shape[0])]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (the same shape on each) concatenated along axis
        0 in rank order, on x's device."""
        if self.group is None:
            return x
        src = _wire(x).to(self.comm_device)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return _unwire(torch.cat(parts), x)

    def gather_rows(self, nt):
        """all_gather of every tensor of a NamedTuple of row batches, in
        ONE collective: the fields are viewed as bytes and packed side by
        side per row, so the gathered values are bit for bit the ranks'."""
        if self.group is None:
            return nt
        n = nt[0].shape[0]
        flat = [x.contiguous().reshape(n, -1) for x in nt]
        raw = [_wire(x).view(torch.uint8) for x in flat]
        packed = self.all_gather(torch.cat(raw, 1))
        out, col = [], 0
        for x, r in zip(nt, raw):
            b = packed[:, col:col + r.shape[1]].contiguous()
            col += r.shape[1]
            b = b.to(torch.bool) if x.dtype == torch.bool else b.view(x.dtype)
            out.append(b.reshape((-1,) + tuple(x.shape[1:])))
        return type(nt)(*out)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks, on x's device."""
        if self.group is None:
            return x
        buf = x.contiguous().to(self.comm_device).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(x.device)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank src's x on every rank (the same shape and dtype on each)."""
        if self.group is None:
            return x
        buf = _wire(x).to(self.comm_device).clone()
        dist.broadcast(buf, src=src, group=self.group)
        return _unwire(buf, x)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous tensor every backend can send (bool as uint8)."""
    x = x.contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _unwire(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received _wire buffer back in like's dtype, on like's device."""
    return buf.to(device=like.device, dtype=like.dtype)


def _default_device(rank: int) -> torch.device:
    """cuda:LOCAL_RANK (torchrun's variable), else cuda:rank modulo the
    cards. There is no CPU default: a mapper on it raises without a
    card, and the CPU is only ever asked for (device="cpu")."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def data_mesh(group=None, device=None, backend: Optional[str] = None) -> Mesh:
    """The mesh of a process group (default: the world group).

    With no process group initialized this is a size-1 mesh in the
    calling process. device: the rank's compute device (default
    cuda:LOCAL_RANK; "cpu" only when given). backend: the group's
    backend, checked against it, or a backend for a new group over all
    ranks of the world (e.g. "gloo" beside an NCCL world). An NCCL mesh
    collects on its CUDA device; a gloo mesh collects on the CPU."""
    if not dist.is_available() or not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given but torch.distributed"
                             " is not initialized")
        dev = torch.device(device) if device is not None else \
            _default_device(0)
        return Mesh(None, 0, 1, dev, dev)
    if backend is not None and group is None \
            and dist.get_backend() != backend:
        group = dist.new_group(backend=backend)
    have = dist.get_backend(group)
    if backend is not None and have != backend:
        raise ValueError(f"the process group's backend is {have}, "
                         f"not {backend}")
    if group is None:
        group = dist.group.WORLD
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    dev = torch.device(device) if device is not None else \
        _default_device(dist.get_rank())
    if have == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"an NCCL mesh computes on a CUDA device, "
                             f"not {dev}")
        torch.cuda.set_device(dev)
        comm = dev
    else:
        comm = torch.device("cpu")
    return Mesh(group, rank, size, dev, comm)


def sharded_map_test(store, grid: torch.Tensor, q: torch.Tensor, mesh: Mesh,
                     **kw):
    """The JAX package's name for cluster.map_test_sharded, which holds
    the one implementation: the queries split over the mesh, the store
    and grid replicated."""
    from ..models import cluster

    return cluster.map_test_sharded(store, grid, q, mesh, **kw)

