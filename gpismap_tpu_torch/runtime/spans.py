"""Stage spans and work counters of the mappers, live only while a
torch.profiler records.

span(name) marks one host stage of update() or test() as
torch.profiler.record_function("gpismap." + name), so the stage lands in
the profiler's trace on the clock of the device's kernels and copies. A
span does not synchronize the device: the device's part of a stage shows
in the device trace. Spans are flat: no span encloses another, and none
encloses a whole update() or test().

factorizations(kind, m, d) adds the Cholesky or L^-1 work of a batch of
cells to in-memory tallies, kept as tensors on the cells' device so that
counting reads nothing back; counts() returns them as numbers (after the
profile) and reset() clears them. Nothing is written to disk.

With no profiler recording, on() is false: span() returns a shared
no-op context and the counters do nothing, at the cost of one
torch.autograd._profiler_enabled() call each.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

PREFIX = "gpismap."
_counts: dict = {}


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def on() -> bool:
    """Whether a torch.profiler records on this thread."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context that marks the stage `name` while a profiler records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(PREFIX + name)


def factorizations(kind: str, m, d: int) -> None:
    """Count cells handed to `kind` ("chol" or "linv") while a profiler
    records: m (array or tensor) holds each cell's true support count, 0
    for a padding row, and its system has n = (1 + d) m rows before the
    gradient mask. Adds the sum of n^2 and the sum of n^3 to
    <kind>.rows2 and <kind>.rows3."""
    if not torch.autograd._profiler_enabled():
        return
    n = (1 + d) * torch.as_tensor(m).reshape(-1).long()
    for key, v in ((".rows2", n * n), (".rows3", n * n * n)):
        _counts[kind + key] = _counts.get(kind + key, 0) + v.sum()


def counts() -> dict:
    """Every counter, as a number."""
    return {k: int(v) for k, v in _counts.items()}


def reset() -> None:
    """Clear every counter."""
    _counts.clear()
