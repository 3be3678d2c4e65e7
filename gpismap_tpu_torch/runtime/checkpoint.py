"""Checkpoint / resume for the port's online mappers.

Port of gpismap_tpu/runtime/checkpoint.py, in its format 1: an .npz with
`format`, `dim`, `frame`, `index_blob` (the native index's serialize()
blob) and `store_<field>` (each cluster-store field as a numpy array;
`valid` and `trained` bool). A file saved by either package loads into
the other.
"""
from __future__ import annotations

import numpy as np

from .. import convert

_FORMAT = 1


def save(mapper, path: str) -> None:
    """Save a GPisMap2D/GPisMap3D to an .npz file (exact state)."""
    store = {f"store_{k}": v.detach().cpu().numpy()
             for k, v in mapper.store._asdict().items()}
    np.savez_compressed(
        path, format=_FORMAT, dim=mapper.dim, frame=mapper.frame,
        index_blob=mapper.index.serialize(), **store)


def load(mapper, path: str) -> None:
    """Restore state saved by `save` (either package's) into a
    compatibly configured mapper (same dim, tree parameters and
    capacities); convert.state_from_numpy checks the capacities and drops
    the node mirror, the factor cache and the candidate table."""
    with np.load(path) as d:
        if int(d["format"]) != _FORMAT:
            raise ValueError(
                f"unsupported checkpoint format {int(d['format'])}")
        if int(d["dim"]) != mapper.dim:
            raise ValueError("checkpoint dimensionality mismatch")
        convert.state_from_numpy(d["index_blob"], d, int(d["frame"]), mapper)
