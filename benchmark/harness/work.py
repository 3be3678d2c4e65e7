"""The work of a map query, counted from (query, cell) pairs.

The tile evaluation's work does not depend on how a program tiles it:
each query evaluates its nearest three candidate cells (fewer where it
has fewer), and each (query, cell) pair costs, for a cell whose GP has n
unmasked rows (its support nodes' value rows plus D gradient rows for
each node that gives them), the product of the n x n triangular L^-1
with the pair's K* column, n (n + 1) / 2 multiply-adds, and the mean's
n more, for each of the 1 + D outputs (f and its gradient; their
variances come from the same product). Padding rows, padded support
slots and empty tile slots are not work. Bytes are each input read once
(the L^-1 triangle, alpha and the support positions of every cell the
call touches, and the queries) and each output written once (2 + 2D
values per query).
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference


def tile_work(cells: reference.Cells, q: np.ndarray):
    """(flops, bytes, pairs) of one query call over the points q."""
    d = cells.spec.dim
    if len(cells.keys) == 0 or len(q) == 0:
        return 0.0, 0.0, 0
    qt = torch.as_tensor(np.asarray(q), device=cells.device,
                         dtype=reference.F64)
    idx, _, _, _, n_max = reference.candidates(cells, qt)
    k = torch.clamp(n_max, max=3)
    top = idx[:, :3]
    used = (torch.arange(3, device=idx.device)[None, :] < k[:, None]) & (
        top >= 0)
    cell_ids = top[used].cpu().numpy()
    per_cell = np.bincount(cell_ids, minlength=len(cells.keys))
    n = np.zeros(len(cells.keys))
    m = np.zeros(len(cells.keys))
    for c in np.nonzero(per_cell)[0]:
        mv, ng = cells.rows(int(c))
        m[c] = mv
        n[c] = mv + d * ng
    macs = (1 + d) * (n * (n + 1) / 2 + n)
    flops = float(2.0 * np.sum(per_cell * macs))
    touched = per_cell > 0
    inputs = np.sum((n * (n + 1) / 2 + n + m * d)[touched]) + len(q) * d
    outputs = len(q) * (2 + 2 * d)
    return flops, float(4.0 * (inputs + outputs)), int(per_cell.sum())
