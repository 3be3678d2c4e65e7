"""The tile evaluation's work is counted from (query, cell) pairs: it
equals a brute-force count over the pairs of a tiny map, and the tile
size the program plans with does not enter it."""
import json
import math
import os

import numpy as np
import pytest

from conftest import DATA
from harness import cell, reference, work


def _map(test_tile):
    with open(os.path.join(DATA, "room2d.json")) as f:
        cfg = json.load(f)
    cfg["mapper"]["capacity_overrides"] = {"test_tile": test_tile}
    sc = cell.Scene(cfg, "cpu")
    m = cell.make_mapper(cfg, "cpu")
    for args in sc.episode(3, 0):
        m.update(*args)
    return cfg, sc, m


def _brute(cfg, nodes, q):
    """Flops of q's pairs, by loops over queries, cells and nodes."""
    g = cfg["gp"]
    d = cfg["dim"]
    cs = g["cell_size"]
    pos = nodes["pos"].astype(np.float64)
    keys = sorted({tuple(np.floor(p / cs).astype(int)) for p in pos})
    centers = [(np.asarray(k) + 0.5) * cs for k in keys]
    reach = g["search_half"] + cs / 2
    r2 = (g["radius_times"] * cs / 2) ** 2

    def rows(c):
        n = ng = 0
        for p, gr, gs in zip(pos, nodes["grad"], nodes["grad_sig"]):
            if np.sum((p - c) ** 2) < r2:
                n += 1
                ng += int(not (gs > 0.1001 or np.all(np.abs(gr) < 1e-6)))
        return n + d * ng

    size = [rows(c) for c in centers]
    total = 0.0
    for x in q.astype(np.float64):
        cand = sorted((float(np.sum((c - x) ** 2)), i)
                      for i, c in enumerate(centers)
                      if np.max(np.abs(c - x)) <= reach)
        for _, i in cand[:3]:
            n = size[i]
            total += 2 * (1 + d) * (n * (n + 1) / 2 + n)
    return total


def test_tile_work_equals_brute_force_pair_count():
    cfg, sc, m = _map(256)
    nodes = cell.snapshot(m)
    spec = cell.gp_spec(cfg)
    cells = reference.Cells(spec, nodes["pos"], nodes["grad"], nodes["val"],
                            nodes["pos_sig"], nodes["grad_sig"], "cpu")
    q = (sc.grid[::7] + np.float32(0.0137)).astype(np.float32)
    flops, nbytes, pairs = work.tile_work(cells, q)
    assert pairs > len(q)
    assert flops == pytest.approx(_brute(cfg, nodes, q), rel=1e-12)
    assert nbytes > 4 * len(q) * (2 + 2 * cfg["dim"])


@pytest.mark.parametrize("tile", [32, 64])
def test_tile_work_does_not_move_with_the_tile_size(tile):
    q = None
    counts = []
    for t in (256, tile):
        cfg, sc, m = _map(t)
        assert m.cap.test_tile == t
        nodes = cell.snapshot(m)
        q = (sc.grid[::5] + np.float32(0.031)).astype(np.float32)
        m.test(q)
        cells = reference.Cells(cell.gp_spec(cfg), nodes["pos"],
                                nodes["grad"], nodes["val"],
                                nodes["pos_sig"], nodes["grad_sig"], "cpu")
        counts.append(work.tile_work(cells, q))
    assert counts[0] == counts[1]
    assert math.isfinite(counts[0][0]) and counts[0][0] > 0
