"""The map check against the scene itself: how far the map's nodes lie
from the scene's true surface, and which of a frame's true hits no node
covers. Plain numpy and torch; imports nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

from . import scenes


def nearest(points: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Distance [K] from each point to the nearest node (inf: no node)."""
    if len(nodes) == 0:
        return torch.full((len(points),), torch.inf, dtype=points.dtype,
                          device=points.device)
    out = []
    for s in range(0, len(points), 256):
        out.append(torch.cdist(
            points[s:s + 256], nodes,
            compute_mode="donot_use_mm_for_euclid_dist").amin(1))
    return torch.cat(out) if out else points.new_zeros(0)


def map_numbers(scene, nodes_pos: np.ndarray, hits: torch.Tensor,
                cover_radius: float, device) -> dict:
    """off_surface_m: the largest distance of a node from the true
    surface (0 for an empty map); uncovered_share: the share of the true
    hits with no node within cover_radius."""
    pos = torch.as_tensor(np.asarray(nodes_pos, np.float64), device=device)
    if scene.dim == 2:
        off = scenes.surface_distance_2d(scene.walls, nodes_pos) \
            if len(nodes_pos) else np.zeros(0)
        off = torch.as_tensor(off)
    else:
        off = scenes.surface_distance_3d(pos) if len(pos) else \
            pos.new_zeros(0)
    dist = nearest(hits.to(device=device, dtype=torch.float64), pos)
    return dict(off_surface_m=float(off.max()) if len(off) else 0.0,
                uncovered_share=float((dist > cover_radius).double().mean())
                if len(dist) else 0.0)
