"""User-facing 3D online GPIS mapper on PyTorch.

Port of gpismap_tpu/api3d.py:GPisMap3D with its "hybrid", "fused",
"strict" and "snapshot" re-evaluation modes. The command surface is the
reference's (update/test/reset/setCamera/getAllPoints; GPisMap3.h:124-133,
mexGPisMap3.cpp:111-157); the host orchestration it shares with
GPisMap2D lives in api._MapperBase.

On a CUDA device the frame's observation GP is fitted over its nonempty
cells only and the probe sweep runs over its range-gated pixels only
(GPISMAP_OBS_COMPACT), as the JAX package does on its accelerator. With
compaction off, GPISMAP_OBS_BLOCKED=1 selects the cell-blocked sweep,
which the JAX package takes by default on its accelerator; unset, the
dense gather runs, 2.3x faster on the H100 (PERF.md). Each gives the
results of the dense CPU path. Both settings are read here, at each
update, and passed down to mapper3d.frame_compute_3d. test() is
api._MapperBase's: GPISMAP_NBR_TABLE and GPISMAP_PALLAS_BF16 (the tile
kernel's bf16 variance variant, on a CUDA mapper only) are read there.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .api import _MapperBase, _next_pow2, _pad_ids, _to_numpy
from .config import (BIGBIRD_CAMS, CAPACITY_3D, MAPPER_3D, OBSGP_2D,
                     TREE_3D, YCB_CAMS, CameraParam, CapacityParam,
                     MapperParam, ObsGPParam, TreeParam)
from .models import mapper3d, obsgp

# queries per chunk of the observation-GP posterior gather on the card:
# each gathers its cell's [64, 64] L^-1 (16 KiB), so a chunk moves 1 GiB
# (the dense sweep evaluates 7 x 76,800 posteriors per 640x480 frame)
_CUDA_OBS_CHUNK = 1 << 16


class GPisMap3D(_MapperBase):
    """Online continuous 3D SDF mapper from depth images.

    update(depth, pose12) ingests one [H, W] depth image (meters) with pose
    [t(3), R column-major(9)] (mexGPisMap3.cpp convention); test(x)
    returns [N, 8] = [f, gx, gy, gz, var_f, var_gx, var_gy, var_gz]
    (mexGPisMap3.cpp:96-99). All GP state and math live on `device`, a
    CUDA card unless the caller asks for the CPU; the spatial index lives
    on the host.

    Re-evaluation modes (reeval_mode; None picks "hybrid" when
    strict_reeval, else "snapshot"):
      * "hybrid": the reference's strict per-cell order as one vectorized
        pass plus mover fix-up rounds (mapper3d.reeval_hybrid_3d);
      * "fused": the same order as one scan over the kept cells, each
        step re-evaluating the nodes its cell holds at that point
        (mapper3d.reeval_scan_3d; observably equal to "hybrid" at a
        sequential depth of one step per cell);
      * "strict": the host replay of that order, one reeval_3d per kept
        cell, each cell's nodes gathered after the earlier cells'
        mutations;
      * "snapshot": one reeval_3d over a start-of-frame snapshot of every
        kept cell's nodes.
    "hybrid" and "fused" apply their final per-node actions on the host
    index once, at the end of the frame.

    mesh (parallel.mesh.Mesh) runs the loop on every rank of the mesh
    (see api._MapperBase): the "strict" and "snapshot" re-evaluations
    split their nodes over the ranks and all-gather them; the frame's
    observation GP and probe sweep, and the "hybrid" and "fused"
    re-evaluations, whose later steps depend on every node, run
    replicated.
    device defaults to the card, or to the mesh's device.
    """

    def __init__(self, params: MapperParam = MAPPER_3D,
                 obs_param: ObsGPParam = OBSGP_2D,
                 tree: TreeParam = TREE_3D,
                 cap: CapacityParam = CAPACITY_3D,
                 camera: Optional[CameraParam] = None,
                 compat_reloc: bool = True,
                 strict_reeval: bool = True,
                 reeval_mode: Optional[str] = None,
                 device: torch.device | str | None = None,
                 mesh=None):
        if reeval_mode is None:
            reeval_mode = "hybrid" if strict_reeval else "snapshot"
        if reeval_mode not in ("strict", "fused", "hybrid", "snapshot"):
            raise ValueError(f"unknown reeval_mode {reeval_mode!r}")
        self.reeval_mode = reeval_mode
        self.strict_reeval = reeval_mode != "snapshot"
        self.cam = camera or CameraParam()
        self.compat_reloc = compat_reloc
        # test search box: C_leng * 3 (GPisMap3.cpp:811)
        self._setup(params, obs_param, tree, cap, 3, device,
                    search_half=tree.cluster_halfleng * 3.0, mesh=mesh)
        self._obs_chunk = (_CUDA_OBS_CHUNK if self.device.type == "cuda"
                           else 4096)

    # ------------------------------------------------------------------
    def set_camera(self, cam_id_or_param, family: str = "bigbird"):
        """Select intrinsics (mexGPisMap3.cpp:111-144): either a 1-based
        camera id into the bigbird/YCB tables, or a CameraParam."""
        if isinstance(cam_id_or_param, CameraParam):
            self.cam = cam_id_or_param
        else:
            table = BIGBIRD_CAMS if family == "bigbird" else YCB_CAMS
            self.cam = table[int(cam_id_or_param) - 1]

    def _obs_limits(self):
        """Image-plane visibility bounds (GPisMap3.cpp:169-172)."""
        skip = self.p.obs_skip
        m = self.cam.height // skip
        n = self.cam.width // skip
        u_lim = (-self.cam.cx / self.cam.fx,
                 ((n - 1) * skip - self.cam.cx) / self.cam.fx)
        v_lim = (-self.cam.cy / self.cam.fy,
                 ((m - 1) * skip - self.cam.cy) / self.cam.fy)
        return u_lim, v_lim

    # ------------------------------------------------------------------
    def update(self, depth: np.ndarray, pose: np.ndarray) -> None:
        """Ingest one depth frame (GPisMap3::update, GPisMap3.cpp:218-237).
        Per-frame counters and timings land in self.stats."""
        t0 = time.time()
        depth = np.asarray(depth, np.float32)
        pose = np.asarray(pose, np.float32).reshape(-1)
        tr = pose[:3]
        rot = pose[3:12].reshape(3, 3, order="F")
        nv, rmax = self._host_gate(depth)
        if nv <= 1:
            return
        _, obs, nm = mapper3d.frame_compute_3d(
            self._t(depth), self._t(tr), self._t(rot), self.cam, self.p,
            self.op, chunk=self._obs_chunk, blocked=self._obs_blocked(),
            nv_cap=self._obs_nv_cap(nv),
            obs_c_cap=self._obs_cell_cap(self._last_valid_mask))
        nm = _to_numpy(nm)
        self._update_map_points(obs, rmax, tr, rot)
        self._apply_newmeas(nm)

        t1 = time.time()
        self._retrain_store()
        self.stats.update(
            frame=self.frame, n_nodes=self.index.num_nodes,
            n_cluster_cells=int(self.index.max_slot),
            support_overflow=int(self.index.overflow_count),
            update_s=round(time.time() - t0, 4),
            retrain_s=round(time.time() - t1, 4))
        self.frame += 1

    def update_batch(self, frames) -> None:
        """Ingest several frames, the same as update() on each in turn:
        frames is an iterable of (depth, pose12) or (depth, pose12, cam)
        with cam a CameraParam or a 1-based bigbird camera id."""
        for f in frames:
            if len(f) > 2:
                self.set_camera(f[2])
            self.update(f[0], f[1])

    def _host_gate(self, depth: np.ndarray):
        """Host replica of preprocess_3d's range gate
        (GPisMap3.cpp:176-210): (valid pixel count, max valid depth); the
        mask is kept in self._last_valid_mask for _obs_cell_cap."""
        skip = self.p.obs_skip
        mrow = self.cam.height // skip
        ncol = self.cam.width // skip
        z = depth[::skip, ::skip][:mrow, :ncol].astype(np.float32)
        valid = (z > self.p.min_range) & (z < self.p.max_range)
        rmax = float(np.max(np.where(valid, z, 0.0)))
        self._last_valid_mask = valid
        return int(valid.sum()), rmax

    def _obs_compact(self) -> bool:
        """GPISMAP_OBS_COMPACT, read at each call: 0/off and 1/on force
        the compacted fit and sweep either way; "auto" (unset) means on a
        CUDA device, off on the CPU."""
        v = os.environ.get("GPISMAP_OBS_COMPACT", "auto")
        if v in ("0", "off"):
            return False
        return v in ("1", "on") or self.device.type == "cuda"

    def _obs_blocked(self) -> bool:
        """GPISMAP_OBS_BLOCKED, read at each call: 1/on selects the
        cell-blocked probe sweep where no nv_cap is given (compaction
        wins); unset ("auto"), 0 or off keep the dense gather on every
        device."""
        return os.environ.get("GPISMAP_OBS_BLOCKED", "auto") in ("1", "on")

    def _obs_nv_cap(self, nv: int):
        """The pow2 bucket (at least 1024) of the frame's valid-pixel
        count for the compacted probe sweep (mapper3d.newmeas_3d nv_cap),
        or None for the dense sweeps."""
        if not self._obs_compact():
            return None
        return max(1024, _next_pow2(nv))

    def _obs_cell_cap(self, valid: np.ndarray):
        """The pow2 bucket (at least 256) of the number of nonempty obs
        cells, those whose (overlapping) pixel window holds a range-gated
        pixel: fit_obsgp2d's `trained`, counted on the host from the
        static partition and the valid mask by an integral image. None
        fits every cell."""
        if not self._obs_compact():
            return None
        m, n = valid.shape
        ii = np.zeros((m + 1, n + 1), np.int64)
        ii[1:, 1:] = np.cumsum(np.cumsum(valid, 0), 1)
        gs, ov = self.op.group_size, self.op.overlap
        _, i0s, i1s, _ = obsgp.partition_1axis(m, gs, ov)
        _, j0s, j1s, _ = obsgp.partition_1axis(n, gs, ov)
        i0 = np.asarray(i0s)[:, None]
        i1 = np.asarray(i1s)[:, None] + 1
        j0 = np.asarray(j0s)[None, :]
        j1 = np.asarray(j1s)[None, :] + 1
        cnt = ii[i1, j1] - ii[i0, j1] - ii[i1, j0] + ii[i0, j0]
        return max(256, _next_pow2(max(int((cnt > 0).sum()), 1)))

    def _cull_cells(self, rmax: float, tr, rot) -> np.ndarray:
        """Range + frustum cell culls (GPisMap3.cpp:276-301)."""
        if self.index.num_nodes == 0:
            return np.zeros(0, np.int32)
        cells, _ = self.index.query_cluster_cells(tr, rmax, cap=65536)
        if len(cells) == 0:
            return cells
        centers, halfs, _ = self.index.cell_info(cells)
        sqr = np.sum((centers - tr) ** 2, -1)
        keep = sqr <= rmax * rmax + 2.0 * halfs * halfs
        # frustum cull by corners; the reference overwrites within_angle
        # per z>0 corner so only the LAST front corner decides
        # (GPisMap3.cpp:289-301) — replicated.
        signs = np.array([[-1, 1, 1], [1, 1, 1], [-1, -1, 1], [1, -1, 1],
                          [-1, 1, -1], [1, 1, -1], [-1, -1, -1],
                          [1, -1, -1]], np.float32)
        corners = centers[:, None, :] + halfs[:, None, None] * signs
        loc = (corners - tr) @ rot                     # [C, 8, 3]
        u_lim, v_lim = self._obs_limits()
        z = loc[..., 2]
        front = z > 0
        xv = loc[..., 0] / np.where(front, z, 1.0)
        yv = loc[..., 1] / np.where(front, z, 1.0)
        vis = ((xv > u_lim[0]) & (xv < u_lim[1])
               & (yv > v_lim[0]) & (yv < v_lim[1]))
        within = np.zeros(len(cells), bool)
        for c in range(8):                             # replay overwrite
            within = np.where(front[:, c], vis[:, c], within)
        keep &= within
        return cells[keep]

    def _update_map_points(self, obs, rmax: float, tr, rot) -> None:
        """Re-evaluate the nodes of the kept cells in the mapper's mode
        and apply the outcome on the host index."""
        kept = self._cull_cells(rmax, tr, rot)
        if len(kept) == 0:
            return
        if self.reeval_mode == "strict":
            for c in kept:
                self._reeval_apply(obs, self.index.cell_nodes(c), tr, rot)
        elif self.reeval_mode in ("fused", "hybrid"):
            disp = self._dispatch_reeval_fused(obs, kept, tr, rot)
            if disp is not None:
                self._apply_reeval_fused(*disp)
        else:
            self._reeval_apply(
                obs, np.concatenate([self.index.cell_nodes(c)
                                     for c in kept]), tr, rot)

    def _reeval_apply(self, obs, node_ids, tr, rot) -> None:
        """reeval_3d of one node batch, applied on the host index; with a
        mesh, of this rank's rows, all-gathered."""
        if len(node_ids) == 0:
            return
        sel, valid = _pad_ids(node_ids)
        d = self.index.get_nodes(sel)
        rv = mapper3d.reeval_3d(
            obs, *(self._shard(self._t(d[k])) for k in
                   ("pos", "grad", "pos_sig", "grad_sig")),
            self._shard(self._t(valid)), self._t(tr), self._t(rot), self.p,
            self.op, chunk=self._obs_chunk, compat=self.compat_reloc)
        self._apply_reeval(node_ids, _to_numpy(self._gather(rv)))

    def _dispatch_reeval_fused(self, obs, kept, tr, rot):
        """Gather the kept cells' nodes and run reeval_hybrid_3d
        ("hybrid") or reeval_scan_3d ("fused") on them. Returns
        (node_ids, Reeval3D on the host, n_dropped), or None when the
        cells hold no nodes."""
        lists = [self.index.cell_nodes(c) for c in kept]
        node_ids = np.concatenate(lists)
        if len(node_ids) == 0:
            return None
        sel, valid = _pad_ids(node_ids)
        d = self.index.get_nodes(sel)
        centers, _, _ = self.index.cell_info(kept)
        # "hybrid" pads the cells to a power of two; the scan of "fused"
        # steps through the kept cells only (a padded one changes nothing)
        cpad = (_next_pow2(len(kept), lo=8) if self.reeval_mode == "hybrid"
                else len(kept))
        cc = np.zeros((cpad, 3), np.int32)
        cc[:len(kept)] = np.floor(centers / self.cell_size).astype(np.int32)
        cok = np.zeros(cpad, bool)
        cok[:len(kept)] = True
        args = (obs, self._t(d["pos"]), self._t(d["grad"]),
                self._t(d["pos_sig"]), self._t(d["grad_sig"]),
                self._t(valid), self._t(cc), self._t(cok), self._t(tr),
                self._t(rot), np.float32(self.cell_size), self.p, self.op)
        kw = dict(chunk=self._obs_chunk, compat=self.compat_reloc)
        if self.reeval_mode == "hybrid":
            rv, drop = mapper3d.reeval_hybrid_3d(*args, **kw)
        else:
            # members a scan step takes: twice the largest cell at the
            # start of the frame (for nodes relocated into it), at least
            # 512 and at most every node (gpismap_tpu/api3d.py:371-381);
            # the rest are counted in n_dropped
            kc = min(max(_next_pow2(2 * max(len(li) for li in lists)), 512),
                     _next_pow2(len(node_ids)))
            rv, drop = mapper3d.reeval_scan_3d(*args, kc=kc, **kw)
        return node_ids, _to_numpy(rv), drop

    def _apply_reeval_fused(self, node_ids, rv, drop) -> None:
        """Host apply of the re-evaluation's final per-node actions."""
        if drop:
            self.stats["reeval_dropped"] = (
                self.stats.get("reeval_dropped", 0) + int(drop))
        self._apply_reeval(node_ids, rv)

    # ------------------------------------------------------------------
    def _test_kwargs(self) -> dict:
        """The 3D query constants (testSinglePoint, OnGPIS.cpp:208-213;
        var threshold 0.5, GPisMap3.cpp:800)."""
        return dict(
            cell_size=self.cell_size, grid_half=self.grid_half,
            noff=self._noff, search_half=self._search_half,
            scale=self.p.map_scale_param, val_const=1.001,
            grad_const=self.p.three_over_scale + 0.001,
            var_thre=self.p.test_var_thre,
            default_var=1.0 + self.p.map_noise_param,
            tile=self.cap.test_tile, max_cells=self.cap.max_cells,
            max_active=self.cap.test_active_cells)
